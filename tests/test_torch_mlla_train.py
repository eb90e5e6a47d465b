"""Training the MLLA graft family in the port against the JAX package: the recipe's
global-norm clip against optax.clip_by_global_norm (above and below the threshold,
and inside the optimizer under grad_accum 2); one train step of
tests/test_mlla_train.py:_setup's tiny model (norm clip 5.0, MESA off and on) against
JAX's make_train_step: the loss, the grad norm, every gradient, the parameters, the
BN statistics and the EMA; the ``--config`` reader against yaml.safe_load on every
file of configs/ and the parsed presets against the JAX parser's; the trainer's and
validate.py's MLLA paths (counterparts of tests/test_mlla_train.py's CLI tests), the
finetune from the trainer's own checkpoint and ``--no-fused-eval``."""

import functools
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from recnext_tpu.models.mlla import create_mlla as jax_create_mlla
from recnext_tpu.train import losses as JL
from recnext_tpu.train import main as jmain
from recnext_tpu.train import optim as jopt
from recnext_tpu.train import step as jstep
from recnext_tpu.train.state import TrainState as JaxTrainState
from recnext_tpu_torch.convert import jax_mlla_to_torch
from recnext_tpu_torch.models.mlla import create_mlla
from recnext_tpu_torch.train import config as tconfig
from recnext_tpu_torch.train import main as tmain
from recnext_tpu_torch.train import optim as topt
from recnext_tpu_torch.train import step as tstep
from recnext_tpu_torch.train.state import TrainState

CONFIGS = sorted(Path(__file__).resolve().parent.parent.glob("configs/*.yaml"))
LR = 1e-3
EMA_DECAY = 0.5  # large enough that the EMA's move is well above the tolerance
TINY = dict(num_classes=4, embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 1, 1, 1))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------- the norm clip


def _grads(seed, scale):
    rng = np.random.default_rng(seed)
    return {"w": (scale * rng.normal(size=(6, 5))).astype(np.float32),
            "b": (scale * rng.normal(size=(5,))).astype(np.float32),
            "k": (scale * rng.normal(size=(3, 3, 1, 4))).astype(np.float32)}


@pytest.mark.parametrize("scale", [0.1, 10.0])  # global norm ~0.6 and ~60 against 5.0
def test_clip_by_global_norm_matches_optax(scale):
    grads = _grads(0, scale)
    clip = optax.clip_by_global_norm(5.0)
    want, _ = clip.update(jax.tree.map(jnp.asarray, grads), clip.init(None))
    params = []
    for g in grads.values():
        p = torch.zeros(g.shape, requires_grad=True)
        p.grad = torch.from_numpy(g.copy())
        params.append(p)
    topt.clip_by_global_norm_(params, 5.0)
    norm = float(optax.global_norm(grads))
    assert (norm > 5.0) == (scale > 1)
    for p, k in zip(params, grads):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-9,
                                   err_msg=k)
    if scale < 1:  # below the threshold the gradients are the same bits
        assert all(np.array_equal(p.grad.numpy(), g) for p, g in zip(params, grads.values()))


def test_norm_clip_applies_to_the_mean_of_micro_steps_as_optax_multisteps():
    """grad_accum 2: the clip sees the mean of two micro-steps, one update in two;
    the first update's mean is clipped, the second's is not."""
    rng = np.random.default_rng(1)
    init = {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32),
            "k": rng.normal(size=(3, 3, 1, 4)).astype(np.float32)}
    micro = [_grads(2, 20.0), _grads(3, 5.0), _grads(4, 0.1), _grads(5, 0.2)]
    tx = jopt.make_optimizer(LR, weight_decay=0.05, agc_clip=5.0, grad_accum=2,
                             clip_mode="norm")
    jp = jax.tree.map(jnp.asarray, init)
    st = tx.init(jp)
    named = [(k, torch.from_numpy(v.copy()).requires_grad_()) for k, v in init.items()]
    opt = topt.make_optimizer(named, lambda u: LR, weight_decay=0.05, agc_clip=5.0,
                              grad_accum=2, clip_mode="norm")
    for i, g in enumerate(micro):
        upd, st = tx.update(jax.tree.map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in named:
            p.grad = torch.from_numpy(g[k].copy())
        assert opt.step() == (i % 2 == 1)
        for k, p in named:
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"micro-step {i}: {k}")
    assert opt.count == 2
    with pytest.raises(ValueError, match="clip_mode"):
        topt.make_optimizer(named, lambda u: LR, clip_mode="bogus")


# ------------------------------------------------------------ one train step


def _batch():
    rng = np.random.default_rng(0)
    return rng.normal(size=(2, 64, 64, 3)).astype(np.float32), np.asarray([1, 3], np.int32)


@functools.lru_cache(maxsize=None)
def _run_step(mesa):
    """Both packages' step once on _setup's model (norm clip 5.0, mixup off,
    smoothing 0, MESA from step 0 where ``mesa``): states and gradients."""
    model = jax_create_mlla("mlla_nano_recconv", **TINY)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((2, 64, 64, 3)))
    rng = np.random.default_rng(3)  # BN statistics moved off (0, 1)
    variables = {"params": variables["params"], "batch_stats": jax.tree.map(
        lambda v: v + 0.05 * np.abs(rng.normal(size=v.shape)).astype(v.dtype),
        variables["batch_stats"])}
    tx = jopt.make_optimizer(LR, clip_mode="norm", agc_clip=5.0)
    state = JaxTrainState.create(variables, tx, ema=True)
    train_step = jstep.make_train_step(model, tx, num_classes=4, mixup=False, smoothing=0.0,
                                       mesa=mesa, mesa_start_step=0, ema_decay=EMA_DECAY)
    x, y = _batch()
    batch = {"image": jnp.asarray(x), "label": jnp.asarray(y)}
    base = functools.partial(JL.label_smoothing_cross_entropy, smoothing=0.0)

    def loss_fn(params):
        out, _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                             batch["image"], training=True, mutable=["batch_stats"])
        loss = JL.distillation_loss(out, batch["label"], None, base_criterion=base)
        if mesa:
            teacher = jax.nn.softmax(model.apply(variables, batch["image"]), axis=-1)
            loss = loss + mesa * JL.soft_target_cross_entropy(out, teacher)
        return loss

    @jax.jit
    def step_and_grads(st):
        grads = jax.grad(loss_fn)(st.params)
        clip = optax.clip_by_global_norm(5.0)
        clipped, _ = clip.update(grads, clip.init(None))
        return (*train_step(st, batch, jax.random.PRNGKey(1)), grads, clipped)

    new, metrics, grads, clipped = step_and_grads(state)

    tm = create_mlla("mlla_nano_recconv", device="cpu", img_size=64, **TINY)
    tm.load_state_dict(jax_mlla_to_torch(variables, tm), strict=True)
    before = create_mlla("mlla_nano_recconv", device="cpu", img_size=64, **TINY).train()
    before.load_state_dict(tm.state_dict())
    opt = topt.make_optimizer(tm.named_parameters(), lambda u: LR, agc_clip=5.0,
                              clip_mode="norm")
    tstate = TrainState.create(tm, opt)
    tb = {"image": torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
          "label": torch.from_numpy(y).long()}
    step = tstep.make_train_step(num_classes=4, mixup=False, smoothing=0.0,
                                 ema_decay=EMA_DECAY, dtype=torch.float32, mesa=mesa,
                                 mesa_start_step=0)
    tmetrics = step(tstate, tb, torch.Generator().manual_seed(0))
    targets = (tstep.ema_softmax(before, tb["image"], dict(before.state_dict()), torch.float32)
               if mesa else None)
    loss = tstep.train_loss(before, tb["image"], tb["label"], dtype=torch.float32,
                            smoothing=0.0, mesa_targets=targets, mesa=mesa)
    loss.backward()
    return dict(jax_state=new, jax_metrics=metrics, variables=variables,
                ref=lambda p, s: jax_mlla_to_torch({"params": p, "batch_stats": s}),
                jax_grads=grads, jax_clipped=clipped, state=tstate, metrics=tmetrics,
                grads={n: p.grad for n, p in before.named_parameters()})


@pytest.fixture(scope="module", params=[0.0, 1.0], ids=["plain", "mesa"])
def run(request):
    return _run_step(request.param)


def test_step_loss_and_grad_norm_match_jax(run):
    assert float(run["metrics"]["loss"]) == pytest.approx(float(run["jax_metrics"]["loss"]),
                                                          rel=1e-5)
    assert float(run["metrics"]["grad_norm"]) == pytest.approx(
        float(run["jax_metrics"]["grad_norm"]), rel=1e-4)


def test_step_every_gradient_matches_jax(run):
    ref = run["ref"](run["jax_grads"], run["variables"]["batch_stats"])
    assert set(run["grads"]) == {k for k in ref if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))}
    for name, g in run["grads"].items():
        want = ref[name].numpy()
        scale = np.abs(want).max()
        assert scale > 1e-6, name
        assert np.abs(g.numpy() - want).max() <= 1e-4 * scale, name


def test_step_parameters_statistics_and_ema_match_jax(run):
    new = run["jax_state"]
    after = run["ref"](new.params, new.batch_stats)
    clipped = run["ref"](run["jax_clipped"], run["variables"]["batch_stats"])
    raw = run["ref"](run["jax_grads"], run["variables"]["batch_stats"])
    model = run["state"].model
    sd = model.state_dict()
    for k in sd:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), after[k].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=k)
    tols, total, unpinned = {}, 0, 0
    for name, p in model.named_parameters():
        # Adam's first step is lr * c / (|c| + eps) on the clipped gradient c: where c is
        # under 1e-7, or the raw gradient within the gradient check's tolerance of 0,
        # its sign and size turn on the order of the sums (up to 2 lr apart); else 1e-6.
        # Exact zeros (the taps of the coarsest level's conv that see only padding at
        # 1x1) are in that set on both sides, and not counted as unpinned.
        g, c = raw[name].numpy(), np.abs(clipped[name].numpy())
        loose = (c < 1e-7) | (np.abs(g) < 1e-4 * np.abs(g).max())
        tols[name] = np.where(loose, 2 * LR, 1e-6)
        total += g.size
        unpinned += int((loose & (g != 0)).sum())
        err = np.abs(p.detach().numpy() - after[name].numpy())
        assert (err <= tols[name]).all(), (name, err.max())
    assert unpinned < 0.01 * total
    ema = run["ref"](new.ema_params, new.ema_batch_stats)
    for name, e in run["state"].ema.items():
        want = ema[name].numpy()
        tol = np.maximum(1e-6, (1 - EMA_DECAY) * tols[name]) if name in tols else 1e-5
        assert (np.abs(e.numpy() - want) <= tol).all(), name
    assert run["state"].step == 1 and int(new.step) == 1


# ------------------------------------------------------------ --config files


@pytest.mark.parametrize("path", CONFIGS, ids=[p.name for p in CONFIGS])
def test_config_reader_matches_yaml_safe_load(path):
    got, want = tconfig.read_config(path), yaml.safe_load(path.read_text())
    assert got == want and [type(v) for v in got.values()] == [type(v) for v in want.values()]


def test_config_scalars_resolve_as_pyyaml_and_the_rest_raises(tmp_path):
    for text in ["1", "-2", "1_000", "0", "1.0e-3", "1e-3", ".5", "3.", "+1.5", "1.0E+3",
                 "true", "Off", "YES", "no", "~", "null", "", "abc", "'a b'", '"x"',
                 "runs/x-1", ".inf", "-.Inf", "a:b"]:
        want = yaml.safe_load(f"k: {text}")["k"]
        got = tconfig.scalar(text)
        assert got == want and type(got) is type(want), text
    for text in ["0x1f", "017", "1:30", "[1, 2]", "{a: 1}", "&a x", "*a", "!!str x", "|", "- x"]:
        with pytest.raises(ValueError):
            tconfig.scalar(text)
    for body in ["a:\n  b: 1\n", "- 1\n", "a: 1\na: 2\n", "---\na: 1\n", "just text\n"]:
        f = tmp_path / "c.yaml"
        f.write_text(body)
        with pytest.raises(ValueError):
            tconfig.read_config(f)


@pytest.mark.parametrize("size", ["nano", "mini"])
def test_mlla_presets_parse_as_the_jax_parser_does(size, monkeypatch):
    want = vars(jmain.parse_args(["--config", f"configs/mlla_{size}_300e.yaml"]))
    monkeypatch.setitem(sys.modules, "yaml", None)  # the port reads its configs without it
    got = vars(tmain.parse_args(["--config", f"configs/mlla_{size}_300e.yaml"]))
    assert got["model"] == f"mlla_{size}_recattn_simple" and got["clip_mode"] == "norm"
    # every shared key but --workers (the JAX CLI's grain workers, 8; the port's
    # loader processes, 0 by default)
    shared = (set(got) & set(want)) - {"workers"}
    assert len(shared) >= 40
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    over = tmain.parse_args(["--config", f"configs/mlla_{size}_300e.yaml", "--batch-size", "8"])
    assert over.batch_size == 8 and over.clip_grad == 5.0  # the command line overrides


def test_config_keys_the_parser_does_not_know_exit(tmp_path):
    f = tmp_path / "bad.yaml"
    f.write_text("lr: 1.0e-3\nfsdp: 2\n")
    with pytest.raises(SystemExit, match="unknown config keys: \\['fsdp'\\]"):
        tmain.parse_args(["--config", str(f)])


def test_finetune_preset_raises_naming_frozen_bn_item(tmp_path):
    with pytest.raises(NotImplementedError, match="item 11"):
        tmain.main(["--config", "configs/finetune_384.yaml", "--device", "cpu", "--model",
                    "recnext_m0", "--data-set", "FAKE", "--output-dir", str(tmp_path)])


# ------------------------------------------------------------ the CLIs


def _cli(tmp_path, *extra, model="mlla_nano_recattn_simple", classes="8",
         kwargs="embed_dim=8"):
    return ["--device", "cpu", "--model", model, "--model-kwargs", kwargs,
            "--data-set", "FAKE", "--fake-classes", classes, "--epochs", "1",
            "--batch-size", "8", "--input-size", "64", "--steps-per-epoch", "2",
            "--simple-aug", "--dtype", "float32", "--output-dir", str(tmp_path), *extra]


def test_train_main_cli_mlla_smoke_and_finetune(tmp_path, capsys):
    """The MLLA recipe end to end: norm clipping, active MESA (start ratio 0) and the
    unfused eval of the model and its EMA; then a finetune from its checkpoint onto
    another class count (the head dropped)."""
    res = tmain.main(_cli(tmp_path / "a", "--mesa", "1.0", "--mesa-start-ratio", "0.0",
                          "--clip-mode", "norm", "--clip-grad", "5.0"))
    assert "max_acc" in res and res["state"].optimizer.clip_mode == "norm"
    rec = json.loads((tmp_path / "a" / "log.txt").read_text().strip().splitlines()[-1])
    assert np.isfinite(rec["train_loss"])
    assert {"test_acc1", "ema_test_acc1"} <= set(rec)
    ckpt = tmp_path / "a" / "ckpt" / "epoch_0000.pt"
    capsys.readouterr()
    tmain.main(_cli(tmp_path / "b", "--finetune", str(ckpt), classes="5"))
    out = capsys.readouterr().out
    assert "Removing key head.weight" in out and "Removing key head.bias" in out


def test_train_main_cli_mlla_guards(tmp_path):
    base = _cli(tmp_path, model="mlla_nano_recconv", classes="4")
    with pytest.raises(SystemExit, match="distillation head"):
        tmain.main(base + ["--distillation-type", "hard", "--teacher-model", "recnext_m0"])
    with pytest.raises(SystemExit, match="EMA"):
        tmain.main(base + ["--mesa", "1.0", "--no-model-ema"])
    with pytest.raises(SystemExit, match="RecNext-family"):
        tmain.main(base + ["--set-bn-eval"])


def test_validate_cli_mlla(tmp_path):
    from recnext_tpu_torch.validate import main as validate_main

    res = validate_main(["--device", "cpu", "--model", "mlla_nano_recconv", "--data-set",
                         "FAKE", "--model-kwargs", "embed_dim=8", "--input-size", "64",
                         "--batch-size", "8", "--max-batches", "1"])
    assert res["count"] == 8 and not res["fused"]
    for flag in ("--fused", "--packed"):
        with pytest.raises(SystemExit, match="fused"):
            validate_main(["--device", "cpu", "--model", "mlla_nano_recconv", flag,
                           "--data-set", "FAKE", "--input-size", "64"])


def test_no_fused_eval_scores_as_the_fused_eval(tmp_path):
    """An M model's per-epoch eval through the unfused model gives the fused eval's
    numbers on the same weights."""
    recs = []
    for name, extra in (("fused", []), ("unfused", ["--no-fused-eval"])):
        tmain.main(_cli(tmp_path / name, *extra, model="recnext_m0", classes="11",
                        kwargs="embed_dim=16:32:64:128,depth=1:1:2:1"))
        recs.append(json.loads((tmp_path / name / "log.txt").read_text().splitlines()[-1]))
    assert recs[0]["train_loss"] == recs[1]["train_loss"]
    assert recs[1]["test_loss"] == pytest.approx(recs[0]["test_loss"], rel=1e-4)
    assert recs[1]["test_acc5"] == recs[0]["test_acc5"]

"""One train step of the port against the JAX package's ``make_train_step``, from
the same weights (a JAX init carried across with jax_to_torch) and the same batch,
in f32 with mixup off and drop-path 0: the loss, every gradient, the BN running
statistics, the updated parameters and the EMA; for a small M model, for a small A
model plain and with hard and soft distillation from a tiny RegNetY teacher on both
sides (its JAX weights carried across with jax_regnet_to_torch), and for a small L
model plain and hard-distilled. Then the eval metrics, the unfused eval step and the
fused eval step against JAX's (M and L), and the L model's weight-decay labels."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recnext_tpu.models import regnet as jregnet
from recnext_tpu.models.registry import create_model as jax_create_model
from recnext_tpu.models.registry import get_config as jax_get_config
from recnext_tpu.train import losses as JL
from recnext_tpu.train import optim as jopt
from recnext_tpu.train import step as jstep
from recnext_tpu.train.state import TrainState as JaxTrainState
from recnext_tpu_torch.convert import jax_regnet_to_torch, jax_to_torch
from recnext_tpu_torch.models import regnet as tregnet
from recnext_tpu_torch.models.registry import create_model, get_config
from recnext_tpu_torch.train import optim as topt
from recnext_tpu_torch.train import step as tstep
from recnext_tpu_torch.train.state import TrainState

OVR = dict(embed_dim=(16, 32, 64, 128), depth=(1, 1, 2, 1), num_classes=11)
NAME = "recnext_m0"
LR = 1e-3  # the schedule with warm-up 0 runs the first update at the base lr
EMA_DECAY = 0.5  # large enough that the EMA's move is well above the tolerance


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's side on one thread: the suite runs several test processes at
    once, and torch's default of a thread per core would oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _sched(mod):
    return mod.cosine_schedule(LR, 1, 10, 0)


def _batch(seed=0, n=4, side=32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, side, side, 3)).astype(np.float32)
    y = rng.integers(0, 11, size=n).astype(np.int32)
    return x, y


# a tiny RegNetY teacher (tests/test_regnet.py:116's config) for the distillation steps
TEACHER = dict(name="tiny", w0=24, wa=24.0, wm=2.0, depth=4, group_width=8, stem_width=16,
               num_classes=11)


def _teacher():
    """The teacher on both sides: (JAX apply, the port's module), on the same weights
    with BN statistics moved off (0, 1)."""
    model = jregnet.RegNetY(cfg=jregnet.RegNetConfig(**TEACHER))
    variables = jax.jit(model.init)(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(5)
    variables = {"params": variables["params"], "batch_stats": jax.tree.map(
        lambda v: v + 0.3 * np.abs(rng.normal(size=v.shape)).astype(v.dtype),
        variables["batch_stats"])}
    port = tregnet.RegNetY(tregnet.RegNetConfig(**TEACHER))
    port.load_state_dict(jax_regnet_to_torch(variables, port), strict=True)
    return (lambda xb: model.apply(variables, xb, training=False)), port


def _run_step(name, distillation="none", alpha=0.5, tau=1.0, side=32):
    """Both packages' train step, once, on a batch of ``side``^2 images: the states
    before and after, the gradients."""
    distill = distillation != "none"
    model = jax_create_model(name, distillation=distill, **OVR)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    # the init's weights; BN running statistics moved off (0, 1), so that the
    # momentum update is exercised
    variables = {"params": variables["params"], "batch_stats": jax.tree.map(
        lambda v: v + 0.05 * np.random.default_rng(3).normal(size=v.shape).astype(v.dtype),
        variables["batch_stats"])}
    x, y = _batch(side=side)
    tx = jopt.make_optimizer(_sched(jopt), weight_decay=0.025, agc_clip=0.02)
    state = JaxTrainState.create(variables, tx)
    jax_teacher, port_teacher = _teacher() if distill else (None, None)
    train_step = jstep.make_train_step(model, tx, num_classes=11, mixup=False,
                                       smoothing=0.1, ema_decay=EMA_DECAY,
                                       teacher_apply=jax_teacher, distillation=distillation,
                                       alpha=alpha, tau=tau)
    batch = {"image": jnp.asarray(x), "label": jnp.asarray(y)}
    base = functools.partial(JL.label_smoothing_cross_entropy, smoothing=0.1)

    def loss_fn(params):
        out, _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                             batch["image"], training=True, mutable=["batch_stats"])
        teacher_logits = jax_teacher(batch["image"]) if distill else None
        return JL.distillation_loss(out, batch["label"], teacher_logits, base_criterion=base,
                                    kind=distillation, alpha=alpha, tau=tau)

    @jax.jit
    def step_and_grads(st):
        # the step, its raw gradient and that gradient after AGC, in one compile
        grads = jax.grad(loss_fn)(st.params)
        agc = optax.adaptive_grad_clip(0.02)
        clipped, _ = agc.update(grads, agc.init(None), st.params)
        return (*train_step(st, batch, jax.random.PRNGKey(1)), grads, clipped)

    new, metrics, grads, clipped = step_and_grads(state)

    tm = create_model(name, device="cpu", distillation=distill, **OVR)
    tm.load_state_dict(jax_to_torch(variables, tm), strict=True)
    before = copy.deepcopy(tm).train()
    opt = topt.make_optimizer(tm.named_parameters(), _sched(topt), weight_decay=0.025,
                              agc_clip=0.02)
    tstate = TrainState.create(tm, opt)
    tb = {"image": torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
          "label": torch.from_numpy(y).long()}
    teacher_apply = (tstep.make_teacher_apply(port_teacher, torch.float32) if distill
                     else None)
    train_step = tstep.make_train_step(num_classes=11, mixup=False, smoothing=0.1,
                                       ema_decay=EMA_DECAY, dtype=torch.float32,
                                       teacher_apply=teacher_apply, distillation=distillation,
                                       alpha=alpha, tau=tau)
    tmetrics = train_step(tstate, tb, torch.Generator().manual_seed(0))
    # the port's gradient: the same loss the step backpropagates, on the weights before
    loss = tstep.train_loss(before, tb["image"], tb["label"], dtype=torch.float32,
                            smoothing=0.1, distillation=distillation, alpha=alpha, tau=tau,
                            teacher_logits=teacher_apply(tb["image"]) if distill else None)
    loss.backward()
    tgrads = {n: p.grad for n, p in before.named_parameters()}
    return dict(jax_state=new, jax_metrics=metrics, jax_grads=grads, jax_clipped=clipped,
                variables=variables,
                state=tstate, metrics=tmetrics, grads=tgrads, model=tm, batch=tb,
                jax_batch=batch, jax_model=model)


@pytest.fixture(scope="module")
def run():
    return _run_step(NAME)


# a small A model, plain and with hard and soft distillation (soft at tau 2): the A
# family with a RegNetY teacher is the reference recipe's. At 64^2: at 32^2 its last
# two stages attend over 1x1 maps, where the gradients of q and k are 0 in exact
# arithmetic and a train-mode BatchNorm normalises 4 values
A0 = "recnext_a0"
# a small L model (recnext_t's family at the small widths and depths: LA1 at stage 0,
# LA2 at stages 1-2, LA3 at stage 3, every ConvNorm with a conv bias), at 128^2: the L
# stem's stride is 8, so that stage 3 attends over 2x2 maps
L = "recnext_t"
OTHER_STEPS = {"a0": (A0, "none", 1.0, 64), "hard": (A0, "hard", 1.0, 64),
               "soft": (A0, "soft", 2.0, 64), "l": (L, "none", 1.0, 128),
               "l_hard": (L, "hard", 1.0, 128)}


# each step runs once, however many fixtures ask for it
_cached_step = functools.lru_cache(maxsize=None)(_run_step)


@pytest.fixture(scope="module", params=sorted(OTHER_STEPS))
def other_run(request):
    name, distillation, tau, side = OTHER_STEPS[request.param]
    return _cached_step(name, distillation, tau=tau, side=side)


def _ref(run, params, stats):
    return jax_to_torch({"params": params, "batch_stats": stats}, run["model"])


def test_loss_and_grad_norm_match_jax(run):
    _check_loss_and_grad_norm(run)


def test_other_steps_loss_and_grad_norm_match_jax(other_run):
    _check_loss_and_grad_norm(other_run)


def _check_loss_and_grad_norm(run):
    want = float(run["jax_metrics"]["loss"])
    assert float(run["metrics"]["loss"]) == pytest.approx(want, rel=1e-5)
    assert float(run["metrics"]["grad_norm"]) == pytest.approx(
        float(run["jax_metrics"]["grad_norm"]), rel=1e-4)


def test_every_gradient_matches_jax(run):
    _check_every_gradient(run)


def test_other_steps_every_gradient_matches_jax(other_run):
    _check_every_gradient(other_run)


def _bias_before_bn(name, keys):
    """Whether ``name`` is the conv bias of a ConvNorm (the L family's): a shift that
    the train-mode BatchNorm right after it removes, so its exact gradient is 0 and
    each side's is fp32 rounding noise, whose sign and size nothing pins."""
    return name.endswith(".conv.bias") and name[: -len("conv.bias")] + "norm.weight" in keys


def _check_every_gradient(run):
    ref = _ref(run, run["jax_grads"], run["variables"]["batch_stats"])
    assert set(run["grads"]) <= set(ref)
    zero = biases = 0
    for name, g in run["grads"].items():
        want = ref[name].numpy()
        scale = np.abs(want).max()
        err = np.abs(g.numpy() - want).max()
        if _bias_before_bn(name, ref):
            # noise of ~1e-6 on both sides (the sums of a 128^2 batch's terms): held
            # under 1e-5, chip_smoke.py's bound for a gradient that is 0 in exact
            # arithmetic
            assert max(np.abs(g.numpy()).max(), scale) < 1e-5, name
            biases += 1
            continue
        if scale < 1e-6:
            # a shift that a train-mode BatchNorm follows (a block's BN bias before the
            # MLP's first ConvNorm, a conv bias before BN): the exact gradient is 0 and
            # both sides hold fp32 rounding noise (~1e-7), which has no relative scale
            assert np.abs(g.numpy()).max() < 1e-6, name
            zero += 1
            continue
        assert err <= 1e-4 * scale, (name, err, scale)
    assert zero < (len(run["grads"]) - biases) // 4


def test_bn_statistics_params_and_ema_match_jax(run):
    _check_bn_statistics_params_and_ema(run)


def test_other_steps_bn_statistics_params_and_ema_match_jax(other_run):
    _check_bn_statistics_params_and_ema(other_run)


def _check_bn_statistics_params_and_ema(run):
    new = run["jax_state"]
    after = _ref(run, new.params, new.batch_stats)
    # the gradient Adam sees: the reference's, after AGC
    grads = _ref(run, run["jax_clipped"], run["variables"]["batch_stats"])
    raw = _ref(run, run["jax_grads"], run["variables"]["batch_stats"])
    family = run["jax_model"].cfg.family
    sd = run["model"].state_dict()
    stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        np.testing.assert_allclose(sd[k].numpy(), after[k].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    total = n_unpinned = 0
    tols = {}
    for name, p in run["model"].named_parameters():
        want = after[name].numpy()
        # Adam's first step is lr * g / (|g| + eps) on the clipped gradient g: where
        # the reference's g is under 1e-7 its sign and size turn on the order of the
        # sums, so there the two updates may differ by up to 2 lr; elsewhere within
        # 1e-6. Two cases reach that regime: AGC scales a unit whose parameters are
        # near 0 (a BN bias at init) to a norm of 0.02 * 1e-3, and an element whose
        # raw gradient is within the gradient check's own tolerance of 0 (1e-4 of its
        # tensor's max) has no pinned sign either. The L model adds a third case:
        # where the clipped gradient c is a few times eps in a tensor whose max is far
        # larger (the RepVGGDW 1x1 weights, whose scale the BatchNorm after them all
        # but removes), the step's slope eps / (c + eps)^2 lets that same tolerance d
        # move it by more than 1e-6, by lr * (s(c) - s(c - d)) at most, s(v) =
        # v / (|v| + eps): there it is held to that move. Without it the hard-distilled
        # L step fails by one element (1.13e-6 at c = 1.7e-7, max 3.9e-4); the M and A
        # steps pass the first two and keep them alone.
        g = raw[name].numpy()
        c = np.abs(grads[name].numpy())
        tiny = c < 1e-7
        unpinned = (np.abs(g) < 1e-4 * np.abs(g).max()) & ~tiny
        tol = np.where(tiny | unpinned, 2 * LR, 1e-6)
        if family == "l":
            s = lambda v: v / (np.abs(v) + 1e-8)  # noqa: E731
            moved = LR * (s(c) - s(c - 1e-4 * c.max()))
            unpinned |= (moved > 1e-6) & ~tiny
            tol = np.maximum(tol, moved)
        if _bias_before_bn(name, after):  # a gradient of noise on both sides: see above
            tol = np.full(g.shape, 2 * LR)
        tols[name] = tol
        err = np.abs(p.detach().numpy() - want)
        assert (err <= tol).all(), (name, err.max())
        if not _bias_before_bn(name, after):
            total += g.size
            n_unpinned += int(unpinned.sum())
    assert n_unpinned < 0.01 * total  # the second case is rare
    ema = _ref(run, new.ema_params, new.ema_batch_stats)
    for name, e in run["state"].ema.items():
        want = ema[name].numpy()
        if name in tols:  # a parameter: the EMA carries (1 - decay) of its update's bound
            assert (np.abs(e.numpy() - want) <= np.maximum(1e-6, (1 - EMA_DECAY) * tols[name])
                    ).all(), name
        else:  # a BN statistic, as the statistics above
            np.testing.assert_allclose(e.numpy(), want, rtol=1e-5, atol=1e-5, err_msg=name)
    assert "stem.stem.0.norm.num_batches_tracked" not in run["state"].ema
    assert run["state"].step == 1 and int(new.step) == 1


def test_eval_metrics_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(9, 11)).astype(np.float32)
    labels = rng.integers(0, 11, size=9).astype(np.int32)
    labels[-2:] = -1  # padded rows
    logits[0] = logits[0, labels[0]] - 1.0  # ties: argsort order decides top-5
    want = jstep.eval_metrics(jnp.asarray(logits), jnp.asarray(labels))
    got = tstep.eval_metrics(torch.from_numpy(logits), torch.from_numpy(labels).long())
    for k in ("correct1", "correct5", "count"):
        assert int(got[k]) == int(want[k]), k
    assert float(got["loss_sum"]) == pytest.approx(float(want["loss_sum"]), rel=1e-6)


@pytest.fixture(scope="module")
def l_run():
    return _cached_step(*OTHER_STEPS["l"][:2], tau=OTHER_STEPS["l"][2], side=128)


@pytest.mark.parametrize("ema", [False, True])
def test_eval_steps_match_jax(run, ema):
    _check_eval_steps(run, NAME, ema)


@pytest.mark.parametrize("ema", [False, True])
def test_l_eval_steps_match_jax(l_run, ema):
    _check_eval_steps(l_run, L, ema)


def test_l_conv_biases_take_no_decay_as_in_jax(l_run):
    """Every 1-D parameter (the L family's many conv biases among them) in no_decay,
    every kernel in decay: the JAX package's labels, carried across by name."""
    labels = topt.param_labels(l_run["model"].named_parameters())
    params = l_run["jax_state"].params
    decay = jax.tree.map(lambda p, lab: np.full(p.shape, lab == "decay", np.float32),
                         params, jopt.param_labels(params))
    ref = _ref(l_run, decay, l_run["variables"]["batch_stats"])
    assert labels == {n: "decay" if ref[n].flatten()[0] == 1 else "no_decay" for n in labels}
    biases = [n for n in labels if n.endswith(".conv.bias")]
    assert biases and all(labels[n] == "no_decay" for n in biases)


def _check_eval_steps(run, name, ema):
    """On the same weights: the JAX state after its step, carried across."""
    new = run["jax_state"]
    model = create_model(name, device="cpu", **OVR)
    model.load_state_dict(_ref(run, new.params, new.batch_stats), strict=True)
    state = TrainState.create(model, topt.make_optimizer(model.named_parameters(),
                                                         _sched(topt)))
    state.ema.update({k: v for k, v in _ref(run, new.ema_params, new.ema_batch_stats).items()
                      if k in state.ema})
    want = jstep.make_eval_step(run["jax_model"], ema=ema)(new, run["jax_batch"])
    got = tstep.make_eval_step(model, ema=ema, dtype=torch.float32)(state, run["batch"])
    cfg = jax_get_config(name, **OVR)
    fused_jax = jax_create_model(name, fused=True, **OVR)
    want_fused = jstep.make_fused_eval_step(cfg, ema=ema, fused_model=fused_jax, packed=False,
                                            dtype=jnp.float32)(new, run["jax_batch"])
    got_fused = tstep.make_fused_eval_step(get_config(name, **OVR), ema=ema,
                                           dtype=torch.float32)(state, run["batch"])
    for w, g in ((want, got), (want_fused, got_fused)):
        for k in ("correct1", "correct5", "count"):
            assert int(g[k]) == int(w[k]), k
        assert float(g["loss_sum"]) == pytest.approx(float(w["loss_sum"]), rel=1e-5)


def test_unported_options_raise_naming_their_item(tmp_path, capsys):
    # MESA, JSD, remat and grad_accum are the step's (tests/test_torch_train_options.py);
    # the JSD loss's views come from the loader (once a raise naming its item): the
    # trainer takes a step on 3 views of 2 samples
    from recnext_tpu_torch.train import main as tmain

    res = tmain.main(["--device", "cpu", "--model", NAME, "--model-kwargs",
                      "embed_dim=16:32:64:128,depth=1:1:2:1", "--data-set", "FAKE",
                      "--fake-classes", "11", "--simple-aug", "--jsd-loss", "--aug-splits",
                      "3", "--input-size", "32", "--batch-size", "6", "--epochs", "1",
                      "--steps-per-epoch", "1", "--dtype", "float32",
                      "--output-dir", str(tmp_path)])
    assert res["state"].step == 1
    assert '"loader_route": "pil"' in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="item 12"):
        tstep.make_fused_eval_step(get_config(NAME, **OVR), packed=True)


def test_distillation_needs_a_teacher_and_a_known_kind():
    with pytest.raises(ValueError, match="needs a teacher"):
        tstep.make_train_step(distillation="hard")
    with pytest.raises(ValueError, match="unknown distillation kind"):
        tstep.make_train_step(distillation="mild", teacher_apply=lambda x: x)


def test_teacher_apply_is_eval_mode_without_gradient_in_the_compute_dtype():
    _, teacher = _teacher()
    teacher.train()
    apply = tstep.make_teacher_apply(teacher, torch.bfloat16)
    assert not teacher.training
    x = torch.from_numpy(_batch()[0].transpose(0, 3, 1, 2).copy())
    logits = apply(x)
    assert logits.dtype == torch.float32 and not logits.requires_grad  # the fp32 head
    with torch.no_grad():
        want = teacher(x)
    assert (logits - want).abs().max().item() <= 5e-2 * want.abs().max().item()  # bf16 convs
    assert all(p.dtype == torch.float32 for p in teacher.parameters())  # cast apart

"""The train step's other options against the JAX package's ``make_train_step``, from
the same weights (a JAX init carried across with jax_to_torch) and the same batches,
in f32 with mixup off, as tests/test_torch_train_step.py holds the plain step:
``grad_accum=2`` (optax.MultiSteps there; the EMA moves on the update only), remat
(``jax.checkpoint`` there; torch.utils.checkpoint over the blocks here), MESA before
and after its start step, and the JSD loss on given views. After every step: the
loss, the BN running statistics, the parameters and the EMA."""

import functools
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recnext_tpu.models.registry import create_model as jax_create_model
from recnext_tpu.train import optim as jopt
from recnext_tpu.train import step as jstep
from recnext_tpu.train.state import TrainState as JaxTrainState
from recnext_tpu_torch.convert import jax_to_torch
from recnext_tpu_torch.models.registry import create_model
from recnext_tpu_torch.train import optim as topt
from recnext_tpu_torch.train import step as tstep
from recnext_tpu_torch.train.state import TrainState
from tests.test_torch_train_step import EMA_DECAY, LR, NAME, OVR

A0 = "recnext_a0"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _batches(count, n=4, side=32, views=1):
    """``count`` batches; with ``views`` > 1 each holds that many noisy views of the
    same n images (the clean one first) and their labels repeated."""
    out = []
    for i in range(count):
        rng = np.random.default_rng(10 + i)
        x = rng.normal(size=(n, side, side, 3)).astype(np.float32)
        y = rng.integers(0, 11, size=n).astype(np.int32)
        if views > 1:
            x = np.concatenate([x] + [x + 0.3 * rng.normal(size=x.shape).astype(np.float32)
                                      for _ in range(views - 1)])
            y = np.tile(y, views)
        out.append((x, y))
    return out


@functools.lru_cache(maxsize=None)
def _init(name, side):
    """The JAX init (BN statistics moved off (0, 1)), once a model and size."""
    model = jax_create_model(name, **OVR)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, side, side, 3)))
    return model, {"params": variables["params"], "batch_stats": jax.tree.map(
        lambda v: v + 0.05 * np.random.default_rng(3).normal(size=v.shape).astype(v.dtype),
        variables["batch_stats"])}


def _run(name, batches, *, grad_accum=1, side=32, jax_side=True, **kw):
    """Both packages' steps over ``batches`` (the port's alone without ``jax_side``):
    after each, the JAX state (as a torch state dict and EMA) and the port's, and
    both losses."""
    model, variables = _init(name, side)

    def sched_for(mod):
        sched = mod.cosine_schedule(LR, 1, 10, 0)
        return sched if grad_accum == 1 else (lambda u: sched(u * grad_accum))

    tx = jopt.make_optimizer(sched_for(jopt), weight_decay=0.025, agc_clip=0.02,
                             grad_accum=grad_accum)
    jstate = JaxTrainState.create(variables, tx)
    jfn = jax.jit(jstep.make_train_step(model, tx, num_classes=11, mixup=False,
                                        smoothing=0.1, ema_decay=EMA_DECAY,
                                        grad_accum=grad_accum, **kw)) if jax_side else None
    tm = create_model(name, device="cpu", **OVR)
    tm.load_state_dict(jax_to_torch(variables, tm), strict=True)
    opt = topt.make_optimizer(tm.named_parameters(), sched_for(topt), weight_decay=0.025,
                              agc_clip=0.02, grad_accum=grad_accum)
    tstate = TrainState.create(tm, opt)
    tfn = tstep.make_train_step(num_classes=11, mixup=False, smoothing=0.1,
                                ema_decay=EMA_DECAY, dtype=torch.float32,
                                grad_accum=grad_accum, **kw)
    steps = []
    for x, y in batches:
        tm_ = tfn(tstate, {"image": torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                           "label": torch.from_numpy(y).long()}, torch.Generator())
        step = dict(loss=float(tm_["loss"]),
                    sd={k: v.clone() for k, v in tm.state_dict().items()},
                    ema={k: v.clone() for k, v in tstate.ema.items()})
        if jax_side:
            jstate, jm = jfn(jstate, {"image": jnp.asarray(x), "label": jnp.asarray(y)},
                             jax.random.PRNGKey(1))
            step.update(jax_loss=float(jm["loss"]), jax_sd=jax_to_torch(
                {"params": jstate.params, "batch_stats": jstate.batch_stats}, tm),
                jax_ema=jax_to_torch({"params": jstate.ema_params,
                                      "batch_stats": jstate.ema_batch_stats}, tm))
        steps.append(step)
    return steps


# every run of the file: (model, batches, keyword arguments of _run)
RUNS = {"grad_accum": (NAME, dict(count=2), dict(grad_accum=2)),
        "remat": (NAME, dict(count=1), dict(remat=True)),
        "plain_m0": (NAME, dict(count=1), dict(jax_side=False)),
        "remat_m0": (NAME, dict(count=1), dict(remat=True, jax_side=False)),
        "plain_a0": (A0, dict(count=1, side=64), dict(side=64, jax_side=False)),
        "remat_a0": (A0, dict(count=1, side=64), dict(side=64, remat=True, jax_side=False)),
        "mesa_0": (NAME, dict(count=1), dict(mesa=1.0, mesa_start_step=0)),
        "mesa_1": (NAME, dict(count=1), dict(mesa=1.0, mesa_start_step=1)),
        "jsd": (NAME, dict(count=1, views=3), dict(jsd_splits=3))}


def _run_alone(name, batch_kw, kw):
    """``_run`` in a process of its own, the port's side on one thread as here."""
    torch.set_num_threads(1)
    return _run(name, _batches(**batch_kw), **kw)


@functools.lru_cache(maxsize=None)
def _runs():
    """Every run once, all at once: each run with a JAX side (its steps' tracing and
    compiling are most of the file's time) in a spawned process of its own, since in
    threads they would share one interpreter's lock; the port-only runs here, in
    threads."""
    with_jax = [k for k, (_, _, kw) in RUNS.items() if kw.get("jax_side", True)]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(len(with_jax), mp_context=ctx) as procs:
        futures = {k: procs.submit(_run_alone, *RUNS[k]) for k in with_jax}
        here = {k: v for k, v in RUNS.items() if k not in futures}
        for name, side in {(name, kw.get("side", 32)) for name, _, kw in here.values()}:
            _init(name, side)
        with ThreadPoolExecutor(len(here)) as pool:
            futures |= {k: pool.submit(_run, name, _batches(**b), **kw)
                        for k, (name, b, kw) in here.items()}
            return {k: f.result() for k, f in futures.items()}


def _check(step, updates):
    """The tolerances of tests/test_torch_train_step.py: the loss to 1e-5, the BN
    statistics to 1e-5; a parameter within 1e-6 but where Adam's sign of a gradient
    under its sums' rounding is not pinned, up to 2 lr an update, which fewer than 1%
    of the elements may use."""
    assert step["loss"] == pytest.approx(step["jax_loss"], rel=1e-5)
    params = {k for k, v in step["sd"].items()
              if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    total = loose = 0
    for k, v in step["sd"].items():
        want = step["jax_sd"][k]
        if k in params:
            err = (v - want).abs()
            assert err.max().item() <= 2 * LR * updates + 1e-6, k
            total += err.numel()
            loose += int((err > 1e-6).sum())
        elif not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(v.numpy(), want.numpy(), rtol=1e-5, atol=1e-5, err_msg=k)
    assert loose < 0.01 * total
    for k, e in step["ema"].items():
        want = step["jax_ema"][k]
        tol = (1 - EMA_DECAY) * 2 * LR * updates + 1e-6 if k in params else 1e-5
        assert (e - want).abs().max().item() <= tol + 1e-5 * want.abs().max().item(), k


def test_grad_accum_updates_on_the_second_micro_step_as_jax():
    """One update of two micro-steps. (Past one update the runs part: where Adam's
    first step turns on an unpinned gradient sign, the next forward's statistics
    follow the 2 lr apart that the tolerance allows.)"""
    first, second = _runs()["grad_accum"]
    # the first micro-step moves the BN statistics only: parameters and EMA stay
    _check(first, 0)
    for k, v in first["ema"].items():
        torch.testing.assert_close(v, first["jax_ema"][k], rtol=0, atol=1e-6)
    _check(second, 1)
    changed = [k for k in second["sd"] if k.endswith(".weight")
               and not torch.equal(second["sd"][k], first["sd"][k])]
    assert changed


def test_remat_step_matches_jax():
    _check(_runs()["remat"][0], 1)


@pytest.mark.parametrize("name", [NAME, A0])
def test_remat_step_matches_the_plain_step(name):
    """Recomputing the blocks in the backward changes no number: the same loss,
    parameters, BN statistics (updated once) and EMA as without remat."""
    short = "a0" if name == A0 else "m0"
    plain, remat = _runs()[f"plain_{short}"][0], _runs()[f"remat_{short}"][0]
    assert remat["loss"] == plain["loss"]
    for k in plain["sd"]:
        torch.testing.assert_close(remat["sd"][k], plain["sd"][k], rtol=0, atol=0)


@pytest.mark.parametrize("start", [0, 1])
def test_mesa_before_and_after_its_start_matches_jax(start):
    """One step at step 0: before MESA's start (1) the plain loss, from it (0) the
    plain loss plus MESA's term against the EMA model (at step 0 the model itself)."""
    step = _runs()[f"mesa_{start}"][0]
    _check(step, 1)
    plain = _runs()["plain_m0"][0]
    if start:
        assert step["loss"] == pytest.approx(plain["loss"], rel=1e-6)
    else:
        assert step["loss"] > plain["loss"] + 1.0  # + the softmax's entropy, ~ln 11


def test_jsd_loss_on_given_views_matches_jax():
    _check(_runs()["jsd"][0], 1)


def test_options_that_exclude_each_other_raise():
    with pytest.raises(ValueError, match="MESA"):
        tstep.make_train_step(mesa=1.0, distillation="hard", teacher_apply=lambda x: x)
    with pytest.raises(ValueError, match="MESA"):
        tstep.make_train_step(mesa=1.0, jsd_splits=3, mixup=False)
    with pytest.raises(ValueError, match="JSD"):
        tstep.make_train_step(jsd_splits=3)  # mixup on
    model = create_model(NAME, device="cpu", **OVR)
    state = TrainState.create(model, topt.make_optimizer(model.named_parameters(),
                                                         lambda u: LR), ema=False)
    x, y = _batches(1)[0]
    batch = {"image": torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
             "label": torch.from_numpy(y).long()}
    with pytest.raises(ValueError, match="EMA"):
        tstep.make_train_step(num_classes=11, mixup=False, mesa=1.0, dtype=torch.float32)(
            state, batch, torch.Generator())
    with pytest.raises(ValueError, match="accumulates 2"):
        tstep.make_train_step(num_classes=11, mixup=False, grad_accum=2)(
            state, batch, torch.Generator())
    with pytest.raises(ValueError, match="grad_accum"):
        topt.make_optimizer(model.named_parameters(), lambda u: LR, grad_accum=0)

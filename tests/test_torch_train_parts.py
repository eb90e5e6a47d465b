"""The port's losses, mixup/cutmix, schedule and optimizer against the JAX
package's, on the same inputs (made with numpy) and, for mixup, the same draws."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recnext_tpu.data import mixup as jmix
from recnext_tpu.train import losses as JL
from recnext_tpu.train import optim as jopt
from recnext_tpu_torch.data import mixup as tmix
from recnext_tpu_torch.train import losses as TL
from recnext_tpu_torch.train import optim as topt

RTOL, ATOL = 1e-6, 1e-7  # fp32 on both sides; sums in another order


def _logits(seed, n=6, c=12):
    return np.random.default_rng(seed).normal(size=(n, c)).astype(np.float32) * 3


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_soft_target_and_smoothing_ce_match_jax():
    logits = _logits(0)
    labels = np.random.default_rng(1).integers(0, 12, size=6)
    t = np.array(jmix.one_hot_smooth(jnp.asarray(labels), 12, 0.1))
    _close(TL.soft_target_cross_entropy(torch.from_numpy(logits), torch.from_numpy(t)),
           JL.soft_target_cross_entropy(jnp.asarray(logits), jnp.asarray(t)))
    for s in (0.0, 0.1, 0.3):
        _close(TL.label_smoothing_cross_entropy(torch.from_numpy(logits),
                                                torch.from_numpy(labels), s),
               JL.label_smoothing_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), s))
    _close(TL.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)),
           JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))


@pytest.mark.parametrize("thresh", [0.0, 0.2])
def test_binary_cross_entropy_matches_jax(thresh):
    logits = _logits(2)
    t = np.random.default_rng(3).uniform(size=logits.shape).astype(np.float32)
    _close(TL.binary_cross_entropy(torch.from_numpy(logits), torch.from_numpy(t), thresh),
           JL.binary_cross_entropy(jnp.asarray(logits), jnp.asarray(t), thresh))


def test_jsd_cross_entropy_matches_jax():
    logits = _logits(4, n=9)
    labels = np.random.default_rng(5).integers(0, 12, size=9)
    _close(TL.jsd_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                num_splits=3, alpha=12.0, smoothing=0.1),
           JL.jsd_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), num_splits=3,
                                alpha=12.0, smoothing=0.1))


@pytest.mark.parametrize("kind", ["none", "hard", "soft"])
@pytest.mark.parametrize("soft_targets", [False, True])
def test_distillation_loss_matches_jax_on_dual_head_outputs(kind, soft_targets):
    out, out_kd, teacher = _logits(6), _logits(7), _logits(8)
    labels = np.random.default_rng(9).integers(0, 12, size=6)
    if soft_targets:
        targets = np.array(jmix.one_hot_smooth(jnp.asarray(labels), 12, 0.1))
        tbase, jbase = TL.soft_target_cross_entropy, JL.soft_target_cross_entropy
    else:
        targets = labels
        tbase, jbase = TL.cross_entropy, JL.cross_entropy
    got = TL.distillation_loss((torch.from_numpy(out), torch.from_numpy(out_kd)),
                               torch.from_numpy(targets), torch.from_numpy(teacher),
                               base_criterion=tbase, kind=kind, alpha=0.4, tau=2.0)
    want = JL.distillation_loss((jnp.asarray(out), jnp.asarray(out_kd)), jnp.asarray(targets),
                                jnp.asarray(teacher), base_criterion=jbase, kind=kind,
                                alpha=0.4, tau=2.0)
    _close(got, want)


def test_distillation_loss_raises_without_teacher_or_second_head():
    out = torch.from_numpy(_logits(0))
    labels = torch.zeros(6, dtype=torch.long)
    with pytest.raises(ValueError, match="dual-head"):
        TL.distillation_loss(out, labels, out, base_criterion=TL.cross_entropy, kind="hard")
    with pytest.raises(ValueError, match="teacher"):
        TL.distillation_loss((out, out), labels, None, base_criterion=TL.cross_entropy,
                             kind="soft")


def _jax_draws(key, h, w, mixup_alpha, cutmix_alpha, switch_prob):
    """The draws recnext_tpu/data/mixup.py:mixup_cutmix makes from ``key``, rebuilt
    with the same splits and samplers."""
    r_switch, r_mix, r_cut, r_box = jax.random.split(key, 4)
    use = bool(jax.random.bernoulli(r_switch, switch_prob))
    lam_mix = float(jax.random.beta(r_mix, mixup_alpha, mixup_alpha))
    lam_cut = float(jax.random.beta(r_cut, cutmix_alpha, cutmix_alpha))
    ry, rx = (int(v) for v in jax.random.randint(r_box, (2,), 0, jnp.array([h, w])))
    return tmix.MixupDraw(use, lam_mix, lam_cut, (ry, rx))


@pytest.mark.parametrize("switch_prob", [0.0, 1.0, 0.5])
@pytest.mark.parametrize("hw", [(16, 16), (13, 20)])
def test_mixup_cutmix_matches_jax_on_the_same_draws(switch_prob, hw):
    h, w = hw
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, h, w, 3)).astype(np.float32)
    labels = rng.integers(0, 5, size=6).astype(np.int32)
    branches = set()
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        kw = dict(mixup_alpha=0.8, cutmix_alpha=1.0, switch_prob=switch_prob)
        draw = _jax_draws(key, h, w, **kw)
        branches.add(draw.use_cutmix)
        jx, jt = jmix.mixup_cutmix(key, jnp.asarray(x), jnp.asarray(labels), num_classes=5,
                                   smoothing=0.1, **kw)
        tx, tt = tmix.apply_mixup(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                                  torch.from_numpy(labels), draw, num_classes=5,
                                  smoothing=0.1)
        # the same float32 operations on both sides: bit-equal
        np.testing.assert_array_equal(tx.numpy().transpose(0, 2, 3, 1), np.asarray(jx))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    if switch_prob == 0.5:
        assert branches == {False, True}  # both branches ran


def test_one_hot_smooth_matches_jax():
    labels = np.array([0, 3, 9, 9, 1])
    np.testing.assert_array_equal(
        tmix.one_hot_smooth(torch.from_numpy(labels), 10, 0.1).numpy(),
        np.asarray(jmix.one_hot_smooth(jnp.asarray(labels), 10, 0.1)))


def test_mixup_draws_come_from_the_generator():
    a = tmix.draw_mixup(torch.Generator().manual_seed(3), 20, 30)
    b = tmix.draw_mixup(torch.Generator().manual_seed(3), 20, 30)
    assert a == b
    g = torch.Generator().manual_seed(0)
    draws = [tmix.draw_mixup(g, 20, 30) for _ in range(4000)]
    assert all(0.0 <= d.lam_mix <= 1.0 and 0.0 <= d.lam_cut <= 1.0 for d in draws)
    assert all(0 <= d.center[0] < 20 and 0 <= d.center[1] < 30 for d in draws)
    share = np.mean([d.use_cutmix for d in draws])
    assert 0.46 < share < 0.54  # 0.5, within 5 standard deviations
    # Beta(0.8, 0.8) has mean 0.5 and variance 1/(4 * 2.6); Beta(1, 1) variance 1/12
    lam = np.array([d.lam_mix for d in draws])
    assert abs(lam.mean() - 0.5) < 0.025 and abs(lam.var() - 1 / 10.4) < 0.01
    lam = np.array([d.lam_cut for d in draws])
    assert abs(lam.mean() - 0.5) < 0.025 and abs(lam.var() - 1 / 12) < 0.01
    x, t = tmix.mixup_cutmix(torch.Generator().manual_seed(0), torch.randn(4, 3, 8, 8),
                             torch.arange(4), num_classes=4)
    assert x.shape == (4, 3, 8, 8) and torch.allclose(t.sum(-1), torch.ones(4))


def test_cosine_schedule_matches_jax_at_every_step():
    kw = dict(epochs=12, warmup_epochs=3, cooldown_epochs=0, warmup_lr=1e-6, min_lr=1e-5)
    js = jopt.cosine_schedule(2e-3, 3, **kw)
    ts = topt.cosine_schedule(2e-3, 3, **kw)
    for step in range(3 * 15):  # past the end of the cycle too
        assert ts(step) == pytest.approx(float(js(step)), rel=1e-7, abs=0), step


def test_cosine_schedule_matches_reference_log():
    """tests/test_train.py:68's values of the committed reference log (base 2e-3)."""
    sched = topt.cosine_schedule(2e-3, steps_per_epoch=10, epochs=300, warmup_epochs=5,
                                 cooldown_epochs=0, warmup_lr=1e-6, min_lr=1e-5)
    log = {0: 1e-6, 1: 1e-6, 4: 1.2004e-3, 5: 1.6002e-3, 150: 1.0154194251956726e-3,
           290: 1.659409822760516e-5, 299: 1.0218219942528799e-5}
    for epoch, want in log.items():
        assert sched(epoch * 10) == pytest.approx(want, rel=1e-3), epoch
    assert topt.cosine_schedule(2e-3, 10, 300, 5, 10)(305 * 10) == pytest.approx(1e-5)
    assert topt.scaled_lr(1e-3, 2048) == pytest.approx(4e-3)


# one parameter of each kind, port layout -> JAX layout
def _to_jax(name, a):
    if name == "dense":  # torch Linear (out, in) -> flax Dense (in, out)
        return a.T
    if a.ndim == 4:  # OIHW -> HWIO
        return a.transpose(2, 3, 1, 0)
    return a


SHAPES = {"bias": (16,), "dense": (8, 12), "dw": (6, 1, 5, 5), "pw": (10, 6, 1, 1),
          "scalar_unit": (1, 7)}


def _params_and_grads(seed, steps=3):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    # gradients of several scales: some units clipped by AGC, some not
    grads = [{k: (rng.normal(size=s) * rng.choice([1e-4, 1e-2, 1.0], size=s[:1] + (1,) * (len(s) - 1))
                  ).astype(np.float32) for k, s in SHAPES.items()} for _ in range(steps)]
    return params, grads


@pytest.mark.parametrize("name", list(SHAPES))
def test_agc_clips_each_unit_as_optax(name):
    params, grads = _params_and_grads(1, steps=1)
    p, g = params[name], grads[0][name] * 30
    tp = torch.nn.Parameter(torch.from_numpy(p.copy()))
    tp.grad = torch.from_numpy(g.copy())
    topt.adaptive_grad_clip_([tp], 0.02)
    clip = optax.adaptive_grad_clip(0.02)
    want, _ = clip.update({"x": jnp.asarray(_to_jax(name, g))}, clip.init(None),
                          {"x": jnp.asarray(_to_jax(name, p))})
    np.testing.assert_allclose(_to_jax(name, tp.grad.numpy()), np.asarray(want["x"]),
                               rtol=RTOL, atol=0)
    assert not np.array_equal(tp.grad.numpy(), g)  # the case clips something


def test_three_steps_of_agc_adamw_match_optax():
    params, grads = _params_and_grads(2)
    sched_args = (1e-3, 1, 10, 0)  # warm-up 0: the first updates run at the base lr
    tx = jopt.make_optimizer(jopt.cosine_schedule(*sched_args), weight_decay=0.025,
                             agc_clip=0.02)
    jp = {k: jnp.asarray(_to_jax(k, v)) for k, v in params.items()}
    state = tx.init(jp)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = topt.make_optimizer(tparams.items(), topt.cosine_schedule(*sched_args),
                              weight_decay=0.025, agc_clip=0.02)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(_to_jax(k, v)) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k, p in tparams.items():
        np.testing.assert_allclose(_to_jax(k, p.detach().numpy()), np.asarray(jp[k]),
                                   rtol=RTOL, atol=1e-8, err_msg=k)
        assert not np.allclose(p.detach().numpy(), params[k])  # the steps moved it
    # the decay applies to >=2-D parameters only, as param_labels says
    assert topt.param_labels(tparams.items()) == {
        "bias": "no_decay", "dense": "decay", "dw": "decay", "pw": "decay",
        "scalar_unit": "decay"}


def test_grad_accum_raises_naming_the_roadmap_item():
    """Gradient accumulation is ported (it raised, naming ROADMAP Queue 1 item 6): six
    micro-steps of 2 against optax.MultiSteps over the same chain, the schedule read
    at the update count; only a count below 1 still raises."""
    p = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(ValueError, match="grad_accum"):
        topt.make_optimizer([("p", p)], lambda s: 1e-3, grad_accum=0)
    params, grads = _params_and_grads(3, steps=6)
    jsched, tsched = jopt.cosine_schedule(1e-3, 1, 10, 0), topt.cosine_schedule(1e-3, 1, 10, 0)
    tx = jopt.make_optimizer(lambda u: jsched(u * 2), weight_decay=0.025, agc_clip=0.02,
                             grad_accum=2)
    jp = {k: jnp.asarray(_to_jax(k, v)) for k, v in params.items()}
    state = tx.init(jp)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = topt.make_optimizer(tparams.items(), lambda u: tsched(u * 2), weight_decay=0.025,
                              agc_clip=0.02, grad_accum=2)
    for i, g in enumerate(grads):
        upd, state = tx.update({k: jnp.asarray(_to_jax(k, v)) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, q in tparams.items():
            q.grad = torch.from_numpy(g[k].copy())
        assert opt.step() == (i % 2 == 1)  # an update on every second micro-step
        # the means are equal to the bit; torch's AdamW and optax's round their
        # bias corrections apart, which an element whose mean nearly cancels carries
        # to ~1e-5 of its lr-sized step: atol 1e-4 lr
        for k, q in tparams.items():
            np.testing.assert_allclose(_to_jax(k, q.detach().numpy()), np.asarray(jp[k]),
                                       rtol=RTOL, atol=1e-7, err_msg=(i, k))
    assert opt.count == 3 and opt.mini_step == 0

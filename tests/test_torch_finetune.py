"""The finetune warm start against the JAX package's: ``fusion.defuse_params`` (the
defused model computes the fused one's logits), ``train/finetune.py:warm_start`` and
``load_pretrained`` on a raw reference ``.pth``, a fused archive and the trainer's
own checkpoint, each held against ``recnext_tpu.train.finetune`` on the same seeded
weights carried across with jax_to_torch; and the model's logits at 384^2 against
the JAX model's, for the M and A families."""

import copy
import functools

import jax
import numpy as np
import pytest
import torch

from recnext_tpu.fusion import defuse_params as jax_defuse_params
from recnext_tpu.fusion import fuse_params as jax_fuse_params
from recnext_tpu.train import finetune as jft
from recnext_tpu_torch.convert import jax_fused_to_torch, jax_to_torch
from recnext_tpu_torch.fusion import defuse_params, fuse_params
from recnext_tpu_torch.train import finetune as tft
from tests.test_torch_models import (
    _image,
    _nchw,
    _port_model,
    check_logits_and_features,
)
from tests.test_torch_models import init_jax_variables as _init_jax_variables


@functools.lru_cache(maxsize=None)
def _jax_init(name):
    return _init_jax_variables(name)


def init_jax_variables(name):
    """The JAX init of ``name`` (a jitted init, its compile most of a test's time),
    made once a model for the file; each caller gets its own copy."""
    return copy.deepcopy(_jax_init(name))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=["recnext_m0", "recnext_a0"])
def family(request):
    return request.param, init_jax_variables(request.param)


def _assert_same_dict(got, want, atol=1e-6):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].float().numpy(), np.asarray(v, np.float32),
                                   rtol=1e-6, atol=atol, err_msg=k)


def test_defuse_params_matches_jax(family):
    name, variables = family
    fused = jax_fuse_params(variables)
    want = jax_to_torch(jax_defuse_params(fused["params"], variables))
    template = _port_model(name=name).state_dict()
    got = defuse_params(jax_fused_to_torch(fused), template)
    _assert_same_dict(got, want)
    # fusion undoes it, and the defused model computes the fused model's logits
    refused = fuse_params(got)
    _assert_same_dict(refused, jax_fused_to_torch(fused))
    unfused = _port_model(name=name).eval()
    unfused.load_state_dict(got, strict=True)
    fused_model = _port_model(fused=True, name=name).eval()
    fused_model.load_state_dict(jax_fused_to_torch(fused), strict=True)
    x = _nchw(_image(64, seed=2))
    with torch.no_grad():
        a, b = unfused(x), fused_model(x)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * b.abs().max().item())


def _without(tree, path):
    out = {k: (_without(v, path[1:]) if k == path[0] and len(path) > 1 else v)
           for k, v in tree.items() if not (k == path[0] and len(path) == 1)}
    return out


def test_warm_start_matches_jax(family):
    """The loaded model has 7 classes, the new one 11: the heads are dropped; a leaf
    missing from the checkpoint keeps the init; an unexpected one is ignored."""
    name, template = family
    loaded = init_jax_variables(name)
    loaded = jax.tree.map(lambda v: v * 1.5 + 0.25, loaded)  # other values than the init
    head = loaded["params"]["head"]
    rng = np.random.default_rng(0)
    for h in ("head", "head_dist"):
        lin = head[h]["linear"]
        head[h]["linear"] = {"kernel": rng.normal(size=(lin["kernel"].shape[0], 7)).astype(
            np.float32), "bias": np.zeros(7, np.float32)}
    # the stem's first conv goes missing from the checkpoint
    loaded = {"params": _without(loaded["params"], ("stem", "conv1", "conv", "kernel")),
              "batch_stats": loaded["batch_stats"]}
    logs = []
    want = jax_to_torch(jft.warm_start(template, loaded, log=logs.append))
    port_template = jax_to_torch(template)
    port_loaded = {k: torch.from_numpy(np.asarray(v)) for k, v in jax_to_torch(loaded).items()}
    port_loaded["bogus.weight"] = torch.zeros(3)
    tlogs = []
    got = tft.warm_start(port_template, port_loaded, log=tlogs.append)
    _assert_same_dict(got, want)
    assert sum("Removing key" in m for m in tlogs) == sum("Removing key" in m for m in logs)
    assert sum("Removing key" in m for m in tlogs) == 4  # both heads' linear leaves
    assert any("bogus.weight" in m for m in tlogs)
    with pytest.raises(SystemExit):
        tft.warm_start(port_template, {"bogus.weight": torch.zeros(3)}, log=tlogs.append)
    with pytest.raises(SystemExit):
        jft.warm_start(template, {"params": {"bogus": np.zeros(3)}}, log=logs.append)


def test_load_pretrained_matches_jax(family, tmp_path):
    """A raw reference .pth, a fused archive and the trainer's checkpoint (its EMA),
    each warm-starting the same template on both sides."""
    name, template = family
    source = jax.tree.map(lambda v: v * 0.5 - 0.125, init_jax_variables(name))
    family_letter = name[-2]
    raw = jax_to_torch(source)
    torch.save({"model": raw}, tmp_path / "raw.pth")
    fused = fuse_params(raw)
    torch.save(fused, tmp_path / "fused.pt")
    port_template = jax_to_torch(template)
    for f in ("raw.pth", "fused.pt"):
        want = jax_to_torch(jft.load_pretrained(str(tmp_path / f), jax.device_get(template),
                                                family=family_letter, log=lambda m: None))
        got = tft.load_pretrained(str(tmp_path / f), port_template, log=lambda m: None)
        _assert_same_dict(got, want, atol=1e-5)
    # the trainer's checkpoint: the EMA weights, the raw .pth of those weights
    ema = {k: v for k, v in raw.items() if not k.endswith("num_batches_tracked")}
    model = {k: torch.zeros_like(v) for k, v in raw.items()}
    torch.save({"epoch": 3, "state": {"step": 9, "model": model, "optimizer": {},
                                      "ema": ema}}, tmp_path / "epoch_0003.pt")
    logs = []
    got = tft.load_pretrained(str(tmp_path / "epoch_0003.pt"), port_template, log=logs.append)
    want = jax_to_torch(jft.load_pretrained(str(tmp_path / "raw.pth"), jax.device_get(template),
                                            family=family_letter, log=lambda m: None))
    _assert_same_dict(got, want)
    assert any("EMA" in m for m in logs)
    assert tft.read_weights(str(tmp_path / "epoch_0003.pt"), ema=False)[
        "stem.stem.0.conv.weight"].abs().max() == 0


def test_jax_formats_raise_naming_their_item(family, tmp_path):
    """A flax .msgpack of the variables now reads (the same warm start as the JAX
    package's load_pretrained of it); an orbax directory still raises, naming its
    ROADMAP item."""
    from flax import serialization

    name, variables = family
    (tmp_path / "w.msgpack").write_bytes(serialization.msgpack_serialize(
        jax.tree.map(np.asarray, variables)))
    port_template = _port_model(name=name).state_dict()
    got = tft.load_pretrained(str(tmp_path / "w.msgpack"), port_template, log=lambda m: None)
    want = jax_to_torch(jft.load_pretrained(
        str(tmp_path / "w.msgpack"), jax.device_get(variables),
        family=name[len("recnext_")], log=lambda m: None))
    _assert_same_dict(got, want)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 18"):
        tft.load_pretrained(str(tmp_path), {}, log=lambda m: None)


@pytest.mark.parametrize("name", ["recnext_m0", "recnext_a0"])
def test_logits_and_features_at_384_match_jax(name):
    """The 384^2 finetune recipe's resolution: stage planes 96/48/24/12, RecConv levels
    down to 6x6 and 3x3 at stage 3 (tests/test_models.py:test_parity_at_384)."""
    check_logits_and_features(init_jax_variables(name), name, 384,
                              scale_logit_atol=name.startswith("recnext_a"))

"""The port's reader of the JAX package's ``.msgpack`` files (``utils/msgpack.py``)
against flax's ``serialization``: f32 and bf16 leaves, numpy scalars, a chunked
array; ``--finetune w.msgpack`` gives the warm start of the ``.pth`` of the same
weights; a JAX RegNetY's variables load strictly as ``--teacher-ckpt``; and the port
reads them with neither ``flax`` nor ``msgpack`` imported."""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization

from recnext_tpu.models import regnet as jregnet
from recnext_tpu.models.registry import create_model as jax_create_model
from recnext_tpu_torch.convert import jax_regnet_to_torch, jax_to_torch
from recnext_tpu_torch.models import regnet as tregnet
from recnext_tpu_torch.models.registry import create_model
from recnext_tpu_torch.train import finetune as tft
from recnext_tpu_torch.train import main as tmain
from recnext_tpu_torch.utils.msgpack import msgpack_restore, read_msgpack

REPO = Path(__file__).resolve().parents[1]
SMALL = "embed_dim=16:32:64:128,depth=1:1:2:1"
OVR = dict(embed_dim=(16, 32, 64, 128), depth=(1, 1, 2, 1), num_classes=11)
TINY = dict(name="tiny", w0=24, wa=24.0, wm=2.0, depth=4, group_width=8, stem_width=16,
            num_classes=11)  # tests/test_torch_regnet.py's tiny RegNetY


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tree():
    rng = np.random.default_rng(0)
    return {"params": {"a": rng.normal(size=(3, 4)).astype(np.float32),
                       "b": rng.normal(size=(5,)).astype(ml_dtypes.bfloat16),
                       "c": {"d": rng.integers(-9, 9, size=(2, 2)).astype(np.int32)}},
            "scalars": {"f": np.float32(2.5), "i": np.int64(-7), "u": np.uint8(200)},
            "plain": {"n": 3, "neg": -2 ** 40, "x": 1.25, "s": "text", "none": None,
                      "list": [1, "two", 3.0]},
            "empty": {}}


def _same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (np.ndarray, np.generic)):
        w = np.asarray(want)
        if w.dtype == ml_dtypes.bfloat16:
            w = w.astype(np.float32)  # read through uint16 into float32, exactly
        assert np.asarray(got).dtype == w.dtype and np.array_equal(np.asarray(got), w)
        assert isinstance(got, np.generic) == isinstance(want, np.generic)
    else:
        assert got == want and type(got) is type(want)


def test_decoder_reads_what_flax_writes():
    blob = serialization.msgpack_serialize(_tree())
    _same(msgpack_restore(blob), serialization.msgpack_restore(blob))


def test_decoder_joins_chunked_arrays(monkeypatch, tmp_path):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)  # arrays over 64 bytes chunk
    tree = {"big": np.arange(100, dtype=np.float32).reshape(4, 25),
            "big_bf16": np.linspace(-4, 4, 90).astype(ml_dtypes.bfloat16).reshape(9, 10),
            "small": np.ones(3, np.float32)}
    blob = serialization.msgpack_serialize(tree)
    # the chunked form really is on the wire
    raw = serialization.msgpack.unpackb(blob, raw=False, ext_hook=lambda c, d: d)
    assert raw["big"]["__msgpack_chunked_array__"] and len(raw["big"]["chunks"]) == 7
    (tmp_path / "t.msgpack").write_bytes(blob)
    _same(read_msgpack(tmp_path / "t.msgpack"), serialization.msgpack_restore(blob))


def test_decoder_refuses_truncated_data():
    blob = serialization.msgpack_serialize(_tree())
    with pytest.raises(ValueError, match="truncated"):
        msgpack_restore(blob[:-3])


@pytest.fixture(scope="module")
def m0_weights(tmp_path_factory):
    """A JAX init of the small M model as flax's .msgpack and as the .pth of the same
    weights (jax_to_torch)."""
    root = tmp_path_factory.mktemp("w")
    jm = jax_create_model("recnext_m0", **OVR)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    v = jax.tree.map(np.asarray, v)
    (root / "w.msgpack").write_bytes(serialization.msgpack_serialize(v))
    torch.save(jax_to_torch(v), root / "w.pth")
    return root


def test_finetune_from_msgpack_is_the_pth_warm_start(m0_weights, tmp_path, capsys):
    """The same weights under --finetune: as .msgpack and as .pth, onto a head of
    another class count; the warm-started states and the losses of a step agree."""
    template = create_model("recnext_m0", device="cpu", **OVR).state_dict()
    a = tft.load_pretrained(str(m0_weights / "w.msgpack"), template, log=lambda m: None)
    b = tft.load_pretrained(str(m0_weights / "w.pth"), template, log=lambda m: None)
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    losses = []
    for f in ("w.msgpack", "w.pth"):
        res = tmain.main(["--device", "cpu", "--model", "recnext_m0", "--model-kwargs", SMALL,
                          "--data-set", "FAKE", "--simple-aug", "--input-size", "32",
                          "--batch-size", "4", "--epochs", "1", "--steps-per-epoch", "1",
                          "--fake-classes", "7", "--dtype", "float32", "--log-every", "1",
                          "--finetune", str(m0_weights / f), "--output-dir",
                          str(tmp_path / f)])
        out = capsys.readouterr().out
        assert "Removing key head.head.linear.weight" in out  # 11 classes onto 7
        losses.append([line for line in out.splitlines() if ": loss " in line])
        state = res["state"].model.state_dict()
        if f == "w.msgpack":
            first = state
    assert losses[0] == losses[1] and len(losses[0]) == 1
    assert all(torch.equal(first[k], v) for k, v in state.items())


def test_regnet_teacher_msgpack_loads_strictly(tmp_path):
    jmodel = jregnet.RegNetY(cfg=jregnet.RegNetConfig(**TINY))
    v = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                                      jnp.zeros((1, 32, 32, 3))))
    (tmp_path / "teacher.msgpack").write_bytes(serialization.msgpack_serialize(v))
    port = tregnet.RegNetY(tregnet.RegNetConfig(**TINY))
    loaded = tft.read_weights(str(tmp_path / "teacher.msgpack"), ema=False)
    port.load_state_dict(loaded, strict=True)
    want = jax_regnet_to_torch(v, port)
    assert all(torch.equal(loaded[k], want[k]) for k in want)
    # strict: a tree that lacks a leaf is refused by the teacher's load
    del v["params"]["head_fc"]["bias"]
    (tmp_path / "bad.msgpack").write_bytes(serialization.msgpack_serialize(v))
    with pytest.raises(RuntimeError, match="head.fc.bias"):
        port.load_state_dict(tft.read_weights(str(tmp_path / "bad.msgpack"), ema=False),
                             strict=True)


def test_the_port_reads_msgpack_without_flax_or_msgpack(m0_weights):
    code = textwrap.dedent(f"""
        import sys
        from recnext_tpu_torch.train.finetune import read_weights
        sd = read_weights({str(m0_weights / 'w.msgpack')!r}, ema=False)
        assert "stem.stem.0.conv.weight" in sd
        loaded = [m for m in ("flax", "msgpack", "jax") if m in sys.modules]
        assert not loaded, loaded
    """)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)

"""The port's serving stack on the CPU (device="cpu"), mirroring tests/test_serve.py:
archive -> ServingModel -> HTTP server; responses must match direct inference, and
direct inference must match the JAX package's fused model on the same weights."""

import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from recnext_tpu.convert import flax_fused_to_torch, save_torch_checkpoint, torch_to_flax
from recnext_tpu.data.transforms import EvalTransform as JaxEvalTransform
from recnext_tpu.fusion import fuse_params as jax_fuse_params
from recnext_tpu.models.registry import create_model as jax_create_model
from recnext_tpu_torch.export import load_published, publish_fused
from recnext_tpu_torch.models.packed_infer import default_groups
from recnext_tpu_torch.models.registry import create_model
from recnext_tpu_torch.serve import ServingModel, check_server, make_server, topk_json

OVR = dict(embed_dim=(16, 32, 64, 128), depth=(1, 1, 2, 1), num_classes=11)
SIZE = 32


def _unfused_state(name, seed):
    model = create_model(name, device="cpu",
                         generator=torch.Generator().manual_seed(seed), **OVR)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():  # non-trivial BN statistics so fusion does something
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.running_mean.copy_(0.1 * torch.randn(m.num_features, generator=g))
                m.running_var.copy_(0.75 + 0.5 * torch.rand(m.num_features, generator=g))
                m.weight.copy_(1 + 0.1 * torch.randn(m.num_features, generator=g))
                m.bias.copy_(0.1 * torch.randn(m.num_features, generator=g))
    return model.state_dict()


@pytest.fixture(scope="module")
def unfused_state():
    return _unfused_state("recnext_m0", 7)


@pytest.fixture(scope="module")
def archive(unfused_state, tmp_path_factory):
    out = tmp_path_factory.mktemp("archive")
    publish_fused("recnext_m0", unfused_state, str(out))
    return str(out)


@pytest.fixture(scope="module")
def serving(archive):
    m = ServingModel(archive, "recnext_m0", max_batch=4, input_size=SIZE,
                     dtype=torch.float32, device="cpu", cfg_overrides=OVR)
    m.warmup()
    return m


def _jpeg_bytes(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 255, (48, 40, 3), np.uint8))
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=95)
    return buf.getvalue()


def test_predict_pads_and_matches_direct_and_jax(serving, unfused_state, rng):
    x = rng.normal(size=(3, 3, SIZE, SIZE)).astype(np.float32)
    got = serving.predict(x)  # 3 rows into a max_batch=4 forward
    assert got.shape == (3, 11)
    with torch.no_grad():
        direct = torch.softmax(serving.model(torch.from_numpy(x)), dim=-1).numpy()
    np.testing.assert_allclose(got, direct, atol=2e-5, rtol=2e-5)
    # the JAX package's fused model on the same weights
    variables = torch_to_flax({k: v.numpy() for k, v in unfused_state.items()})
    fused = jax_create_model("recnext_m0", fused=True, **OVR)
    want = jax.nn.softmax(fused.apply(jax_fuse_params(variables),
                                      jnp.asarray(x.transpose(0, 2, 3, 1))), axis=-1)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)


def test_predict_rejects_bad_shapes(serving):
    with pytest.raises(ValueError):
        serving.predict(np.zeros((5, 3, SIZE, SIZE), np.float32))  # > max_batch
    with pytest.raises(ValueError):
        serving.predict(np.zeros((1, SIZE, SIZE, 3), np.float32))  # NHWC


def test_preprocess_matches_jax_eval_transform(serving):
    img = Image.open(io.BytesIO(_jpeg_bytes(5)))
    want = JaxEvalTransform(size=SIZE)(None, img).transpose(2, 0, 1)
    np.testing.assert_array_equal(serving.preprocess(_jpeg_bytes(5)), want)


def test_archive_written_by_the_jax_package_loads(unfused_state, tmp_path):
    """`python -m recnext_tpu.export --to-torch` layout: {"model": fused state}."""
    variables = torch_to_flax({k: v.numpy() for k, v in unfused_state.items()})
    save_torch_checkpoint(flax_fused_to_torch(jax_fuse_params(variables)),
                          str(tmp_path / "recnext_m0_fused.pt"))
    state = load_published("recnext_m0", str(tmp_path))
    model = create_model("recnext_m0", fused=True, device="cpu", **OVR)
    model.load_state_dict(state, strict=True)


@pytest.fixture(scope="module")
def server(serving):
    srv = make_server(serving, port=0, window_ms=20.0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.batcher.close()


def test_ping_and_info(server, serving):
    with urllib.request.urlopen(f"{server}/ping", timeout=30) as r:
        assert json.loads(r.read())["status"] == "Healthy"
    with urllib.request.urlopen(f"{server}/models/recnext_m0", timeout=30) as r:
        info = json.loads(r.read())
    assert info["input_size"] == SIZE and info["max_batch"] == 4
    # the M family serves through the packed executor, at default_groups(cfg, max_batch)
    assert info["packed"] is True and info["device"] == "cpu"
    assert info["groups"] == list(default_groups(serving.cfg, 4))
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(f"{server}/models/nope", timeout=30)


def test_prediction_parity_with_direct(server, serving, tmp_path):
    img = tmp_path / "img.jpg"
    img.write_bytes(_jpeg_bytes(0))
    assert check_server(server, serving, str(img))


def test_concurrent_requests_microbatch(server, serving):
    results = {}

    def post(i):
        req = urllib.request.Request(
            f"{server}/predictions/recnext_m0", data=_jpeg_bytes(i), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            results[i] = json.loads(r.read())

    threads = [threading.Thread(target=post, args=(i,)) for i in range(6)]
    before = serving.requests_served
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert len(results) == 6
    for i, res in results.items():
        top = res["topk"]
        assert len(top) == 5 and sum(e["score"] for e in top) <= 1.0 + 1e-5
        direct = topk_json(serving.predict(serving.preprocess(_jpeg_bytes(i))[None])[0])
        assert top[0]["class_id"] == direct["topk"][0]["class_id"]
        assert abs(top[0]["score"] - direct["topk"][0]["score"]) < 1e-5
    assert serving.requests_served >= before + 6


def test_bad_image_is_400(server):
    req = urllib.request.Request(
        f"{server}/predictions/recnext_m0", data=b"not an image", method="POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 400


def test_a_family_round_trip(tmp_path):
    """An A model: archive -> ServingModel -> HTTP server; direct inference matches
    the JAX package's fused A model on the same weights, and the server matches
    direct inference."""
    state = _unfused_state("recnext_a0", 11)
    publish_fused("recnext_a0", state, str(tmp_path))
    serving = ServingModel(str(tmp_path), "recnext_a0", max_batch=4, input_size=SIZE,
                           dtype=torch.float32, device="cpu", cfg_overrides=OVR)
    x = np.random.default_rng(12).normal(size=(3, 3, SIZE, SIZE)).astype(np.float32)
    got = serving.predict(x)
    assert got.shape == (3, 11)
    variables = torch_to_flax({k: v.numpy() for k, v in state.items()})
    fused = jax_create_model("recnext_a0", fused=True, **OVR)
    want = jax.nn.softmax(fused.apply(jax_fuse_params(variables),
                                      jnp.asarray(x.transpose(0, 2, 3, 1))), axis=-1)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)
    srv = make_server(serving, port=0, window_ms=20.0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        img = tmp_path / "img.jpg"
        img.write_bytes(_jpeg_bytes(3))
        assert check_server(f"http://127.0.0.1:{srv.server_address[1]}", serving, str(img))
    finally:
        srv.shutdown()
        srv.batcher.close()
        srv.server_close()

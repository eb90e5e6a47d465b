"""The port's export CLI (``python -m recnext_tpu_torch.export``) against the JAX
package: a JAX init carried across as a ``.pth``, published, fused and exported by
``torch.export`` on the CPU; the program's logits against the JAX fused forward on
the same weights (tests/test_torch_models.py's fused bounds), ``--to-torch`` against
``recnext_tpu/convert.py:flax_fused_to_torch`` bit for bit, ``--sha-stamp``, the MLLA
branch's refusal, and the program loaded by ``torch.export.load`` in a fresh
process."""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recnext_tpu.convert import flax_fused_to_torch
from recnext_tpu.fusion import fuse_params as jax_fuse_params
from recnext_tpu.models.registry import create_model as jax_create_model
from recnext_tpu_torch import export as texport
from recnext_tpu_torch.convert import jax_to_torch, torch_to_jax
from recnext_tpu_torch.models.mixers import LinearAttention, RecConv2dMixer
from recnext_tpu_torch.models.registry import create_model

ATOL, RTOL = 2e-4, 1e-4  # tests/test_torch_models.py's bounds for the fused model
REPO = Path(__file__).resolve().parents[1]
NAMES = ["recnext_m0", "recnext_a0"]


def _variables(name):
    """The JAX variables of a full-width model whose BatchNorms hold the statistics of
    one random batch (and a perturbed affine), so that the logits are of order 1 and
    the fold is exercised: the port's seeded init calibrated in train mode, carried
    to the JAX layout by ``torch_to_jax``."""
    gen = torch.Generator().manual_seed(1)
    model = create_model(name, device="cpu", generator=gen)
    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, torch.nn.modules.batchnorm._BatchNorm):
                bn.weight.add_(0.1 * torch.randn(bn.num_features, generator=gen))
                bn.bias.add_(0.1 * torch.randn(bn.num_features, generator=gen))
                bn.reset_running_stats()
                bn.momentum = None  # cumulative: the running statistics are this batch's
        model.train()(torch.randn(4, 3, 224, 224, generator=gen))
    return torch_to_jax(model.state_dict())


@pytest.fixture(scope="module", params=NAMES)
def exported(request, tmp_path_factory):
    """(name, JAX variables, the CLI's output dir, the --to-torch file, the image and
    the JAX fused logits on it) after one run of the CLI."""
    name = request.param
    tmp = tmp_path_factory.mktemp(name)
    v = _variables(name)
    torch.save(jax_to_torch(v), tmp / "raw.pth")
    out = tmp / "published"
    texport.main(["--model", name, "--torch-ckpt", str(tmp / "raw.pth"), "--out", str(out),
                  "--batch", "2", "--torch-export", "--device", "cpu", "--dtype", "float32",
                  "--sha-stamp", "--to-torch", str(tmp / "fused.pth")])
    x = np.random.default_rng(5).normal(size=(2, 224, 224, 3)).astype(np.float32)
    jfused = jax_create_model(name, fused=True)
    want = np.asarray(jax.jit(jfused.apply)(jax_fuse_params(v), jnp.asarray(x)))
    return name, v, out, tmp / "fused.pth", x, want


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_exported_program_matches_the_jax_fused_forward(exported):
    name, _, out, _, x, want = exported
    program = texport.load_program(str(out / f"{name}_b2.pt2"))
    with torch.no_grad():
        got = program(_nchw(x)).numpy()
    assert got.shape == (2, 1000)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_exported_graph_holds_one_custom_op_node_per_mixer(exported):
    name, _, out, *_ = exported
    program = torch.export.load(str(out / f"{name}_b2.pt2"))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"
               and "recnext" in str(n.target)]
    op = "rec_conv2d" if name == "recnext_m0" else "linear_attention_nchw"
    mixers = sum(isinstance(m, (RecConv2dMixer, LinearAttention))
                 for m in create_model(name, fused=True, device="cpu").modules())
    assert set(targets) == {f"recnext.{op}.default"} and len(targets) == mixers


def test_to_torch_is_the_jax_export_bit_for_bit(exported):
    name, v, _, fused_pth, *_ = exported
    got = torch.load(fused_pth, weights_only=True)
    want = flax_fused_to_torch(jax_fuse_params(v), family=name[len("recnext_")])
    assert set(got) == set(want)
    for k, w in want.items():
        assert np.array_equal(got[k].numpy(), np.asarray(w)), k


def test_sha_stamp_names_the_archive_and_records_its_digest(exported):
    name, _, out, *_ = exported
    stamped = list(out.glob(f"{name}_fused-*.pt"))
    assert len(stamped) == 1 and not (out / f"{name}_fused.pt").exists()
    meta = json.loads((out / f"{name}_meta.json").read_text())
    assert meta["artifact"] == stamped[0].name
    assert stamped[0].name == f"{name}_fused-{meta['sha256'][:8]}.pt"
    assert texport.resolve_published_path(name, str(out)) == stamped[0]


def test_program_loads_in_a_fresh_process(exported, tmp_path):
    name, _, out, _, x, _ = exported
    torch.save(_nchw(x), tmp_path / "x.pt")
    code = textwrap.dedent(f"""
        import torch
        import recnext_tpu_torch.ops  # registers recnext::*
        program = torch.export.load({str(out / f'{name}_b2.pt2')!r}).module()
        with torch.no_grad():
            torch.save(program(torch.load({str(tmp_path / 'x.pt')!r})), {str(tmp_path / 'y.pt')!r})
    """)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)
    in_process = texport.load_program(str(out / f"{name}_b2.pt2"))
    with torch.no_grad():
        assert torch.equal(torch.load(tmp_path / "y.pt"), in_process(_nchw(x)))


def test_mlla_without_an_artifact_flag_and_stablehlo_raise(tmp_path):
    with pytest.raises(SystemExit, match="no fused published artifact"):
        texport.main(["--model", "mlla_nano_recconv", "--out", str(tmp_path)])
    with pytest.raises(SystemExit, match="--torch-export"):
        texport.main(["--model", "recnext_m0", "--stablehlo", "--out", str(tmp_path)])

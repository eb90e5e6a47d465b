"""The RecConv2d CUDA kernel against its plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU with nvcc (the kernel is built at first use)
and skips without one. On the card: python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from recnext_tpu_torch.models.registry import create_model
from recnext_tpu_torch.ops.recconv import rec_conv2d, rec_conv2d_fused

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the plain version's convs in full fp32
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = prev


def _inputs(n, c, h, w, level, k=5, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, c, h, w, generator=g)
    ws = [torch.randn(c, 1, k, k, generator=g) for _ in range(level + 2)]
    return x.to("cuda", dtype), [t.to("cuda", dtype) for t in ws]


# tests/test_pallas.py:12's shapes, odd planes, k 3 and 7, a 96^2 plane (> 48 KB)
@pytest.mark.parametrize("n,c,h,w,level,k", [
    (4, 192, 14, 14, 2, 5), (4, 32, 15, 15, 2, 5), (4, 64, 7, 7, 1, 5),
    (4, 48, 28, 28, 3, 5), (2, 16, 13, 9, 4, 5), (2, 8, 20, 20, 2, 3),
    (2, 8, 20, 20, 2, 7), (2, 4, 96, 96, 4, 5)])
def test_kernel_matches_plain_f32(cuda, n, c, h, w, level, k):
    x, ws = _inputs(n, c, h, w, level, k)
    want = rec_conv2d(x, ws[0], ws[1:], level=level)
    before = rec_conv2d_fused.launches
    got = rec_conv2d_fused(x, ws[0], ws[1:], level=level)
    torch.cuda.synchronize()
    assert rec_conv2d_fused.launches == before + 1
    atol = 2e-5 * want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=atol)


def test_kernel_matches_plain_bf16(cuda):
    x, ws = _inputs(8, 48, 56, 56, 4, dtype=torch.bfloat16)
    got = rec_conv2d_fused(x, ws[0], ws[1:], level=4).float()
    # the plain version in f32 on the same bf16 values; the kernel rounds only its output
    want = rec_conv2d(x.float(), ws[0].float(), [t.float() for t in ws[1:]], level=4)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-2 * want.abs().max().item())


def test_kernel_rejects_what_it_does_not_take(cuda):
    x, ws = _inputs(1, 4, 14, 14, 2)
    bias = torch.zeros(4, device="cuda")
    with pytest.raises(ValueError, match="bias"):
        rec_conv2d_fused(x, ws[0], ws[1:], bias, level=2)
    with pytest.raises(ValueError, match="bilinear"):
        rec_conv2d_fused(x, ws[0], ws[1:], level=2, mode="nearest")
    with pytest.raises(ValueError, match="dtype"):
        rec_conv2d_fused(x.half(), ws[0].half(), [t.half() for t in ws[1:]], level=2)
    with pytest.raises(ValueError, match="contiguous"):
        rec_conv2d_fused(x.transpose(2, 3), ws[0], ws[1:], level=2)
    big, bws = _inputs(1, 1, 400, 400, 1)
    with pytest.raises(ValueError, match="shared memory"):
        rec_conv2d_fused(big, bws[0], bws[1:], level=1)


def test_model_kernel_path_matches_plain_path(cuda):
    model = create_model("recnext_m0", device="cuda", embed_dim=(16, 32, 64, 128),
                         depth=(1, 1, 2, 1), num_classes=11)
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1)).cuda()
    mixers = [m for m in model.modules() if hasattr(m, "forward_plain")]
    with torch.inference_mode():
        before = rec_conv2d_fused.launches
        got = model(x)
        assert rec_conv2d_fused.launches == before + len(mixers) == before + 5
        for m in mixers:
            m.forward = m.forward_plain
        want = model(x)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                               atol=1e-4 * want.abs().max().item())

"""The CUDA kernels (RecConv2d, linear attention) against their plain PyTorch
versions, on the card.

Every test here needs an NVIDIA GPU with nvcc (the kernels are built at first use)
and skips without one. On the card: python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from recnext_tpu_torch.models.registry import create_model
from recnext_tpu_torch.ops.attention import (
    linear_attention_backward,
    linear_attention_backward_plain,
    linear_attention_fused,
    linear_attention_kv_first,
    linear_attention_nchw,
    linear_attention_nchw_backward,
    linear_attention_nchw_plain,
)
from recnext_tpu_torch.models.mixers import LinearAttention, RecConv2dMixer
from recnext_tpu_torch.ops.cuda import linear_attention_bwd as attention_bwd_cuda
from recnext_tpu_torch.ops.cuda import recconv_bwd as recconv_bwd_cuda
from recnext_tpu_torch.ops.recconv import (
    rec_conv2d,
    rec_conv2d_backward,
    rec_conv2d_backward_plain,
    rec_conv2d_fused,
    rec_conv2d_level,
    rec_conv2d_level_dgrad,
    rec_conv2d_level_dgrad_plain,
    rec_conv2d_level_plain,
    rec_conv2d_level_wgrad,
    rec_conv2d_level_wgrad_plain,
    rec_conv2d_up_adjoint,
    rec_conv2d_up_adjoint_plain,
)
from recnext_tpu_torch.train.step import compute_params, forward_model

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


# tests/test_pallas.py:12's shapes, odd planes, k 3 and 7, a 96^2 plane (> 48 KB);
# N*C not a multiple of the planes per block (the last block is ragged); a
# non-square plane at each team size (8, 16, 32, 64, 128, 256 threads; ops/cuda/
# recconv.py:launch_config), with odd and even widths (staged and direct stores);
# levels 1-4 at k 3 and 7
@pytest.mark.parametrize("n,c,h,w,level,k", [
    (4, 192, 14, 14, 2, 5), (4, 32, 15, 15, 2, 5), (4, 64, 7, 7, 1, 5),
    (4, 48, 28, 28, 3, 5), (2, 16, 13, 9, 4, 5), (2, 8, 20, 20, 2, 3),
    (2, 8, 20, 20, 2, 7), (2, 4, 96, 96, 4, 5),
    (3, 5, 7, 7, 1, 5), (1, 13, 14, 14, 2, 5),
    (2, 11, 9, 14, 2, 5), (2, 3, 1, 65, 4, 7), (2, 6, 20, 23, 3, 5), (1, 3, 91, 11, 4, 7),
    (1, 5, 27, 30, 3, 5), (1, 3, 45, 47, 2, 3), (1, 2, 60, 75, 2, 5),
    (2, 6, 17, 17, 1, 3), (2, 6, 17, 17, 3, 3), (2, 6, 17, 17, 4, 3),
    (2, 6, 17, 17, 1, 7), (2, 6, 17, 17, 3, 7), (2, 6, 17, 17, 4, 7)])
def test_kernel_matches_plain_f32(cuda, n, c, h, w, level, k):
    x, ws = _inputs(n, c, h, w, level, k)
    want = rec_conv2d(x, ws[0], ws[1:], level=level)
    before = rec_conv2d_fused.launches
    got = rec_conv2d_fused(x, ws[0], ws[1:], level=level)
    torch.cuda.synchronize()
    assert rec_conv2d_fused.launches == before + 1
    atol = 2e-5 * want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=atol)


# one shape per team size that bf16 planes take: 128, 32, 32, 8, 256 and 16 threads
@pytest.mark.parametrize("n,c,h,w,level,k", [
    (8, 48, 56, 56, 4, 5), (8, 96, 28, 28, 3, 5), (4, 10, 20, 23, 3, 5),
    (8, 192, 14, 14, 2, 5), (2, 4, 96, 96, 4, 5), (2, 3, 1, 65, 4, 7)])
def test_kernel_matches_plain_bf16(cuda, n, c, h, w, level, k):
    x, ws = _inputs(n, c, h, w, level, k, dtype=torch.bfloat16)
    got = rec_conv2d_fused(x, ws[0], ws[1:], level=level).float()
    # the plain version in f32 on the same bf16 values; the kernel rounds only its output
    want = rec_conv2d(x.float(), ws[0].float(), [t.float() for t in ws[1:]], level=level)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-2 * want.abs().max().item())


# m1's four planes, odd and non-square pyramids, k 3 and 7, in both dtypes
@pytest.mark.parametrize("n,c,h,w,level,k", [
    (4, 48, 56, 56, 4, 5), (4, 96, 28, 28, 3, 5), (4, 192, 14, 14, 2, 5), (4, 64, 7, 7, 1, 5),
    (4, 32, 15, 15, 2, 5), (2, 16, 13, 9, 4, 5), (2, 6, 20, 23, 3, 3), (1, 3, 91, 11, 4, 7)])
def test_kernel_nearest_matches_plain(cuda, n, c, h, w, level, k):
    x, ws = _inputs(n, c, h, w, level, k)
    want = rec_conv2d(x, ws[0], ws[1:], level=level, mode="nearest")
    before = rec_conv2d_fused.launches
    got = rec_conv2d_fused(x, ws[0], ws[1:], level=level, mode="nearest")
    torch.cuda.synchronize()
    assert rec_conv2d_fused.launches == before + 1
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5 * want.abs().max().item())
    xb, wsb = x.bfloat16(), [t.bfloat16() for t in ws]
    got16 = rec_conv2d_fused(xb, wsb[0], wsb[1:], level=level, mode="nearest").float()
    want16 = rec_conv2d(xb.float(), wsb[0].float(), [t.float() for t in wsb[1:]],
                        level=level, mode="nearest")
    torch.testing.assert_close(got16, want16, rtol=0, atol=1e-2 * want16.abs().max().item())


# planes too large for the kernel's shared memory: 640^2's stage-0 plane (1 level
# peeled), COCO's stage-0 plane (2), a level-1 plane whose peel leaves the coarsest
# conv; each peeled level is two level-kernel launches (three where the peel leaves
# the coarsest conv), and the pyramid kernel takes the rest
@pytest.mark.parametrize("n,c,h,w,level,mode,peel,launches,level_launches", [
    (2, 4, 160, 160, 4, "bilinear", 1, 1, 2), (1, 3, 200, 334, 4, "nearest", 2, 1, 4),
    (1, 2, 400, 400, 1, "bilinear", 1, 0, 3)])
def test_large_plane_peels_levels(cuda, n, c, h, w, level, mode, peel, launches,
                                  level_launches):
    from recnext_tpu_torch.ops.cuda.recconv import levels_to_peel

    assert levels_to_peel(h, w, level, 5, 4) == peel
    x, ws = _inputs(n, c, h, w, level)
    want = rec_conv2d(x, ws[0], ws[1:], level=level, mode=mode)
    before = rec_conv2d_fused.launches, rec_conv2d_level.launches, rec_conv2d_fused.peeled
    got = rec_conv2d_fused(x, ws[0], ws[1:], level=level, mode=mode)
    torch.cuda.synchronize()
    assert (rec_conv2d_fused.launches, rec_conv2d_level.launches, rec_conv2d_fused.peeled) == (
        before[0] + launches, before[1] + level_launches, before[2] + 1)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5 * want.abs().max().item())
    # bf16: fp32 inside, one rounding at the end, as for planes the kernel takes whole
    xb, wsb = x.bfloat16(), [t.bfloat16() for t in ws]
    got16 = rec_conv2d_fused(xb, wsb[0], wsb[1:], level=level, mode=mode).float()
    want16 = rec_conv2d(xb.float(), wsb[0].float(), [t.float() for t in wsb[1:]],
                        level=level, mode=mode)
    torch.testing.assert_close(got16, want16, rtol=0, atol=1e-2 * want16.abs().max().item())


# the level kernel alone: the down conv (f32 out), the upsample-add-conv (out in x's
# dtype) and the plain conv; planes of one and of many 32 x 32 tiles, odd sizes
@pytest.mark.parametrize("shape,k,stride,mode,dtype", [
    ((2, 3, 37, 29), 5, 2, None, torch.float32), ((2, 3, 70, 45), 7, 2, None, torch.bfloat16),
    ((1, 4, 9, 200), 3, 2, None, torch.float32),
    ((2, 3, 37, 29), 5, 1, "bilinear", torch.float32),
    ((2, 3, 70, 45), 3, 1, "nearest", torch.float32),
    ((1, 4, 65, 64), 7, 1, "bilinear", torch.bfloat16),
    ((2, 3, 33, 100), 5, 1, "nearest", torch.bfloat16),
    ((2, 3, 70, 45), 5, 1, None, torch.float32)])
def test_level_kernel_matches_plain(cuda, shape, k, stride, mode, dtype):
    g = torch.Generator().manual_seed(k + stride)
    n, c, h, w = shape
    x = torch.randn(*shape, generator=g).to("cuda", dtype)
    wt = torch.randn(c, 1, k, k, generator=g).cuda()
    up = (torch.randn(n, c, (h + 1) // 2, (w + 1) // 2, generator=g).cuda()
          if mode else None)
    kw = dict(stride=stride, up=up, mode=mode or "bilinear")
    before = rec_conv2d_level.launches
    got = rec_conv2d_level(x, wt, **kw)
    torch.cuda.synchronize()
    assert rec_conv2d_level.launches == before + 1
    assert got.dtype == (torch.float32 if stride == 2 else dtype)
    want = rec_conv2d_level_plain(x.float(), wt, **kw)  # in fp32: before rounding
    scale = want.abs().max().item()
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5 * scale)
    else:
        torch.testing.assert_close(got.float(), want, rtol=0, atol=1e-2 * scale)


def test_level_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.randn(1, 4, 20, 20, device="cuda")
    wt = torch.randn(4, 1, 5, 5, device="cuda")
    up = torch.randn(1, 4, 10, 10, device="cuda")
    with pytest.raises(ValueError, match="weights"):
        rec_conv2d_level(x, wt.bfloat16())
    with pytest.raises(ValueError, match="stride"):
        rec_conv2d_level(x, wt, stride=3)
    with pytest.raises(ValueError, match="up must be"):
        rec_conv2d_level(x, wt, stride=2, up=up)
    with pytest.raises(ValueError, match="up must be"):
        rec_conv2d_level(x, wt, up=up[..., :9])
    with pytest.raises(ValueError, match="mode"):
        rec_conv2d_level(x, wt, up=up, mode="bicubic")


def test_kernel_rejects_what_it_does_not_take(cuda):
    x, ws = _inputs(1, 4, 14, 14, 2)
    bias = torch.zeros(4, device="cuda")
    with pytest.raises(ValueError, match="bias"):
        rec_conv2d_fused(x, ws[0], ws[1:], bias, level=2)
    with pytest.raises(ValueError, match="bilinear or nearest"):
        rec_conv2d_fused(x, ws[0], ws[1:], level=2, mode="bicubic")
    with pytest.raises(ValueError, match="dtype"):
        rec_conv2d_fused(x.half(), ws[0].half(), [t.half() for t in ws[1:]], level=2)
    with pytest.raises(ValueError, match="contiguous"):
        rec_conv2d_fused(x.transpose(2, 3), ws[0], ws[1:], level=2)
    # under grad the call goes through the backward kernel's Function, which takes a
    # plane too large for the backward's shared memory: its backward peels one level
    big, bws = _inputs(1, 2, 160, 160, 4)
    peeled = rec_conv2d_backward.peeled
    out = rec_conv2d_fused(big.requires_grad_(), bws[0], bws[1:], level=4)
    out.float().sum().backward()
    assert rec_conv2d_backward.peeled == peeled + 1 and big.grad.shape == big.shape


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


def _positive(shape, g):
    # elu(x)+1 features are positive, as tests/test_pallas.py draws q and k
    return torch.randn(*shape, generator=g).abs() + 0.1


# tests/test_pallas.py:29-34's shapes (odd n, odd d, dv != d) and a1's stage-0 head
@pytest.mark.parametrize("bh,n,d,dv", [(2, 16, 32, 32), (4, 64, 64, 64), (2, 49, 20, 20),
                                       (2, 196, 20, 40), (8, 784, 24, 24)])
def test_attention_kernel_matches_plain(cuda, bh, n, d, dv):
    g = torch.Generator().manual_seed(2)
    q, k = _positive((bh, n, d), g).cuda(), _positive((bh, n, d), g).cuda()
    v = torch.randn(bh, n, dv, generator=g).cuda()
    want = linear_attention_kv_first(q, k, v)
    before = linear_attention_fused.launches
    got = linear_attention_fused(q, k, v)
    torch.cuda.synchronize()
    assert linear_attention_fused.launches == before + 1
    # tests/test_pallas.py:44's bound
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    # bf16: against the plain version in f32 on the same bf16 values
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got16 = linear_attention_fused(qb, kb, vb)
    assert got16.dtype == torch.bfloat16
    want16 = linear_attention_kv_first(qb.float(), kb.float(), vb.float())
    torch.testing.assert_close(got16.float(), want16, rtol=0,
                               atol=1e-2 * want16.abs().max().item())


@pytest.mark.parametrize("variant", [1, 2])
def test_attention_nchw_entry_reads_noncontiguous_halves(cuda, variant):
    g = torch.Generator().manual_seed(3)
    qk = _positive((2, 2 * 32, 7, 7), g).cuda()  # its q and k halves are not contiguous
    v = torch.randn(2, 48, 7, 7, generator=g).cuda()[:, 8:40]  # nor is this slice
    assert not qk[:, :32].is_contiguous() and not v.is_contiguous()
    before = linear_attention_fused.launches
    got = linear_attention_nchw(qk, v, 4, variant=variant)
    torch.cuda.synchronize()
    assert linear_attention_fused.launches == before + 1 and got.is_contiguous()
    want = linear_attention_nchw_plain(qk, v, 4, variant=variant)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


# one shape per team size that ops/cuda/linear_attention.py:launch_config chooses
# (16, 32, 128, 256 threads a head), D != DV, several tiles a head (784, 3000, 4096
# positions), D = DV = 128; in both layouts
@pytest.mark.parametrize("layout", ["n", "d"])
@pytest.mark.parametrize("b,nh,h,w,d,dv,team,tiles", [
    (3, 2, 3, 3, 24, 24, 16, 1), (2, 3, 7, 7, 24, 40, 32, 1), (2, 2, 14, 14, 20, 20, 128, 1),
    (2, 2, 28, 28, 24, 24, 128, 6), (1, 2, 50, 60, 24, 40, 256, 29),
    (1, 1, 64, 64, 128, 128, 256, 52)])
def test_attention_kernel_at_every_team_size(cuda, layout, b, nh, h, w, d, dv, team, tiles):
    from recnext_tpu_torch.ops.cuda.linear_attention import launch_config

    cfg = launch_config(h * w, d, dv, 4, layout)
    assert (cfg.team, cfg.tiles > 1) == (team, tiles > 1)
    g = torch.Generator().manual_seed(team)
    qk = _positive((b, 2 * nh * d, h, w), g).cuda()
    v = torch.randn(b, nh * dv, h, w, generator=g).cuda()

    def run(qk, v, kernel):
        if layout == "n":
            return (linear_attention_nchw if kernel else linear_attention_nchw_plain)(qk, v, nh)
        q, k, vv = (x.reshape(b * nh, x.shape[1] // nh, h * w).transpose(1, 2).contiguous()
                    for x in (qk[:, : nh * d], qk[:, nh * d:], v))
        return (linear_attention_fused if kernel else linear_attention_kv_first)(q, k, vv)

    before = linear_attention_fused.launches
    got = run(qk, v, True)
    torch.cuda.synchronize()
    assert linear_attention_fused.launches == before + 1
    torch.testing.assert_close(got, run(qk, v, False), rtol=1e-3, atol=1e-3)
    got16 = run(qk.bfloat16(), v.bfloat16(), True).float()
    want16 = run(qk.bfloat16().float(), v.bfloat16().float(), False)
    torch.testing.assert_close(got16, want16, rtol=0, atol=1e-2 * want16.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [1, 3, 7])
def test_attention_kernel_reads_misaligned_heads(cuda, shift, dtype):
    """Heads that start `shift` elements (the BH entry) or planes (the NCHW entry)
    past a tensor's start: off 16-byte alignment with 49 positions."""
    g = torch.Generator().manual_seed(shift)
    qk = _positive((2, shift + 2 * 3 * 24, 7, 7), g).to("cuda", dtype)[:, shift:]
    v = torch.randn(2, shift + 3 * 40, 7, 7, generator=g).to("cuda", dtype)[:, shift:]
    want = linear_attention_nchw_plain(qk.float(), v.float(), 3)
    tol = dict(rtol=1e-3, atol=1e-3) if dtype == torch.float32 else dict(
        rtol=0, atol=1e-2 * want.abs().max().item())
    torch.testing.assert_close(linear_attention_nchw(qk, v, 3).float(), want, **tol)

    def heads(x):  # (B*nh, N, D), each head `shift` elements past 16-byte alignment
        rows = x.reshape(6, x.shape[1] // 3, 49).transpose(1, 2)
        flat = torch.empty(shift + rows.numel(), dtype=dtype, device="cuda")
        return flat[shift:].view(rows.shape).copy_(rows)

    q, k, vv = heads(qk[:, :72]), heads(qk[:, 72:]), heads(v)
    want_bh = linear_attention_kv_first(q.float(), k.float(), vv.float())
    torch.testing.assert_close(linear_attention_fused(q, k, vv).float(), want_bh, **tol)


def test_attention_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.rand(2, 16, 8, device="cuda") + 0.1
    with pytest.raises(ValueError, match="dtype"):
        linear_attention_fused(q.half(), q.half(), q.half())
    big = torch.rand(2, 16, 129, device="cuda")
    with pytest.raises(ValueError, match="D=129"):
        linear_attention_fused(big, big, q)
    with pytest.raises(ValueError, match="CUDA"):
        linear_attention_fused(q, q.cpu(), q)
    qk = torch.rand(1, 16, 4, 4, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        linear_attention_nchw(qk.transpose(2, 3), qk[:, :8].transpose(2, 3), 2)
    with pytest.raises(ValueError, match="contiguous"):  # a head's rows are not one span
        linear_attention_fused(q[:, ::2], q[:, ::2], q[:, ::2])
    # under grad the call is the Function's: one launch of K2, and of K2' backward
    before = (linear_attention_fused.launches, linear_attention_backward.launches)
    out = linear_attention_fused(q.detach().clone().requires_grad_(), q, q)
    assert type(out.grad_fn).__name__ == "LinearAttentionFunctionBackward"
    out.sum().backward()
    assert (linear_attention_fused.launches, linear_attention_backward.launches) == (
        before[0] + 1, before[1] + 1)


def test_nearest_model_runs_through_the_kernel(cuda):
    model = create_model("recnext_m0", device="cuda", embed_dim=(16, 32, 64, 128),
                         depth=(1, 1, 2, 1), num_classes=11, recconv_mode="nearest")
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1)).cuda()
    mixers = [m for m in model.modules() if hasattr(m, "forward_plain")]
    assert all(m.mode == "nearest" for m in mixers)
    with torch.inference_mode():
        before = rec_conv2d_fused.launches
        got = model(x)
        assert rec_conv2d_fused.launches == before + 5
        for m in mixers:
            m.forward = m.forward_plain
        want = model(x)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                               atol=1e-4 * want.abs().max().item())


def test_a_model_kernel_path_matches_plain_path(cuda):
    model = create_model("recnext_a0", device="cuda", embed_dim=(16, 32, 64, 128),
                         depth=(1, 1, 2, 1), num_classes=11)
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1)).cuda()
    mixers = [m for m in model.modules() if hasattr(m, "forward_plain")]
    with torch.inference_mode():
        before, before_k1 = linear_attention_fused.launches, rec_conv2d_fused.launches
        got = model(x)
        assert linear_attention_fused.launches == before + len(mixers) == before + 5
        assert rec_conv2d_fused.launches == before_k1
        for m in mixers:
            m.forward = m.forward_plain
        want = model(x)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                               atol=1e-4 * want.abs().max().item())


# recnext_m1's four mixer planes at 224^2: (channels, side, level)
M1_PLANES = [(48, 56, 4), (96, 28, 3), (192, 14, 2), (384, 7, 1)]


def _check_backward(x, ws, g, level, mode):
    """The backward kernel against its plain version on the same values (in f32):
    f32 dx within 2e-5 max|ref| and dW within 1e-4 max|ref| (a sum over N*H*W terms);
    bf16 within 1e-2 max|ref| (8 bits)."""
    got = rec_conv2d_backward(x, ws[0], ws[1:], g, level=level, mode=mode)
    want = rec_conv2d_backward_plain(x.float(), ws[0].float(), [t.float() for t in ws[1:]],
                                     g.float(), level=level, mode=mode)
    torch.cuda.synchronize()
    assert got[0].dtype == x.dtype and all(t.dtype == torch.float32 for t in got[2])
    f32 = x.dtype == torch.float32
    for name, a, b, tol in (("dx", got[0], want[0], 2e-5 if f32 else 1e-2),
                            *((f"dW[{i}]", a, b, 1e-4 if f32 else 1e-2) for i, (a, b) in
                              enumerate(zip([got[1], *got[2]], [want[1], *want[2]])))):
        scale = b.abs().max().item()
        err = (a.float() - b).abs().max().item()
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,side,level", M1_PLANES)
def test_backward_kernel_matches_plain(cuda, c, side, level, dtype, mode):
    x, ws = _inputs(4, c, side, side, level, dtype=dtype, seed=level)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(9)).to("cuda", dtype)
    before = rec_conv2d_backward.launches
    _check_backward(x, [t / 5 for t in ws], g, level, mode)
    assert rec_conv2d_backward.launches == before + 1


# odd and non-square planes, k 3 and 7, and the 96^2 plane of a 384^2 input
@pytest.mark.parametrize("n,c,h,w,level,k", [
    (2, 5, 15, 13, 2, 5), (3, 3, 13, 9, 4, 3), (2, 4, 20, 23, 3, 7), (1, 2, 96, 96, 4, 5),
    (2, 3, 1, 9, 2, 5)])
def test_backward_kernel_at_odd_shapes(cuda, n, c, h, w, level, k):
    x, ws = _inputs(n, c, h, w, level, k=k, seed=k)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(3)).cuda()
    _check_backward(x, [t / k for t in ws], g, level, "bilinear")


# k 3 and 7 at m1's planes, batches that leave the last group of a block's teams
# ragged (n = 3, 5, 17), 15^2 and the 96^2 plane of a 384^2 input at level 4
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,h,w,level,k", [
    (3, 192, 14, 14, 2, 3), (3, 192, 14, 14, 2, 7), (3, 48, 56, 56, 4, 3),
    (3, 48, 56, 56, 4, 7), (5, 384, 7, 7, 1, 7), (17, 96, 28, 28, 3, 3),
    (3, 8, 15, 15, 4, 5), (3, 4, 96, 96, 4, 5)])
def test_backward_kernel_at_kernel_sizes_and_ragged_batches(cuda, n, c, h, w, level, k, dtype):
    x, ws = _inputs(n, c, h, w, level, k=k, dtype=dtype, seed=n + k)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(5)).to("cuda", dtype)
    _check_backward(x, [t / k for t in ws], g, level, "bilinear")


@pytest.mark.parametrize("c,side,level", M1_PLANES)
def test_backward_kernel_gives_the_same_bits_on_every_run(cuda, c, side, level):
    x, ws = _inputs(9, c, side, side, level, dtype=torch.bfloat16, seed=1)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(2)).to("cuda",
                                                                             torch.bfloat16)
    first = rec_conv2d_backward(x, ws[0], ws[1:], g, level=level)
    for _ in range(2):
        again = rec_conv2d_backward(x, ws[0], ws[1:], g, level=level)
        for a, b in zip([first[0], first[1], *first[2]], [again[0], again[1], *again[2]]):
            assert torch.equal(a, b)


def test_backward_refuses_a_plane_too_large_for_shared_memory(cuda):
    """The kernel's layout refuses the 160^2 plane at level 4; the backward peels one
    level before any launch and gives K1' the 80^2 plane at level 3."""
    x, ws = _inputs(1, 2, 160, 160, 4)
    with pytest.raises(ValueError, match="levels_to_peel_backward"):
        recconv_bwd_cuda.launch_config(160, 160, 4, 5)
    before = (rec_conv2d_backward.launches, rec_conv2d_backward.peeled)
    _check_backward(x, [t / 5 for t in ws], x, 4, "bilinear")
    assert (rec_conv2d_backward.launches, rec_conv2d_backward.peeled) == (before[0] + 1,
                                                                          before[1] + 1)


LEVEL_BWD_COUNTS = (rec_conv2d_level_dgrad, rec_conv2d_level_wgrad, rec_conv2d_up_adjoint)


# the peeled route at the shapes it exists for (a 512^2 input's stage 0, COCO's
# 200x334), odd planes, k 3 and 7, and peel counts 1 and 2: (n, c, h, w, level, k,
# peel, K1' launches, dgrad, wgrad and up-adjoint launches)
PEELED_CASES = [(2, 4, 128, 128, 4, 5, 1, 1, 2, 2, 1), (1, 3, 200, 334, 4, 5, 2, 1, 4, 4, 2),
                (2, 3, 151, 129, 4, 3, 1, 1, 2, 2, 1), (1, 2, 160, 160, 4, 7, 1, 1, 2, 2, 1)]


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,h,w,level,k,peel,bw,dg,wg,ua", PEELED_CASES)
def test_peeled_backward_matches_plain(cuda, n, c, h, w, level, k, peel, bw, dg, wg, ua,
                                       dtype, mode):
    assert recconv_bwd_cuda.levels_to_peel_backward(h, w, level, k) == peel
    x, ws = _inputs(n, c, h, w, level, k=k, dtype=dtype, seed=h)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(4)).to("cuda", dtype)
    before = [f.launches for f in (rec_conv2d_backward, *LEVEL_BWD_COUNTS)]
    _check_backward(x, [t / k for t in ws], g, level, mode)
    after = [f.launches for f in (rec_conv2d_backward, *LEVEL_BWD_COUNTS)]
    assert [a - b for a, b in zip(after, before)] == [bw, dg, wg, ua]


def test_peeled_backward_gives_the_same_bits_on_every_run(cuda):
    x, ws = _inputs(2, 4, 200, 334, 4, dtype=torch.bfloat16, seed=3)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(2)).to("cuda",
                                                                             torch.bfloat16)
    first = rec_conv2d_backward(x, ws[0], ws[1:], g, level=4)
    for _ in range(2):
        again = rec_conv2d_backward(x, ws[0], ws[1:], g, level=4)
        for a, b in zip([first[0], first[1], *first[2]], [again[0], again[1], *again[2]]):
            assert torch.equal(a, b)


def _level_close(got, want, tol):
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol * scale


# (h, w, k, stride, g dtype, out dtype): odd sizes, several tiles, k 3/5/7
@pytest.mark.parametrize("h,w,k,stride,gdt,odt", [
    (128, 128, 5, 1, torch.bfloat16, torch.float32), (128, 128, 5, 2, torch.float32,
                                                      torch.bfloat16),
    (200, 334, 5, 2, torch.float32, torch.float32), (33, 21, 3, 2, torch.float32,
                                                     torch.float32),
    (67, 45, 7, 1, torch.float32, torch.float32), (1, 9, 5, 2, torch.bfloat16,
                                                   torch.bfloat16)])
def test_level_dgrad_kernel_matches_plain(cuda, h, w, k, stride, gdt, odt):
    gen = torch.Generator().manual_seed(h + k)
    g = torch.randn(2, 3, -(-h // stride), -(-w // stride), generator=gen).to("cuda", gdt)
    wt = torch.randn(3, 1, k, k, generator=gen).cuda()
    add = torch.randn(2, 3, h, w, generator=gen).cuda() if stride == 2 else None
    before = rec_conv2d_level_dgrad.launches
    got = rec_conv2d_level_dgrad(g, wt, size=(h, w), stride=stride, add=add, out_dtype=odt)
    assert rec_conv2d_level_dgrad.launches == before + 1 and got.dtype == odt
    want = rec_conv2d_level_dgrad_plain(g, wt, size=(h, w), stride=stride, add=add)
    _level_close(got, want, 2e-5 if odt == torch.float32 and gdt == torch.float32 else 1e-2)


@pytest.mark.parametrize("h,w,k,stride,mode,xdt,gdt", [
    (128, 128, 5, 1, "bilinear", torch.bfloat16, torch.bfloat16),
    (128, 128, 5, 2, None, torch.bfloat16, torch.float32),
    (200, 334, 5, 1, "nearest", torch.float32, torch.float32),
    (100, 167, 5, 2, None, torch.float32, torch.float32),
    (33, 21, 3, 1, "bilinear", torch.float32, torch.float32),
    (67, 45, 7, 2, None, torch.float32, torch.bfloat16)])
def test_level_wgrad_kernel_matches_plain(cuda, h, w, k, stride, mode, xdt, gdt):
    gen = torch.Generator().manual_seed(h * k)
    x = torch.randn(2, 3, h, w, generator=gen).to("cuda", xdt)
    uh, uw = (h + 1) // 2, (w + 1) // 2
    up = torch.randn(2, 3, uh, uw, generator=gen).cuda() if mode else None
    oh, ow = (h, w) if stride == 1 else (uh, uw)
    g = torch.randn(2, 3, oh, ow, generator=gen).to("cuda", gdt)
    before = rec_conv2d_level_wgrad.launches
    got = rec_conv2d_level_wgrad(x, g, k=k, stride=stride, up=up, mode=mode or "bilinear")
    assert rec_conv2d_level_wgrad.launches == before + 1 and got.shape == (3, 1, k, k)
    want = rec_conv2d_level_wgrad_plain(x, g, k=k, stride=stride, up=up,
                                        mode=mode or "bilinear")
    _level_close(got, want, 1e-4)
    again = rec_conv2d_level_wgrad(x, g, k=k, stride=stride, up=up, mode=mode or "bilinear")
    assert torch.equal(got, again)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("h,w", [(128, 128), (200, 334), (33, 21), (1, 1)])
def test_up_adjoint_kernel_matches_plain(cuda, h, w, mode):
    dz = torch.randn(2, 3, h, w, generator=torch.Generator().manual_seed(h)).cuda()
    before = rec_conv2d_up_adjoint.launches
    got = rec_conv2d_up_adjoint(dz, mode=mode)
    assert rec_conv2d_up_adjoint.launches == before + 1
    _level_close(got, rec_conv2d_up_adjoint_plain(dz, mode=mode), 2e-5)


def test_level_backward_kernels_reject_what_they_do_not_take(cuda):
    g = torch.randn(1, 2, 8, 8, device="cuda")
    wt = torch.randn(2, 1, 5, 5, device="cuda")
    with pytest.raises(ValueError, match="stride-2 output"):
        rec_conv2d_level_dgrad(g, wt, size=(20, 20), stride=2)
    with pytest.raises(ValueError, match="contiguous NCHW"):
        rec_conv2d_level_dgrad(g.half(), wt, size=(16, 16), stride=2)
    with pytest.raises(ValueError, match="g must be"):
        rec_conv2d_level_wgrad(g, g, k=5, stride=2)
    g4 = g[..., :4, :4].contiguous()  # the stride-2 output of 8^2
    with pytest.raises(ValueError, match="up must be"):
        rec_conv2d_level_wgrad(g, g4, k=5, stride=2, up=g4)  # an up-step at stride 1 only
    with pytest.raises(ValueError, match="contiguous"):
        rec_conv2d_up_adjoint(g.half())


def test_mixer_under_grad_launches_k1_and_the_backward_kernel_once(cuda):
    """A bf16 forward of an fp32 mixer, as the train step runs it: one launch of each
    kernel, and the fp32 parameters' gradients those of the plain path."""
    torch.manual_seed(0)
    mixer = RecConv2dMixer(48, level=4).cuda()
    x = torch.randn(4, 48, 56, 56, device="cuda").bfloat16().requires_grad_()
    g = torch.randn(4, 48, 56, 56, device="cuda").bfloat16()
    k1, bw = rec_conv2d_fused.launches, rec_conv2d_backward.launches
    (forward_model(mixer, x, torch.bfloat16).float() * g.float()).sum().backward()
    assert (rec_conv2d_fused.launches, rec_conv2d_backward.launches) == (k1 + 1, bw + 1)
    got = [p.grad.clone() for p in mixer.parameters()] + [x.grad.float()]
    mixer.zero_grad()
    x.grad = None
    cast = compute_params(mixer, torch.bfloat16)
    plain = rec_conv2d(x, cast["down.weight"], [cast[f"convs.{i}.weight"] for i in range(5)],
                       level=4)
    (plain.float() * g.float()).sum().backward()
    want = [p.grad for p in mixer.parameters()] + [x.grad.float()]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert (a - b).abs().max().item() <= 2e-2 * b.abs().max().item()


# K2' (the linear-attention backward): tests/test_pallas.py:29-34's shapes; a1's four
# training head shapes (N 784, 196, 49, 16; D = DV = 24); DV != D (the L family's
# LA3: D 12, DV 24); D = DV = 128 (the tiled route, several tiles a head); N = 1; a
# cluster whose last block holds a shorter slice (780 = 7 * 98 + 94)
BWD_CASES = [(2, 16, 32, 32), (4, 64, 64, 64), (2, 49, 20, 20), (2, 196, 20, 40),
             (8, 784, 24, 24), (16, 196, 24, 24), (32, 49, 24, 24), (64, 16, 24, 24),
             (6, 49, 12, 24), (2, 784, 128, 128), (6, 1, 24, 40), (6, 780, 24, 24)]


def _bwd_inputs(bh, n, d, dv, seed, dtype):
    g = torch.Generator().manual_seed(seed)
    q, k = _positive((bh, n, d), g), _positive((bh, n, d), g)
    v, go = torch.randn(bh, n, dv, generator=g), torch.randn(bh, n, dv, generator=g)
    return [t.to("cuda", dtype) for t in (q, k, v, go)]


def _check_attention_backward(got, want, dtype):
    """Each of dq, dk, dv against the plain version in f32 on the same values: f32
    within 2e-5 max|ref| (as the RecConv2d backward's), bf16 within 1e-2 max|ref|. A
    gradient that is 0 in exact arithmetic (dq and dk at N = 1, where out = v) holds
    rounding noise on both sides: under 1e-5."""
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        a, b = a.float(), b.float()
        err, scale = (a - b).abs().max().item(), b.abs().max().item()
        if scale < 1e-5:
            assert a.abs().max().item() < 1e-5, name
        else:
            tol = 2e-5 if dtype == torch.float32 else 1e-2
            assert err <= tol * scale, (name, err, scale)


def _as_nchw(t, nh):
    """(B*nh, N, R) -> (B, nh*R, 1, N): the same heads as NCHW planes (n-fastest)."""
    bh, n, r = t.shape
    return t.transpose(1, 2).reshape(bh // nh, nh * r, 1, n).contiguous()


@pytest.mark.parametrize("layout", ["n", "d"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,n,d,dv", BWD_CASES)
def test_attention_backward_matches_plain(cuda, bh, n, d, dv, dtype, layout):
    q, k, v, go = _bwd_inputs(bh, n, d, dv, bh + n, dtype)
    want = linear_attention_backward_plain(*(t.float() for t in (q, k, v, go)))
    before = linear_attention_backward.launches
    if layout == "d":  # the (BH, N, D) entry
        got = linear_attention_backward(q, k, v, go)
    else:  # the NCHW entry: q and k the halves of one tensor, two heads a batch row
        nh = 2
        qk = torch.cat([_as_nchw(q, nh), _as_nchw(k, nh)], dim=1)
        dqk, dv_ = linear_attention_nchw_backward(qk, _as_nchw(v, nh), _as_nchw(go, nh), nh)
        def back(t, r):  # (B, nh*R, 1, N) -> (B*nh, N, R)
            return t.reshape(bh, r, n).transpose(1, 2)

        got = (back(dqk[:, : nh * d], d), back(dqk[:, nh * d:], d), back(dv_, dv))
    torch.cuda.synchronize()
    assert linear_attention_backward.launches == before + 1
    _check_attention_backward(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [1, 3])
def test_attention_backward_reads_misaligned_heads(cuda, shift, dtype):
    """Heads that start `shift` elements (the BH entry) or planes (the NCHW entry)
    past a tensor's start: off 16-byte alignment with 49 positions."""
    q, k, v, go = _bwd_inputs(6, 49, 24, 40, shift, dtype)
    want = linear_attention_backward_plain(*(t.float() for t in (q, k, v, go)))

    def shifted(t):
        flat = torch.empty(shift + t.numel(), dtype=t.dtype, device=t.device)
        return flat[shift:].view(t.shape).copy_(t)

    got = linear_attention_backward(*(shifted(t) for t in (q, k, v, go)))
    _check_attention_backward(got, want, dtype)
    qk = torch.cat([_as_nchw(q, 3), _as_nchw(k, 3)], dim=1)

    def planes(t):  # the same values in a tensor whose planes start `shift` later
        buf = torch.empty(t.shape[0], shift + t.shape[1], *t.shape[2:], dtype=t.dtype,
                          device=t.device)
        return buf[:, shift:].copy_(t)

    dqk, dv = linear_attention_nchw_backward(planes(qk), planes(_as_nchw(v, 3)),
                                             planes(_as_nchw(go, 3)), 3)
    torch.cuda.synchronize()
    back = lambda t, r: t.reshape(6, r, 49).transpose(1, 2)  # noqa: E731
    got = (back(dqk[:, :72], 24), back(dqk[:, 72:], 24), back(dv, 40))
    _check_attention_backward(got, want, dtype)


@pytest.mark.parametrize("variant", [1, 2])
def test_function_gradients_match_autograd_over_the_plain_version(cuda, variant):
    """LinearAttentionFunction: the NCHW entry's gradient of qk holds dq and dk in its
    two halves, and the (BH, N, D) entry's, each input's, against autograd over the
    plain version; where only v requires a gradient, the Function returns none for
    qk. One K2 and one K2' launch a call."""
    rng = np.random.default_rng(4)
    qk = torch.from_numpy(np.abs(rng.normal(size=(2, 2 * 3 * 8, 5, 6))).astype(np.float32) + .1)
    v = torch.from_numpy(rng.normal(size=(2, 3 * 10, 5, 6)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 3 * 10, 5, 6)).astype(np.float32))
    qk, v, g = qk.cuda().requires_grad_(), v.cuda().requires_grad_(), g.cuda()
    want = torch.autograd.grad(linear_attention_nchw_plain(qk, v, 3, variant=variant),
                               (qk, v), g)
    k2, bw = linear_attention_fused.launches, linear_attention_backward.launches
    out = linear_attention_nchw(qk, v, 3, variant=variant)
    assert type(out.grad_fn).__name__ == "LinearAttentionFunctionBackward"
    (dqk, dv) = torch.autograd.grad(out, (qk, v), g)
    (dv_only,) = torch.autograd.grad(linear_attention_nchw(qk.detach(), v, 3), (v,), g)
    torch.cuda.synchronize()
    assert (linear_attention_fused.launches, linear_attention_backward.launches) == (
        k2 + 2, bw + 2)
    _check_attention_backward((dqk[:, :24], dqk[:, 24:], dv),
                              (want[0][:, :24], want[0][:, 24:], want[1]), torch.float32)
    assert torch.equal(dv_only, dv)
    q, k = (np.abs(rng.normal(size=(4, 9, 6))) + .1 for _ in range(2))
    vv, gg = (rng.normal(size=(4, 9, 7)) for _ in range(2))
    ins = [torch.from_numpy(a.astype(np.float32)).cuda().requires_grad_() for a in (q, k, vv)]
    gg = torch.from_numpy(gg.astype(np.float32)).cuda()
    got = torch.autograd.grad(linear_attention_fused(*ins), ins, gg)
    want = torch.autograd.grad(linear_attention_kv_first(*ins), ins, gg)
    _check_attention_backward(got, want, torch.float32)


@pytest.mark.parametrize("layout", ["n", "d"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,n,d,dv", [(6, 780, 24, 24), (3, 49, 24, 24), (5, 16, 24, 24),
                                       (2, 196, 20, 40), (3, 100, 12, 24)])
def test_attention_backward_at_every_route(cuda, monkeypatch, bh, n, d, dv, dtype, layout):
    """Every configuration K2' takes at these heads (each packed team size, each
    cluster size, the tiled walk; ops/cuda/linear_attention_bwd.py:candidates), with
    head counts that leave a packed block or a cluster's last slice partly filled,
    through the (BH, N, D) entry ("d") or as NCHW planes of one batch row ("n"): one
    launch each, against the plain version."""
    q, k, v, go = _bwd_inputs(bh, n, d, dv, 3 * n + bh, dtype)
    want = linear_attention_backward_plain(*(t.float() for t in (q, k, v, go)))
    options = attention_bwd_cuda.candidates(n, d, dv, q.element_size(), layout)
    routes = {c.route for c in options.values()}
    assert "tiled" in routes and routes & {"packed", "cluster"}
    for label, cfg in options.items():
        monkeypatch.setattr(attention_bwd_cuda, "launch_config", lambda *a, cfg=cfg: cfg)
        attention_bwd_cuda._launch_args.cache_clear()
        before = linear_attention_backward.launches
        if layout == "d":
            got = linear_attention_backward(q, k, v, go)
        else:
            qk = torch.cat([_as_nchw(q, bh), _as_nchw(k, bh)], dim=1)
            dqk, dv_ = linear_attention_nchw_backward(qk, _as_nchw(v, bh), _as_nchw(go, bh), bh)
            back = lambda t, r: t.reshape(bh, r, n).transpose(1, 2)  # noqa: E731
            got = (back(dqk[:, : bh * d], d), back(dqk[:, bh * d:], d), back(dv_, dv))
        torch.cuda.synchronize()
        assert linear_attention_backward.launches == before + 1, label
        _check_attention_backward(got, want, dtype)
    monkeypatch.undo()
    attention_bwd_cuda._launch_args.cache_clear()


@pytest.mark.parametrize("n", [784, 196, 49, 16])
def test_attention_backward_holds_32_warps_an_sm_at_a1_shapes(cuda, n):
    """At a1's training heads the kernel keeps to its register budget and the
    runtime puts 4 blocks of 256 threads (32 warps) on an SM, as launch_config
    plans."""
    for dtype in (torch.float32, torch.bfloat16):
        cfg = attention_bwd_cuda.launch_config(n, 24, 24, dtype.itemsize, "n")
        attrs = attention_bwd_cuda.kernel_attributes(dtype, cfg.route)
        assert attrs["registers"] <= attention_bwd_cuda.REGISTERS
        assert attention_bwd_cuda.resident_blocks(cfg, dtype) * cfg.threads // 32 >= 32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,n", [(16, 784), (64, 196), (64, 49), (128, 16), (6, 780)])
def test_attention_backward_gives_the_same_bits_on_every_run(cuda, bh, n, dtype):
    q, k, v, go = _bwd_inputs(bh, n, 24, 24, 11, dtype)
    runs = [linear_attention_backward(q, k, v, go) for _ in range(3)]
    torch.cuda.synchronize()
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(run, runs[0]))


def test_attention_backward_refuses_what_it_does_not_take(cuda):
    before = linear_attention_backward.launches
    q = torch.rand(2, 16, 8, device="cuda") + 0.1
    with pytest.raises(ValueError, match="dtype"):
        linear_attention_backward(q.half(), q.half(), q.half(), q.half())
    big = torch.rand(2, 16, 129, device="cuda")
    with pytest.raises(ValueError, match="D=129"):
        linear_attention_backward(big, big, q, q)
    with pytest.raises(ValueError, match="DV=129"):
        linear_attention_backward(q, q, big, big)
    with pytest.raises(ValueError, match="CUDA"):
        linear_attention_backward(q, q.cpu(), q, q)
    with pytest.raises(ValueError, match="contiguous"):  # q n-fastest, k d-fastest
        linear_attention_backward(q.transpose(1, 2).contiguous().transpose(1, 2), q, q, q)
    with pytest.raises(ValueError, match="shapes"):
        linear_attention_backward(q, q[:, :8], q, q)
    assert linear_attention_backward.launches == before


@pytest.mark.parametrize("variant", [1, 2])
def test_linear_attention_under_grad_launches_k2_and_its_backward_once(cuda, variant):
    """A train-mode LinearAttention under autograd: one launch of K2 in the forward
    and one of K2' in the backward, nothing of the plain version; its input and
    parameter gradients those of the plain path (autograd over forward_plain)."""
    torch.manual_seed(variant)
    mixer = LinearAttention(48, 2, variant).cuda().train()
    x = torch.randn(4, 48, 28, 28, device="cuda", requires_grad=True)
    go = torch.randn(4, 48, 28, 28, device="cuda")
    k2, bw = linear_attention_fused.launches, linear_attention_backward.launches
    (mixer(x) * go).sum().backward()
    torch.cuda.synchronize()
    assert (linear_attention_fused.launches, linear_attention_backward.launches) == (
        k2 + 1, bw + 1)
    got = [p.grad.clone() for p in mixer.parameters()] + [x.grad.clone()]
    mixer.zero_grad()
    x.grad = None
    (mixer.forward_plain(x) * go).sum().backward()
    want = [p.grad for p in mixer.parameters()] + [x.grad]
    assert (linear_attention_fused.launches, linear_attention_backward.launches) == (
        k2 + 1, bw + 1)
    for a, b in zip(got, want):
        scale = b.abs().max().item()
        if scale < 1e-6:  # a shift that a train-mode BatchNorm follows: exact gradient 0
            assert a.abs().max().item() < 1e-5
            continue
        assert (a - b).abs().max().item() <= 1e-3 * scale


def test_pinned_batches_from_two_workers_train_two_m1_steps(cuda, tmp_path):
    """The data pipeline feeding the card: JPEGs through the reference recipe's train
    transform in 2 worker processes, pinned, copied with non_blocking, then 2 m1 train
    steps at 64^2: each step 23 K1 launches and 23 K1' calls, finite losses."""
    from recnext_tpu_torch import bench
    from recnext_tpu_torch.data.datasets import ImageFolder
    from recnext_tpu_torch.data.loader import train_loader
    from recnext_tpu_torch.data.transforms import TrainTransform
    from recnext_tpu_torch.train.optim import cosine_schedule, make_optimizer
    from recnext_tpu_torch.train.state import TrainState
    from recnext_tpu_torch.train.step import make_train_step

    bench.make_folder(tmp_path, 16, classes=4, w=120, h=90)
    loader = train_loader(ImageFolder(tmp_path), TrainTransform(64), batch_size=8, epoch=0,
                          workers=2, pin_memory=True)
    model = create_model("recnext_m1", device="cuda", num_classes=4,
                         generator=torch.Generator().manual_seed(0))
    state = TrainState.create(model, make_optimizer(model.named_parameters(),
                                                    cosine_schedule(1e-3, 10)))
    step = make_train_step(num_classes=4)
    losses = []
    for i, batch in enumerate(loader):
        if i == 2:
            break
        assert batch["image"].is_pinned() and batch["image"].shape == (8, 3, 64, 64)
        batch = {k: v.to("cuda", non_blocking=True) for k, v in batch.items()}
        k1, bw = rec_conv2d_fused.launches, rec_conv2d_backward.launches
        losses.append(step(state, batch, torch.Generator().manual_seed(i))["loss"].item())
        torch.cuda.synchronize()
        assert (rec_conv2d_fused.launches - k1, rec_conv2d_backward.launches - bw) == (23, 23)
    assert len(losses) == 2 and all(np.isfinite(losses)) and state.step == 2


# the L family's attention shapes at 224^2, one head per image: (side, D, DV, variant,
# channels of the tensor whose first DV are v; 0: v is a tensor of its own)
L_SHAPES = [(7, 32, 32, 2, 0), (4, 64, 64, 2, 0), (4, 64, 128, 2, 512), (14, 32, 32, 1, 0),
            (7, 64, 64, 2, 0), (4, 96, 96, 2, 0), (7, 32, 64, 2, 256)]


def _l_inputs(b, side, d, dv, vc, dtype, seed):
    """qk (B, 2D, H, W) and v (B, DV, H, W), v a channel slice of a (B, vc, H, W)
    tensor where vc (LA3), and g like v."""
    g = torch.Generator().manual_seed(seed)
    qk = _positive((b, 2 * d, side, side), g).to("cuda", dtype)
    v = torch.randn(b, vc or dv, side, side, generator=g).to("cuda", dtype)[:, :dv]
    go = torch.randn(b, dv, side, side, generator=g).to("cuda", dtype)
    return qk, v, go


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("side,d,dv,variant,vc", L_SHAPES)
def test_attention_kernel_at_l_shapes(cuda, side, d, dv, variant, vc, dtype):
    """K2 through the NCHW entry at each L shape, LA3's v a channel slice read in place
    (batch stride vc*H*W): one launch, f32 within 1e-3 + 1e-3 |ref|, bf16 within 1e-2
    max|ref| of the plain version in f32 on the same values."""
    qk, v, _ = _l_inputs(16, side, d, dv, vc, dtype, side + d)
    if vc:
        assert v.stride(0) == vc * side * side and not v.is_contiguous()
    want = linear_attention_nchw_plain(qk.float(), v.float(), 1, variant=variant)
    before = linear_attention_fused.launches
    got = linear_attention_nchw(qk, v, 1, variant=variant).float()
    torch.cuda.synchronize()
    assert linear_attention_fused.launches == before + 1
    if dtype == torch.float32:
        assert ((got - want).abs() <= 1e-3 + 1e-3 * want.abs()).all()
    else:
        assert (got - want).abs().max().item() <= 1e-2 * want.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("side,d,dv,variant,vc", L_SHAPES)
def test_attention_backward_at_l_shapes(cuda, side, d, dv, variant, vc, dtype):
    """K2' through the NCHW entry at each L shape, v a channel slice where LA3's is:
    one launch, each gradient at K2''s bounds, the same bits on a second run."""
    qk, v, go = _l_inputs(16, side, d, dv, vc, dtype, side + dv)
    rows = lambda t, r: t.reshape(16, r, side * side).transpose(1, 2)  # noqa: E731
    want = linear_attention_backward_plain(
        *(rows(t.float(), r) for t, r in ((qk[:, :d], d), (qk[:, d:], d), (v, dv), (go, dv))))
    before = linear_attention_backward.launches
    dqk, dv_ = linear_attention_nchw_backward(qk, v, go, 1)
    again = linear_attention_nchw_backward(qk, v, go, 1)
    torch.cuda.synchronize()
    assert linear_attention_backward.launches == before + 2
    assert torch.equal(dqk, again[0]) and torch.equal(dv_, again[1])
    _check_attention_backward((rows(dqk[:, :d], d), rows(dqk[:, d:], d), rows(dv_, dv)),
                              want, dtype)


def test_la3_under_grad_reads_the_slice_and_launches_k2_and_k2_once(cuda):
    """LinearAttention variant 3 on x[:, :split] (the L block's partial channels), under
    grad: one K2 and one K2' launch, gradients against autograd over the plain path.
    A conv bias before a train-mode BatchNorm has a gradient of 0 in exact arithmetic:
    rounding noise on both paths, held under 1e-5."""
    torch.manual_seed(0)
    mixer = LinearAttention(128, 2, 3, bias=True).cuda().train()
    x = torch.randn(4, 512, 4, 4, device="cuda", requires_grad=True)
    g = torch.randn(4, 128, 4, 4, device="cuda")
    k2, bw = linear_attention_fused.launches, linear_attention_backward.launches
    got = torch.autograd.grad(mixer(x[:, :128]), (x, *mixer.parameters()), g)
    torch.cuda.synchronize()
    assert (linear_attention_fused.launches - k2, linear_attention_backward.launches - bw) == (1, 1)
    want = torch.autograd.grad(mixer.forward_plain(x[:, :128]), (x, *mixer.parameters()), g)
    for a, b in zip(got, want):
        scale = b.abs().max().item()
        if scale < 1e-6:
            assert a.abs().max().item() < 1e-5
        else:
            assert (a - b).abs().max().item() <= 1e-4 * scale


@pytest.mark.parametrize("name,launches", [("recnext_t", 20), ("recnext_b", 30),
                                           ("recnext_t_share_channel", 18)])
def test_l_fused_model_launches_k2_once_an_attention(cuda, name, launches):
    """The fused L model at full width on the card: one K2 launch per attention (20,
    30, 18 a forward), no RecConv2d, logits equal to its plain path's. Its BatchNorms
    take the statistics of a random batch before fusion (at init the L family's
    residual branches grow the logits to ~1e14, past what kv-first sums hold in fp32)."""
    from recnext_tpu_torch.fusion import fuse_params

    gen = torch.Generator().manual_seed(0)
    unfused = create_model(name, device="cuda", generator=gen)
    for bn in unfused.modules():
        if isinstance(bn, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
            bn.reset_running_stats()
            bn.momentum = None  # cumulative: the statistics of the one batch
    with torch.no_grad():
        unfused.train()(torch.randn(16, 3, 224, 224, generator=gen).cuda())
    model = create_model(name, fused=True, device="cuda")
    model.load_state_dict(fuse_params(unfused.state_dict()), strict=True)
    x = torch.randn(2, 3, 224, 224, generator=torch.Generator().manual_seed(1)).cuda()
    mixers = [m for m in model.modules() if hasattr(m, "forward_plain")]
    with torch.inference_mode():
        before, before_k1 = linear_attention_fused.launches, rec_conv2d_fused.launches
        got = model(x)
        torch.cuda.synchronize()
        assert linear_attention_fused.launches - before == len(mixers) == launches
        assert rec_conv2d_fused.launches == before_k1
        for m in mixers:
            m.forward = m.forward_plain
        want = model(x)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                               atol=1e-4 * want.abs().max().item())


# the downstream tasks' shapes (recnext_m3 at batch 16, fp32): stage 0 at a 512^2 crop
# (128^2 x 64) and at the detection preset's 800^2 (200^2 x 64), level 4, one level
# peeled in K1′'s backward (and at 200^2 in K1's forward too)
TASK_PLANES = [(16, 64, 128, 128), (16, 64, 200, 200)]


@pytest.mark.parametrize("n,c,h,w", TASK_PLANES)
def test_peeled_backward_at_task_planes_matches_plain(cuda, n, c, h, w):
    """K1′'s peeled route at the task planes, fp32: one level peeled, one K1′ launch at
    the inner plane and 2/2/1 KL′1-3 launches, K1′'s bounds against the plain version."""
    assert recconv_bwd_cuda.levels_to_peel_backward(h, w, 4, 5) == 1
    x, ws = _inputs(n, c, h, w, 4, dtype=torch.float32, seed=h + 1)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(5)).cuda()
    before = [f.launches for f in (rec_conv2d_backward, *LEVEL_BWD_COUNTS)]
    _check_backward(x, [t / 5 for t in ws], g, 4, "bilinear")
    after = [f.launches for f in (rec_conv2d_backward, *LEVEL_BWD_COUNTS)]
    assert [a - b for a, b in zip(after, before)] == [1, 2, 2, 1]


@pytest.mark.parametrize("n,c,h,w", TASK_PLANES)
def test_level_backward_kernels_at_task_planes_match_plain(cuda, n, c, h, w):
    """KL′1-3 alone at the task planes' outer level, fp32, batch 16: the input gradient
    at stride 1 and 2 (2e-5), the weight gradient at stride 1 with z = x + up(y) and at
    stride 2 (1e-4: sums over N*H*W terms), the up-step's adjoint (2e-5)."""
    gen = torch.Generator().manual_seed(h)
    x, g = (torch.randn(n, c, h, w, generator=gen).cuda() for _ in range(2))
    uh, uw = (h + 1) // 2, (w + 1) // 2
    y, dd = (torch.randn(n, c, uh, uw, generator=gen).cuda() for _ in range(2))
    dz = torch.randn(n, c, h, w, generator=gen).cuda()
    wl, wd = (torch.randn(c, 1, 5, 5, generator=gen).cuda() / 5 for _ in range(2))
    before = [f.launches for f in LEVEL_BWD_COUNTS]
    _level_close(rec_conv2d_level_dgrad(g, wl, size=(h, w)),
                 rec_conv2d_level_dgrad_plain(g, wl, size=(h, w)), 2e-5)
    _level_close(rec_conv2d_level_dgrad(dd, wd, size=(h, w), stride=2, add=dz),
                 rec_conv2d_level_dgrad_plain(dd, wd, size=(h, w), stride=2, add=dz), 2e-5)
    _level_close(rec_conv2d_level_wgrad(x, g, k=5, up=y),
                 rec_conv2d_level_wgrad_plain(x, g, k=5, up=y), 1e-4)
    _level_close(rec_conv2d_level_wgrad(x, dd, k=5, stride=2),
                 rec_conv2d_level_wgrad_plain(x, dd, k=5, stride=2), 1e-4)
    _level_close(rec_conv2d_up_adjoint(dz), rec_conv2d_up_adjoint_plain(dz), 2e-5)
    assert [f.launches - b for f, b in zip(LEVEL_BWD_COUNTS, before)] == [2, 2, 1]


# recnext_a3's attention at 512^2: (heads, side of the attention map, variant), D = 32
A3_SHAPES = [(2, 64, 1), (4, 32, 1), (8, 16, 1), (16, 8, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,side,variant", A3_SHAPES)
def test_attention_kernels_at_a3_task_shapes(cuda, nh, side, variant, dtype):
    """K2 and K2′ through the NCHW entry at recnext_a3's four 512^2 shapes (N 4096 on
    K2′'s tiled route), batch 2: K2 f32 within 1e-3 + 1e-3 |ref| and bf16 within 1e-2
    max|ref|, K2′ at its bounds and the same bits on a second run, one launch each."""
    d, b = 32, 2
    gen = torch.Generator().manual_seed(nh)
    qk = _positive((b, 2 * nh * d, side, side), gen).to("cuda", dtype)
    v, go = (torch.randn(b, nh * d, side, side, generator=gen).to("cuda", dtype)
             for _ in range(2))
    want = linear_attention_nchw_plain(qk.float(), v.float(), nh, variant=variant)
    k2, bw = linear_attention_fused.launches, linear_attention_backward.launches
    got = linear_attention_nchw(qk, v, nh, variant=variant).float()
    dqk, dv_ = linear_attention_nchw_backward(qk, v, go, nh)
    again = linear_attention_nchw_backward(qk, v, go, nh)
    torch.cuda.synchronize()
    assert (linear_attention_fused.launches - k2, linear_attention_backward.launches - bw) == (1, 2)
    if dtype == torch.float32:
        assert ((got - want).abs() <= 1e-3 + 1e-3 * want.abs()).all()
    else:
        assert (got - want).abs().max().item() <= 1e-2 * want.abs().max().item()
    assert torch.equal(dqk, again[0]) and torch.equal(dv_, again[1])
    rows = lambda t: t.reshape(b * nh, d, side * side).transpose(1, 2)  # noqa: E731
    want = linear_attention_backward_plain(*(rows(t.float()) for t in (
        qk[:, : nh * d], qk[:, nh * d:], v, go)))
    _check_attention_backward((rows(dqk[:, : nh * d]), rows(dqk[:, nh * d:]), rows(dv_)),
                              want, dtype)

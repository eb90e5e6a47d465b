"""The host side of the RecConv2d CUDA kernel, on the CPU: the packed lerp-plan
table (bilinear and nearest) against the JAX package's plans and resize, the launch
configuration (team size, planes per block, shared-memory layout) that the kernel
reads as its geometry, and the levels a plane too large for shared memory peels."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from recnext_tpu.ops.resize import _bilinear_axis_plan as jax_bilinear_axis_plan
from recnext_tpu.ops.resize import _nearest_axis_plan as jax_nearest_axis_plan
from recnext_tpu.ops.resize import resize as jax_resize
from recnext_tpu_torch.ops.cuda import recconv as rc

# recnext_m1's four mixer planes at 224^2 (up-steps 4->7, 7->14, 14->28, 28->56), then
# odd, non-square and large pyramids
PLANES = [(56, 56, 4), (28, 28, 3), (14, 14, 2), (7, 7, 1), (15, 15, 2), (13, 9, 4),
          (96, 96, 4)]
M1_TEAMS = {(56, 56, 4): 128, (28, 28, 3): 32, (14, 14, 2): 8, (7, 7, 1): 8}
GEOMETRY_FIELDS = 1 + 6 * (rc.MAX_LEVEL + 1) + 10  # csrc/recconv.cu:Geometry


def _fields(geometry):
    g = list(geometry)
    assert len(g) == GEOMETRY_FIELDS
    per_level = [g[1 + i * 5: 6 + i * 5] for i in range(6)]
    names = ("h", "w", "pitch", "buf", "rows", "cols")
    tail = ("tmp", "tmp_pitch", "out", "out_pitch", "wts", "team_words", "xraw", "yraw",
            "plan", "plan_rows")
    return {"level": g[0], **dict(zip(names, per_level)), **dict(zip(tail, g[31:]))}


@pytest.mark.parametrize("h,w,level", PLANES)
def test_plan_table_equals_the_jax_plans(h, w, level):
    table, rows, cols = rc.lerp_plan_table(h, w, level)
    assert table.dtype == np.int32 and table.shape[1] == 4
    sizes = rc.pyramid_sizes(h, w, level)
    n = 0
    for l in range(1, level + 1):
        for axis, start in ((0, rows[l]), (1, cols[l])):
            idx0, idx1, w1 = jax_bilinear_axis_plan(sizes[l][axis], sizes[l - 1][axis])
            part = table[start: start + sizes[l - 1][axis]]
            np.testing.assert_array_equal(part[:, 0], idx0.astype(np.int32))
            np.testing.assert_array_equal(part[:, 1], idx1.astype(np.int32))
            np.testing.assert_array_equal(part[:, 2].view(np.float32), w1.astype(np.float32))
            np.testing.assert_array_equal(part[:, 3], 0)
            n += len(part)
    assert n == len(table)


@pytest.mark.parametrize("h,w,level", PLANES)
def test_nearest_plan_table_equals_the_jax_plans(h, w, level):
    table, rows, cols = rc.lerp_plan_table(h, w, level, "nearest")
    # the same rows and offsets as the bilinear table: the kernel's geometry holds
    _, brows, bcols = rc.lerp_plan_table(h, w, level)
    assert (rows, cols) == (brows, bcols) and table.dtype == np.int32
    sizes = rc.pyramid_sizes(h, w, level)
    for l in range(1, level + 1):
        for axis, start in ((0, rows[l]), (1, cols[l])):
            idx = jax_nearest_axis_plan(sizes[l][axis], sizes[l - 1][axis])
            part = table[start: start + sizes[l - 1][axis]]
            np.testing.assert_array_equal(part[:, 0], idx.astype(np.int32))
            np.testing.assert_array_equal(part[:, 1], idx.astype(np.int32))
            np.testing.assert_array_equal(part[:, 2:], 0)  # w1 = 0.0f, then padding


def _kernel_upsample(tmp: np.ndarray, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """csrc/recconv.cu's up-step, replayed in fp32: along H with the row plan, then
    along W with the column plan, each a lerp t0 + (t1 - t0) * w."""
    t0, t1 = tmp[rows[:, 0]], tmp[rows[:, 1]]
    wr = rows[:, 2].view(np.float32)[:, None]
    left = t0[:, cols[:, 0]] + (t1[:, cols[:, 0]] - t0[:, cols[:, 0]]) * wr
    right = t0[:, cols[:, 1]] + (t1[:, cols[:, 1]] - t0[:, cols[:, 1]]) * wr
    return left + (right - left) * cols[:, 2].view(np.float32)[None, :]


@pytest.mark.parametrize("h,w,level", PLANES)
def test_nearest_plans_replay_the_jax_resize_exactly(h, w, level):
    table, rows, cols = rc.lerp_plan_table(h, w, level, "nearest")
    sizes = rc.pyramid_sizes(h, w, level)
    rng = np.random.default_rng(level)
    for l in range(1, level + 1):
        (sh, sw), (oh, ow) = sizes[l], sizes[l - 1]
        tmp = rng.normal(size=(sh, sw)).astype(np.float32)
        got = _kernel_upsample(tmp, table[rows[l]: rows[l] + oh], table[cols[l]: cols[l] + ow])
        want = np.asarray(jax_resize(jnp.asarray(tmp[None, :, :, None]), (oh, ow),
                                     mode="nearest"))[0, :, :, 0]
        np.testing.assert_array_equal(got, want)


def test_device_plan_table_is_cached_and_exact():
    for mode in rc.MODES:
        first = rc._device_plan_table(13, 9, 4, mode, torch.device("cpu"))
        assert rc._device_plan_table(13, 9, 4, mode, torch.device("cpu")) is first
        assert first.dtype == torch.int32 and first.is_contiguous()
        np.testing.assert_array_equal(first.numpy(), rc.lerp_plan_table(13, 9, 4, mode)[0])
    with pytest.raises(ValueError, match="mode"):
        rc.lerp_plan_table(13, 9, 4, "bicubic")


@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("h,w,level", PLANES)
def test_launch_config_fits_a_block(h, w, level, k, elem_bytes):
    cfg = rc.launch_config(h, w, level, k, elem_bytes)
    assert cfg.team in rc.TEAM_SIZES
    assert cfg.team * cfg.planes_per_block == rc.BLOCK_THREADS
    assert 0 < cfg.smem_bytes <= rc.MAX_SMEM_BYTES
    g = _fields(cfg.geometry)
    p = k // 2
    sizes = rc.pyramid_sizes(h, w, level)
    taps = -(-k * k // 4) * 4
    assert g["level"] == level and g["wts"] == 0
    end = (level + 2) * taps
    for l, (lh, lw) in enumerate(sizes):
        assert (g["h"][l], g["w"][l]) == (lh, lw)
        pitch = g["pitch"][l]
        assert pitch % 2 == 1  # lanes on consecutive rows hit distinct banks
        # a strip of a stride-1 conv reads up to column ceil(w / STRIP) * STRIP + 2p - 1,
        # a strip of the downsample from this level up to 2 ceil(w' / STRIP) STRIP + k - 3
        assert pitch >= -(-lw // rc.STRIP) * rc.STRIP + 2 * p
        if l < level:
            assert pitch >= 2 * -(-sizes[l + 1][1] // rc.STRIP) * rc.STRIP + k - 2
        assert g["buf"][l] == end  # the regions follow one another
        end += (lh + 2 * p) * pitch
    assert g["tmp"] == end and g["tmp_pitch"] % 2 == 1 and g["tmp_pitch"] >= sizes[1][1]
    end += sizes[1][0] * g["tmp_pitch"]
    assert g["out"] == end
    if w % 2 == 0:
        assert g["out_pitch"] == 0  # strips go straight to y
    else:
        assert g["out_pitch"] % 2 == 1 and g["out_pitch"] >= w
    end += h * g["out_pitch"]
    assert g["team_words"] >= end
    if cfg.team < 32:  # teams that share a warp start in distinct banks
        assert g["team_words"] % 32 == cfg.team
    # block-wide regions after the teams, 16-byte aligned, inside the shared memory
    staged = -(-(15 + cfg.planes_per_block * h * w * elem_bytes) // 16) * 4
    assert g["xraw"] >= g["team_words"] * cfg.planes_per_block and g["xraw"] % 4 == 0
    assert g["yraw"] == g["xraw"] + staged
    assert g["plan"] == g["yraw"] + (staged if g["out_pitch"] else 0)
    assert g["plan_rows"] == len(rc.lerp_plan_table(h, w, level)[0])
    assert (g["plan"] + 4 * g["plan_rows"]) * 4 == cfg.smem_bytes


@pytest.mark.parametrize("plane,team", sorted(M1_TEAMS.items()))
def test_launch_config_of_the_m1_planes(plane, team):
    cfg = rc.launch_config(*plane, 5, 2)
    assert (cfg.team, cfg.planes_per_block) == (team, rc.BLOCK_THREADS // team)


@pytest.mark.parametrize("plane,elem_bytes,team", [
    ((1, 65, 4, 7), 2, 16), ((1, 65, 4, 7), 4, 16), ((81, 3, 4, 7), 4, 32),
    ((91, 11, 4, 7), 4, 64)])
def test_launch_config_takes_bigger_teams_where_small_ones_do_not_fit(plane, elem_bytes,
                                                                     team):
    # 32 (or 8) planes of these pyramids do not fit in one block: fewer, larger teams
    assert rc.team_size(*plane[:2]) < team
    cfg = rc.launch_config(*plane, elem_bytes)
    assert cfg.team == team and cfg.smem_bytes <= rc.MAX_SMEM_BYTES


def test_launch_config_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="shared memory"):
        rc.launch_config(400, 400, 1, 5, 2)  # one plane's pyramid is too large
    with pytest.raises(ValueError, match="level"):
        rc.launch_config(14, 14, 5, 5, 2)
    with pytest.raises(ValueError, match="kernel size"):
        rc.launch_config(14, 14, 2, 4, 2)


# (h, w, level) -> levels to peel at k = 5: m1's mixers at 224^2, a 640^2 input's
# stage-0 plane, COCO 1333x800's stage-0 and stage-1 planes, the 512^2 crop's
PEELS = {(56, 56, 4): 0, (28, 28, 3): 0, (14, 14, 2): 0, (7, 7, 1): 0,
         (160, 160, 4): 1, (200, 334, 4): 2, (100, 167, 3): 1, (128, 128, 4): 0}


@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("plane,peel", sorted(PEELS.items()))
def test_levels_to_peel(plane, peel, elem_bytes):
    h, w, level = plane
    assert rc.levels_to_peel(h, w, level, 5, elem_bytes) == peel
    sizes = rc.pyramid_sizes(h, w, level)
    # the kernel takes the plane left after the peel, and not one level fewer peeled
    rc.launch_config(*sizes[peel], level - peel, 5, elem_bytes)
    if peel:
        with pytest.raises(ValueError, match="shared memory"):
            rc.launch_config(*sizes[peel - 1], level - peel + 1, 5, elem_bytes)


def test_levels_to_peel_reaches_the_plain_conv():
    # a 400^2 plane at level 1 does not fit; peeling its one level leaves conv_0
    assert rc.levels_to_peel(400, 400, 1, 5, 2) == 1
    assert rc.levels_to_peel(1200, 1200, 2, 7, 4) == 2
    with pytest.raises(ValueError, match="level"):
        rc.levels_to_peel(14, 14, 0, 5, 2)

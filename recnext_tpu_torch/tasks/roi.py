"""RoIAlign and the RPN's proposals, NCHW features on the device: the port's
counterpart of ``recnext_tpu/tasks/roi.py`` (the mmdet pieces around the reference's
Mask R-CNN: RPN proposals, SingleRoIExtractor's RoIAlign with aligned=True at out 7
and 14, the FPN level of each RoI).

Every function is batched over images, of fixed shape (a constant number of proposals
an image, with a validity mask) and free of host synchronisation. RoIAlign gathers the
bilinear corners of its samples from a channels-last copy of the features, one row of
C channels a sample: the result is (N, R, out, out, C), the JAX package's (R, out,
out, C) an image, so the box head flattens it in the JAX package's order. The
multilevel RoIAlign pools each RoI at its own level only, by one gather from the
levels concatenated: the JAX package's values (it pools at every level and selects)
and its gradient (which reaches only the selected level), without the other levels'
samples (at 800^2, batch 16, 128 RoIs an image, 1.6 GB a level and corner at 14^2).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from recnext_tpu_torch.tasks.boxes import box_iou, decode_boxes, nms


def _axis_samples(lo: torch.Tensor, extent: torch.Tensor, side: torch.Tensor, n: int):
    """For each RoI (rows), ``n`` cell-centred samples along one axis from ``lo`` over
    ``extent``, clipped to [0, side - 1] after the aligned -0.5 shift: the lower and
    upper indices (R, n, 2) and the upper's weight (R, n)."""
    steps = torch.arange(n, device=lo.device, dtype=lo.dtype) + 0.5
    pos = lo[:, None] + steps * extent[:, None] / n
    pos = torch.minimum((pos - 0.5).clamp_min(0.0), (side - 1).to(lo.dtype)[:, None])
    low = pos.floor()
    upper = torch.minimum(low.long() + 1, (side - 1)[:, None])
    return torch.stack([low.long(), upper], dim=-1), pos - low


def roi_align_rows(src: torch.Tensor, base: torch.Tensor, height: torch.Tensor,
                   width: torch.Tensor, boxes: torch.Tensor, out_size: int = 7,
                   sampling_ratio: int = 2) -> torch.Tensor:
    """RoIAlign over planes stored as rows: RoI i reads the plane of ``height[i]`` x
    ``width[i]`` rows of ``src`` (M, C) that starts at row ``base[i]`` (row-major), its
    box ``boxes[i]`` xyxy in that plane's coordinates. Each output cell is the mean of
    ``sampling_ratio``^2 bilinear samples. Features (floating ``src``) take one
    weighted gather, ``embedding_bag``: each cell the sum of its 4 r^2 corner rows,
    weighted, without the samples written out; its backward sorts the rows it adds
    into, with no float atomics. Integers (a uint8 mask, no gradient) take the JAX
    package's lerps in its order, so that a threshold of the result gives its bits.
    Returns (R, out_size, out_size, C) in ``src``'s dtype (the boxes' for integers)."""
    dtype = src.dtype if src.is_floating_point() else boxes.dtype
    boxes = boxes.to(dtype)
    n, r, rois = out_size * sampling_ratio, sampling_ratio, boxes.shape[0]
    x1, y1, x2, y2 = boxes.unbind(-1)
    ys, wy = _axis_samples(y1, (y2 - y1).clamp_min(1e-6), height, n)
    xs, wx = _axis_samples(x1, (x2 - x1).clamp_min(1e-6), width, n)
    rows = base[:, None, None] + ys * width[:, None, None]  # (R, n, 2)
    if src.is_floating_point():
        idx = rows[:, :, None, :, None] + xs[:, None, :, None, :]  # (R, y, x, 2, 2)
        w = (torch.stack([1 - wy, wy], -1)[:, :, None, :, None]
             * torch.stack([1 - wx, wx], -1)[:, None, :, None, :] / (r * r))

        def cells(t):  # (R, y, x, 2, 2) -> (R * out^2, 4 r^2): a cell's samples a row
            return t.reshape(rois, out_size, r, out_size, r, 2, 2).permute(
                0, 1, 3, 2, 4, 5, 6).reshape(rois * out_size * out_size, 4 * r * r)

        out = F.embedding_bag(cells(idx), src, per_sample_weights=cells(w), mode="sum")
        return out.reshape(rois, out_size, out_size, -1)

    def corner(a, b):
        idx = (rows[..., a][:, :, None] + xs[..., b][:, None, :]).reshape(-1)
        return src.index_select(0, idx).reshape(rois, n, n, -1).to(dtype)

    wx, wy = wx[:, None, :, None], wy[:, :, None, None]
    top = corner(0, 0) * (1 - wx) + corner(0, 1) * wx
    bot = corner(1, 0) * (1 - wx) + corner(1, 1) * wx
    s = top * (1 - wy) + bot * wy
    return s.reshape(rois, out_size, r, out_size, r, -1).mean(dim=(2, 4))


def roi_align(feat: torch.Tensor, boxes: torch.Tensor, out_size: int = 7,
              sampling_ratio: int = 2) -> torch.Tensor:
    """RoIAlign (aligned=True) of one level: ``feat`` (N, C, H, W), ``boxes`` (N, R, 4)
    xyxy in the level's coordinates -> (N, R, out_size, out_size, C)."""
    n, _, h, w = feat.shape
    r = boxes.shape[1]
    src = feat.permute(0, 2, 3, 1).reshape(n * h * w, -1)
    base = torch.arange(n, device=feat.device).repeat_interleave(r) * (h * w)
    height, width = (torch.full((n * r,), s, device=feat.device) for s in (h, w))
    out = roi_align_rows(src, base, height, width, boxes.reshape(-1, 4), out_size,
                         sampling_ratio)
    return out.reshape(n, r, *out.shape[1:])


def assign_fpn_level(boxes: torch.Tensor, num_levels: int = 4,
                     finest_scale: float = 56.0) -> torch.Tensor:
    """The FPN level of each (..., 4) RoI, mmdet's SingleRoIExtractor rule:
    floor(log2(sqrt(area) / finest_scale)), clipped to [0, num_levels)."""
    area = ((boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])).clamp_min(1e-6)
    lvl = torch.floor(torch.log2(torch.sqrt(area) / finest_scale + 1e-8))
    return lvl.clamp(0, num_levels - 1).long()


def pack_levels(feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, List[Tuple[int, int]]]:
    """The levels (N, C, H_l, W_l) as one channels-last table of rows, image-major
    (image n's level l starts at row n * sum_l H_l W_l + sum_{k<l} H_k W_k), and the
    level sizes: ``multilevel_roi_align``'s source, shared by the box and mask RoIs."""
    n = feats[0].shape[0]
    rows = torch.cat([f.permute(0, 2, 3, 1).reshape(n, -1, f.shape[1]) for f in feats], dim=1)
    return rows.reshape(-1, rows.shape[-1]), [tuple(f.shape[2:]) for f in feats]


def multilevel_roi_align(feats: Sequence[torch.Tensor], boxes: torch.Tensor,
                         strides: Sequence[int], out_size: int = 7,
                         packed: Optional[Tuple[torch.Tensor, List[Tuple[int, int]]]] = None
                         ) -> torch.Tensor:
    """Each RoI of ``boxes`` (N, R, 4), in image coordinates, RoIAligned at its FPN
    level (``assign_fpn_level``) of ``feats`` (N, C, H_l, W_l) at ``strides``, through
    ``packed`` (``pack_levels(feats)``) where given. Returns (N, R, out, out, C)."""
    src, shapes = packed if packed is not None else pack_levels(feats)
    n, r = boxes.shape[:2]
    dev = boxes.device
    sizes = [h * w for h, w in shapes]
    offsets = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))], device=dev)
    heights = torch.tensor([h for h, _ in shapes], device=dev)
    widths = torch.tensor([w for _, w in shapes], device=dev)
    scale = torch.tensor([float(s) for s in strides], device=dev, dtype=boxes.dtype)
    flat = boxes.reshape(-1, 4)
    lvl = assign_fpn_level(flat, num_levels=len(shapes))
    base = torch.arange(n, device=dev).repeat_interleave(r) * sum(sizes) + offsets[lvl]
    out = roi_align_rows(src, base, heights[lvl], widths[lvl], flat / scale[lvl][:, None],
                         out_size)
    return out.reshape(n, r, *out.shape[1:])


def generate_proposals(objectness: torch.Tensor, deltas: torch.Tensor, anchors: torch.Tensor,
                       *, img_hw: Tuple[int, int], pre_nms_top_n: int = 1000,
                       post_nms_top_n: int = 256, nms_thresh: float = 0.7
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RPN's proposals of each image, fixed shape: the top ``pre_nms_top_n`` anchors
    by objectness (a stable descending sort: ties to the lower index, as
    ``jax.lax.top_k``), decoded, clipped to the image, then NMS at ``nms_thresh`` on
    their sigmoid scores to ``post_nms_top_n`` (all images at once, each on its own
    IoU matrix). ``objectness`` (N, A), ``deltas`` (N, A, 4), ``anchors`` (A, 4).
    Returns (boxes (N, post_nms_top_n, 4), valid (N, post_nms_top_n))."""
    n, a = objectness.shape
    k = min(pre_nms_top_n, a)
    order = torch.sort(objectness, dim=1, descending=True, stable=True)
    scores, idx = order.values[:, :k], order.indices[:, :k]
    picked = deltas.gather(1, idx[..., None].expand(n, k, 4))
    boxes = decode_boxes(anchors[idx.reshape(-1)], picked.reshape(-1, 4)).reshape(n, k, 4)
    h, w = img_hw
    boxes = torch.stack([boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
                         boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)], dim=-1)
    keep, valid = nms(boxes, torch.sigmoid(scores.float()), iou_thresh=nms_thresh,
                      max_out=post_nms_top_n, iou=box_iou(boxes, boxes))
    return boxes.gather(1, keep[..., None].expand(n, post_nms_top_n, 4)), valid

"""On the GPU: RoIAlign's two forms at a Mask R-CNN train step's shapes (recnext_m3 at
the det preset: 800^2, batch 16, 128 proposals an image with the ground truth spliced
in, P2-P5 x 256), forward and backward of the 7^2 and 14^2 RoIAligns from one packed
table, in turns (corner gathers, weighted gather, weighted gather, corner gathers):

* the corner gathers: four ``index_select`` gathers of every sample's corners, the JAX
  package's lerps, the mean over r x r; the backward an atomic ``index_add``
  (the form ``tasks/roi.py:roi_align_rows`` keeps for a uint8 mask);
* the weighted gather: ``embedding_bag`` over each cell's 4 r^2 corner rows with their
  weights (the form it takes for features).

For each: ms a call from CUDA events around 5 calls and device ms from a
torch.profiler trace of 3; whether the backward gives the same bits on two runs; the
largest difference between the two forms' outputs and gradients. The features and
proposals are the model's own in train mode (seeded weights, backbone BN on batch
statistics). Then the card's name and power limit.

  python -m recnext_tpu_torch.tools.roi_align_forms
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

BATCH, SIDE = 16, 800


def corner_gathers(src, base, height, width, boxes, out_size=7, sampling_ratio=2):
    from recnext_tpu_torch.tasks.roi import _axis_samples

    n, r, rois = out_size * sampling_ratio, sampling_ratio, boxes.shape[0]
    x1, y1, x2, y2 = boxes.unbind(-1)
    ys, wy = _axis_samples(y1, (y2 - y1).clamp_min(1e-6), height, n)
    xs, wx = _axis_samples(x1, (x2 - x1).clamp_min(1e-6), width, n)
    rows = base[:, None, None] + ys * width[:, None, None]

    def corner(a, b):
        idx = (rows[..., a][:, :, None] + xs[..., b][:, None, :]).reshape(-1)
        return src.index_select(0, idx).reshape(rois, n, n, -1)

    wx, wy = wx[:, None, :, None], wy[:, :, None, None]
    top = corner(0, 0) * (1 - wx) + corner(0, 1) * wx
    bot = corner(1, 0) * (1 - wx) + corner(1, 1) * wx
    s = top * (1 - wy) + bot * wy
    return s.reshape(rois, out_size, r, out_size, r, -1).mean(dim=(2, 4))


def cuda_ms(fn, iters: int = 5) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation) / 1e3 / iters


def main() -> None:
    from recnext_tpu_torch.tasks import roi, train_det
    from recnext_tpu_torch.tasks.mask_rcnn import ROI_STRIDES, splice_gt

    torch.backends.cudnn.allow_tf32 = True
    args = train_det.parse_args(["--preset", "det_recnext_m3_fpn_1x_coco", "--with-mask"])
    model = train_det.build_model(args, True, torch.Generator().manual_seed(0)).cuda().train()
    b = {k: torch.from_numpy(v).cuda() for k, v in train_det.synthetic_det_batch(
        np.random.default_rng(0), BATCH, SIDE, 80, with_masks=True).items()}
    with torch.no_grad():
        feats, obj, deltas, anchors = model._rpn(b["image"])
        props = splice_gt(*model._propose(obj, deltas, anchors, (SIDE, SIDE)),
                          b["gt_boxes"], b["gt_labels"])[0]
    del model
    leaves = [f.detach().clone().requires_grad_() for f in feats[:4]]
    gen = torch.Generator("cuda").manual_seed(0)
    cot = {s: torch.randn(BATCH, props.shape[1], s, s, leaves[0].shape[1], generator=gen,
                          device="cuda") for s in (7, 14)}

    def call():
        for f in leaves:
            f.grad = None
        packed = roi.pack_levels(leaves)
        outs = {s: roi.multilevel_roi_align(leaves, props, ROI_STRIDES, s, packed=packed)
                for s in (7, 14)}
        torch.autograd.backward([outs[7], outs[14]], [cot[7], cot[14]])
        return outs

    forms = {"corner_gathers": corner_gathers, "weighted_gather": roi.roi_align_rows}
    port = roi.roi_align_rows
    rec = {name: {"call_ms": [], "device_ms": []} for name in forms}
    kept = {}
    try:
        for name in ("corner_gathers", "weighted_gather", "weighted_gather", "corner_gathers"):
            roi.roi_align_rows = forms[name]
            rec[name]["call_ms"].append(cuda_ms(call))
            rec[name]["device_ms"].append(device_ms(call))
        for name, form in forms.items():
            roi.roi_align_rows = form
            runs = []
            for _ in range(2):
                outs = call()
                runs.append(({s: o.detach().clone() for s, o in outs.items()},
                             [f.grad.clone() for f in leaves]))
            rec[name]["backward_same_bits_2_runs"] = all(
                torch.equal(x, y) for x, y in zip(runs[0][1], runs[1][1]))
            kept[name] = runs[0]
    finally:
        roi.roi_align_rows = port
    (out_a, grad_a), (out_b, grad_b) = kept["corner_gathers"], kept["weighted_gather"]
    diff = {f"out_{s}": [(out_a[s] - out_b[s]).abs().max().item(), out_a[s].abs().max().item()]
            for s in (7, 14)}
    diff.update({f"grad_P{i + 2}": [(x - y).abs().max().item(), x.abs().max().item()]
                 for i, (x, y) in enumerate(zip(grad_a, grad_b))})
    print(json.dumps({"rois": int(props.shape[0] * props.shape[1]), "forms": rec,
                      "max_abs_diff_and_max_abs": diff}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()

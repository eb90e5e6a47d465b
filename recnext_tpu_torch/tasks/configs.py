"""Downstream-task training presets: the port's copy of
``recnext_tpu/tasks/configs.py`` (the reference's mm config files
``detection/configs/mask_rcnn_recnext_m{3,4,5}_fpn_1x_coco.py`` and
``segmentation/configs/sem_fpn/fpn_recnext_m{3,4,5}_ade20k_40k.py`` as plain dicts
that the task trainers read through ``--preset``)."""

from __future__ import annotations

# COCO detection, 1x schedule (12 epochs), AdamW lr 2e-4 wd 0.05, FPN-256,
# frozen-BN backbone initialized from the classification checkpoint.
DETECTION_CONFIGS = {
    f"det_{m}_fpn_1x_coco": dict(
        backbone=m,
        fpn_channels=256,
        num_classes=80,
        lr=2e-4,
        weight_decay=0.05,
        epochs=12,
        lr_decay_epochs=(8, 11),  # mm 1x step schedule
        lr_decay_factor=0.1,
        img_scale=(1333, 800),
        frozen_backbone_stats=True,
        batch_size=16,
    )
    # m3-5 match the committed config files; a3-5 match the published A-series
    # COCO table (the reference README's table) with the recattn backbones
    # the reference registers at detection/recattn.py:309-318
    for m in ("recnext_m3", "recnext_m4", "recnext_m5",
              "recnext_a3", "recnext_a4", "recnext_a5")
}

# ADE20K Semantic FPN, 40k iters (80k / gpu_multiples=2), AdamW 1e-4 wd 0.05,
# poly power 0.9 min 1e-6, crop 512, eval mIoU every 8k, AlignResize /32.
SEGMENTATION_CONFIGS = {
    f"seg_{m}_fpn_ade20k_40k": dict(
        backbone=m,
        fpn_channels=256,
        num_classes=150,
        lr=1e-4,
        weight_decay=0.05,
        iters=40000,
        poly_power=0.9,
        min_lr=1e-6,
        crop=512,
        eval_every=8000,
        size_divisor=32,
        frozen_backbone_stats=True,
        batch_size=16,
    )
    for m in ("recnext_m3", "recnext_m4", "recnext_m5",
              "recnext_a3", "recnext_a4", "recnext_a5")
}

"""The downstream tasks: Semantic FPN segmentation and RetinaNet detection, their
trainers (``train_seg``, ``train_det``), box ops, the COCO evaluator and presets."""

from recnext_tpu_torch.tasks.detection import (  # noqa: F401
    DetectionBackbone,
    RetinaNet,
    init_backbone_from_classification,
)
from recnext_tpu_torch.tasks.fpn import FPN  # noqa: F401
from recnext_tpu_torch.tasks.segmentation import SemanticFPN, miou, segmentation_loss  # noqa: F401

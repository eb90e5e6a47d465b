"""recnext_tpu_torch: the PyTorch/CUDA port of recnext_tpu for NVIDIA Hopper.

The JAX package ``recnext_tpu`` stays the reference; this package imports none of
it. Layout is NCHW. Entry points run on the GPU unless ``device="cpu"`` is passed.

Public API:
    create_model, get_config, list_models   model registry (M and A families so far)
    fuse_params                             BN fusion of a torch state dict
    jax_to_torch, jax_fused_to_torch        weights from the JAX package
    publish_fused, load_published           the fused archive the server loads
"""

from recnext_tpu_torch.convert import jax_fused_to_torch, jax_to_torch  # noqa: F401
from recnext_tpu_torch.export import load_published, publish_fused  # noqa: F401
from recnext_tpu_torch.fusion import fuse_params  # noqa: F401
from recnext_tpu_torch.models.registry import create_model, get_config, list_models  # noqa: F401

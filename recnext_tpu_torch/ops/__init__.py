"""Operators: the plain PyTorch versions and the bindings of the CUDA kernels.

Importing the package registers the kernels' entries as custom ops
(``recnext::rec_conv2d``, ``recnext::linear_attention``,
``recnext::linear_attention_nchw``), which a program saved by ``torch.export``
names: import it before ``torch.export.load``."""

from recnext_tpu_torch.ops import attention, recconv  # noqa: F401  (registers the ops)

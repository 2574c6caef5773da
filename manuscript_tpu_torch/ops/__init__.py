"""Tensor ops of the page path. ``attention_step`` and ``quad_iou`` hold the
hand-written CUDA kernels (sources in ``../csrc``) beside their plain twins."""

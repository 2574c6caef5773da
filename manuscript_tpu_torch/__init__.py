"""manuscript_tpu_torch — the PyTorch/CUDA port of manuscript_tpu for one
NVIDIA H100: page OCR with EAST detection, device LANMS, native-resolution
host crops and TRBA beam recognition, and training of both models
(``train/``, ``EAST.train``, ``TRBA.train``). The two kernels that the JAX
package writes in Pallas are hand-written CUDA here (``csrc/``), built with
nvcc at first use. Imports torch and numpy (PIL only inside the functions
that draw or read image files).

The root exports the JAX package's root names (``Pipeline``,
``visualize_page``, ``read_image``, ``Word``/``Block``/``Page``,
``__version__``) and the two wrappers."""

from ._version import __version__
from .detectors import EAST
from .ops.image import read_image
from .pipeline import Pipeline
from .recognizers import TRBA
from .types import Block, Page, Word
from .utils.visualize import visualize_page

__all__ = [
    "Pipeline",
    "visualize_page",
    "read_image",
    "Word",
    "Block",
    "Page",
    "__version__",
    "EAST",
    "TRBA",
]

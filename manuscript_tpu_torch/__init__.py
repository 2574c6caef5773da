"""manuscript_tpu_torch — the PyTorch/CUDA port of manuscript_tpu for one
NVIDIA H100: page OCR with EAST detection, device LANMS, native-resolution
host crops and TRBA beam recognition, and training of both models
(``train/``, ``EAST.train``, ``TRBA.train``). The two kernels that the JAX
package writes in Pallas are hand-written CUDA here (``csrc/``), built with
nvcc at first use. Imports torch and numpy only."""

from .detectors import EAST
from .pipeline import Pipeline
from .recognizers import TRBA
from .types import Block, Page, Word

__all__ = ["EAST", "TRBA", "Pipeline", "Page", "Block", "Word"]

"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu``.

The package mirrors ``paddle_tpu``'s layout (``models/llama.py``,
``inference/serving.py``, ...). Plain tensor code is PyTorch; every
Pallas kernel on a ported path is a hand-written CUDA kernel for Hopper
(``csrc/*.cu``, built with nvcc at first CUDA use and bound with
ctypes, see ``ops/kernels/_build.py``). Entry points run on the CUDA
device unless the caller passes ``device="cpu"``; on the CPU every
kernel wrapper takes its plain PyTorch version. There is no fallback on
the card: a CUDA tensor launches the kernel or raises.
"""

from .core.flags import get_flags, set_flags
from .framework.io import load, save

__all__ = ["get_flags", "load", "save", "set_flags"]

"""PyTorch/CUDA port of inverseproblemwithdiffusionmodel_tpu.

Imports torch, numpy and the standard library only. Entry points run on the
GPU unless the caller passes a CPU device.
"""

__version__ = "0.1.0"

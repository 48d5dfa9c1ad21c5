"""FIR resampling: plain versions and the CUDA kernels; the linear
resizes."""
from .resize import resize_align_corners, resize_half_pixel

__all__ = ["resize_align_corners", "resize_half_pixel"]

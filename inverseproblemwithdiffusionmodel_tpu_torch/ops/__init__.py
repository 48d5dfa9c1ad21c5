"""FIR resampling: plain versions and the CUDA kernels; the linear
resizes, the centered FFTs, upfirdn2d and the fused bias + leaky ReLU,
exported as the JAX package's ops/ exports them."""
from .fft import i2k_complex, k2i_complex
from .fused_act import fused_leaky_relu
from .resize import resize_align_corners, resize_half_pixel
from .upfirdn2d import downsample_2d, upfirdn2d, upsample_2d

__all__ = ["downsample_2d", "fused_leaky_relu", "i2k_complex",
           "k2i_complex", "resize_align_corners", "resize_half_pixel",
           "upfirdn2d", "upsample_2d"]

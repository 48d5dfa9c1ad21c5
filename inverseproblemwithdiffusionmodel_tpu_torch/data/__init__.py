"""Data: the MNIST, CIFAR-10, image-folder, ACDC, CINE and SanityCheck1D
loaders (with seeded synthetic stand-ins) and host-side numpy
transforms."""
from . import transforms
from .datasets import (ArrayDataset, REGISTERED_DATA_ROOT_DIR,
                       data_provenance, load_acdc, load_cifar10, load_cine,
                       load_data, load_image_folder, load_mnist,
                       load_sanity_check_1d, load_tissue_data,
                       reset_provenance, synthetic_acdc_slice,
                       synthetic_cine, synthetic_digits, synthetic_rgb,
                       vol2slice)

__all__ = ["ArrayDataset", "REGISTERED_DATA_ROOT_DIR", "data_provenance",
           "load_acdc", "load_cifar10", "load_cine", "load_data",
           "load_image_folder", "load_mnist", "load_sanity_check_1d",
           "load_tissue_data", "reset_provenance", "synthetic_acdc_slice",
           "synthetic_cine", "synthetic_digits", "synthetic_rgb",
           "transforms", "vol2slice"]

"""Data of the discrete training path: the ACDC and CINE loaders (with
seeded synthetic stand-ins) and host-side numpy transforms."""
from . import transforms
from .datasets import (ArrayDataset, REGISTERED_DATA_ROOT_DIR,
                       data_provenance, load_acdc, load_cine, load_data,
                       load_tissue_data, synthetic_acdc_slice,
                       synthetic_cine)

__all__ = ["ArrayDataset", "REGISTERED_DATA_ROOT_DIR", "data_provenance",
           "load_acdc", "load_cine", "load_data", "load_tissue_data",
           "synthetic_acdc_slice", "synthetic_cine", "transforms"]

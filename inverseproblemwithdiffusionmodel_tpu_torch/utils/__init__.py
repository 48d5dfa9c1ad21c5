"""Weight conversion and seeded weights, the prior files, metrics, array
helpers, dataset statistics and profiling; the names the JAX package's
utils/ exports, from the same submodules. Pillow, matplotlib and
tensorboard stay imported inside the functions that use them."""
from .reshape import reshape_temporal_dim
from .misc import (
    expand_like,
    data_transform,
    logit_transform,
    inverse_data_scaler,
    normalize,
    denormalize,
    normalize_phase,
    get_timestamp,
    add_phase,
    collate_batch,
    filter_batch,
    undersample_seg_mask,
)
from .metrics import (compute_metrics, nrmse, ssim, mae, mse, compute_snr,
                      compute_mean_and_std)
from .misc import stack_parts, unstack_parts
from .metrics import nrmse_np, ssim_np, compute_snr_np
from .dataset_stats import (max_pairwise_distance, tv_norm_histogram,
                            norm_histogram, count_samples,
                            suggest_sigma_max)
from .profiling import trace, annotate, timed

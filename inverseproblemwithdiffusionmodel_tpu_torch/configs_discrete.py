"""Dataset configs of the discrete (NCSNv2) stack, built in code.

The JAX package reads these from YAML files (inverseproblemwithdiffusion
model_tpu/configs/*.yml through `config.load_config`); the port keeps the
same trees as dicts so it needs no yaml. Ported: ACDC (configs/acdc.yml),
the cine frames CINE127 and CINE64 and their pixel-tube temporal configs
CINE127_1D and CINE64_1D (configs/cine*.yml), MNIST (configs/mnist.yml,
the README quick start's), SanityCheck1D (configs/sanity_check_1d.yml),
the NCSN papers' natural-image recipes CIFAR10, CELEBA, BEDROOM, CHURCH,
TOWER, FFHQ and NCSN_ORIGINAL (configs/{cifar10,celeba,bedroom,church,
tower,ffhq,ncsn_original}.yml), and the Seg / Clf architecture and trainer
constants of configs/general_config.yml (`GENERAL`).
"""
from __future__ import annotations

ACDC = {
    "training": {
        "log_all_sigmas": False, "snapshot_sampling": True,
        "snapshot_freq": 5000, "n_iters": 80001, "batch_size": 3,
        "seg_batch_size": 64, "n_epochs": 400, "seg_epochs": 2000,
        "anneal_power": 2,
    },
    "sampling": {
        "n_interpolations": 8, "interpolation": False, "inpainting": False,
        "num_samples4fid": 10000, "fid": False, "ckpt_id": 80000,
        "data_init": False, "batch_size": 1, "step_lr": 9e-07,
        "n_steps_each": 3, "final_only": True, "denoise": True,
        "complex_inner_n_steps": 10,
    },
    "data": {
        "num_workers": 8, "dataset": "ACDC", "image_size": 256,
        "channels": 1, "logit_transform": False,
        "uniform_dequantization": False, "gaussian_dequantization": False,
        "random_flip": True, "rescaled": False,
    },
    "model": {
        "spec_norm": False, "sigma_begin": 348, "num_classes": 2311,
        "ema": True, "ema_rate": 0.999, "sigma_dist": "geometric",
        "sigma_end": 0.01, "normalization": "InstanceNorm++",
        "nonlinearity": "elu", "ngf": 128,
    },
    "optim": {
        "amsgrad": False, "weight_decay": 0.0, "optimizer": "Adam",
        "lr": 0.0001, "beta1": 0.9, "eps": 0.001,
    },
    "MAP": {"n_iters": 200, "complex_inner_n_steps": 20, "lr": 0.001},
    "recons": {
        "sigma_dist": "geometric", "sigma_begin": 348, "num_classes": 2311,
        "sigma_end": 0.01,
    },
    "fast_fid": {
        "batch_size": 1000, "num_samples": 1000, "step_lr": 9e-07,
        "n_steps_each": 3, "begin_ckpt": 100000, "end_ckpt": 80000,
        "verbose": False, "ensemble": False,
    },
    "test": {"begin_ckpt": 5000, "end_ckpt": 80000, "batch_size": 100},
}



def _cine(dataset: str, image_size: int, channels: int, batch_size: int,
          n_epochs: int, sigma_begin: float, num_classes: int,
          step_lr: float, **tube) -> dict:
    """A cine config: the frames' (channels 1) or, with `tube` (th, leq),
    the temporal pixel tubes' (image_size = T frames, channels = win^2);
    the four YAML files differ only in these fields."""
    training = {"log_all_sigmas": False, "snapshot_sampling": True,
                "snapshot_freq": 5000, "n_iters": 80001,
                "batch_size": batch_size, "n_epochs": n_epochs,
                "anneal_power": 2}
    data = {"num_workers": 8, "dataset": dataset, "image_size": image_size,
            "channels": channels, "logit_transform": False,
            "uniform_dequantization": False,
            "gaussian_dequantization": False, "random_flip": True,
            "rescaled": False}
    if tube:
        training["use_IN"] = True
        data.update(channels_3d=1, **tube)
    ladder = {"sigma_dist": "geometric", "sigma_begin": sigma_begin,
              "num_classes": num_classes, "sigma_end": 0.01}
    return {
        "training": training,
        "sampling": {
            "n_interpolations": 8, "interpolation": False,
            "inpainting": False, "num_samples4fid": 10000, "fid": False,
            "ckpt_id": 80000, "data_init": False, "batch_size": 1,
            "step_lr": step_lr, "n_steps_each": 3, "final_only": True,
            "denoise": True,
        },
        "data": data,
        "model": {
            "spec_norm": False, **ladder, "ema": True, "ema_rate": 0.999,
            "normalization": "InstanceNorm++", "nonlinearity": "elu",
            "ngf": 128,
        },
        "optim": dict(ACDC["optim"]),
        "recons": ladder,
        "fast_fid": dict(ACDC["fast_fid"]),
        "test": dict(ACDC["test"]),
    }


# cardiac cine frames, 128 px and 64 px, and their temporal priors on 8x8
# pixel tubes of T = 24 frames (64 channels)
CINE127 = _cine("CINE127", 128, 1, 8, 400, 60, 1000, 9e-07)
CINE127_1D = _cine("CINE127", 24, 64, 90, 50, 40, 400, 0.001, th=0.05,
                   leq=8.82)
CINE64 = _cine("CINE64", 64, 1, 32, 400, 33, 500, 9e-07)
CINE64_1D = _cine("CINE64", 24, 64, 128, 200, 40, 200, 0.001, th=0.06,
                  leq=1000)

# MNIST 32x32 (reference: ncsn/configs/mnist.yml)
MNIST = {
    "training": {
        "log_all_sigmas": False, "snapshot_sampling": True,
        "snapshot_freq": 5000, "n_iters": 300001, "batch_size": 128,
        "clf_batch_size": 512, "n_epochs": 200, "anneal_power": 2,
    },
    "sampling": {
        "n_interpolations": 15, "interpolation": False, "inpainting": False,
        "num_samples4fid": 10000, "fid": False, "ckpt_id": 300000,
        "data_init": False, "batch_size": 1, "step_lr": 6.2e-06,
        "n_steps_each": 5, "final_only": True, "denoise": True,
    },
    "data": {
        "num_workers": 0, "dataset": "MNIST", "image_size": 32,
        "channels": 1, "logit_transform": False,
        "uniform_dequantization": False, "gaussian_dequantization": False,
        "random_flip": True, "rescaled": False,
    },
    "model": {
        "spec_norm": False, "sigma_begin": 50, "num_classes": 232,
        "ema": True, "ema_rate": 0.999, "sigma_dist": "geometric",
        "sigma_end": 0.01, "normalization": "InstanceNorm++",
        "nonlinearity": "elu", "ngf": 128,
    },
    "optim": {
        "amsgrad": False, "weight_decay": 0.0, "optimizer": "Adam",
        "lr": 0.0001, "beta1": 0.9, "eps": 1e-08,
    },
    "MAP": {"n_iters": 15000, "lr": 0.001},
    "recons": {
        "sigma_dist": "geometric", "sigma_begin": 50, "num_classes": 232,
        "sigma_end": 0.01,
    },
    "fast_fid": {
        "batch_size": 1000, "num_samples": 1000, "step_lr": 6.2e-06,
        "n_steps_each": 5, "begin_ckpt": 5000, "end_ckpt": 300000,
        "verbose": False, "ensemble": False,
    },
    "test": {"begin_ckpt": 5000, "end_ckpt": 300000, "batch_size": 100},
}

# the synthetic ramp + sine signals, 64-channel tubes of 32 steps
# (reference: ncsn/configs/sanity_check_1D.yml)
SANITY_CHECK_1D = {
    "training": {
        "log_all_sigmas": False, "snapshot_sampling": True,
        "snapshot_freq": 5000, "n_iters": 80001, "batch_size": 32,
        "n_epochs": 100, "use_IN": False, "anneal_power": 2,
    },
    "sampling": dict(CINE64_1D["sampling"]),
    "data": {
        "num_workers": 8, "dataset": "SanityCheck1D", "image_size": 32,
        "channels": 64, "logit_transform": False,
        "uniform_dequantization": False, "gaussian_dequantization": False,
        "random_flip": True, "rescaled": False, "th": 0.06, "leq": 1000,
    },
    "model": dict(CINE64_1D["model"], sigma_begin=40, num_classes=200),
    "optim": dict(ACDC["optim"]),
    "recons": {
        "sigma_dist": "geometric", "sigma_begin": 40, "num_classes": 400,
        "sigma_end": 0.01,
    },
    "fast_fid": dict(ACDC["fast_fid"]),
    "test": dict(ACDC["test"]),
}



def _natural(dataset: str, image_size: int, num_workers: int,
             sigma_begin: float, num_classes: int, ckpt_id: int,
             sample_batch: int, step_lr: float, n_steps_each: int,
             n_interpolations: int, begin_ckpt: int, batch_size: int = 128,
             eps: float = 1e-08, **data) -> dict:
    """An NCSNv2 natural-image config (reference: ncsn/configs/*.yml): the
    six YAML files differ only in these fields; n_iters and the fid and
    test checkpoints follow ckpt_id. `data` adds e.g. the LSUN category."""
    ladder = {"sigma_dist": "geometric", "sigma_begin": sigma_begin,
              "num_classes": num_classes, "sigma_end": 0.01}
    return {
        "training": {
            "log_all_sigmas": False, "snapshot_sampling": True,
            "snapshot_freq": 5000, "n_iters": ckpt_id + 1,
            "batch_size": batch_size, "n_epochs": 500000, "anneal_power": 2,
        },
        "sampling": {
            "n_interpolations": n_interpolations, "interpolation": False,
            "inpainting": False, "num_samples4fid": 10000, "fid": False,
            "ckpt_id": ckpt_id, "data_init": False,
            "batch_size": sample_batch, "step_lr": step_lr,
            "n_steps_each": n_steps_each, "final_only": True,
            "denoise": True,
        },
        "data": {
            "num_workers": num_workers, "dataset": dataset, **data,
            "image_size": image_size, "channels": 3,
            "logit_transform": False, "uniform_dequantization": False,
            "gaussian_dequantization": False, "random_flip": True,
            "rescaled": False,
        },
        "model": {
            "spec_norm": False, "sigma_begin": sigma_begin,
            "num_classes": num_classes, "ema": True, "ema_rate": 0.999,
            "sigma_dist": "geometric", "sigma_end": 0.01,
            "normalization": "InstanceNorm++", "nonlinearity": "elu",
            "ngf": 128,
        },
        "optim": {
            "amsgrad": False, "weight_decay": 0.0, "optimizer": "Adam",
            "lr": 0.0001, "beta1": 0.9, "eps": eps,
        },
        "recons": ladder,
        "fast_fid": {
            "batch_size": 1000, "num_samples": 1000, "step_lr": step_lr,
            "n_steps_each": n_steps_each, "begin_ckpt": begin_ckpt,
            "end_ckpt": ckpt_id, "verbose": False, "ensemble": False,
        },
        "test": {"begin_ckpt": 5000, "end_ckpt": ckpt_id, "batch_size": 100},
    }


# the NCSNv2 paper's recipes: CIFAR-10 32 px, CelebA 64 px, LSUN bedroom
# and tower 128 px, church 64 px, FFHQ 256 px
CIFAR10 = _natural("CIFAR10", 32, 4, 50, 232, 300000, 100, 6.2e-06, 5, 15,
                   5000)
CELEBA = _natural("CELEBA", 64, 32, 90, 500, 210000, 64, 3.3e-06, 5, 15,
                  5000)
BEDROOM = _natural("LSUN", 128, 32, 190, 1086, 150000, 36, 1.8e-06, 3, 10,
                   100000, category="bedroom")
CHURCH = _natural("LSUN", 64, 32, 140, 788, 200000, 96, 4.9e-06, 4, 12,
                  100000, category="church_outdoor")
TOWER = _natural("LSUN", 128, 32, 190, 1086, 150000, 36, 1.8e-06, 3, 10,
                 100000, category="tower")
FFHQ = _natural("FFHQ", 256, 8, 348, 2311, 80000, 36, 9e-07, 3, 8, 100000,
                batch_size=32, eps=0.001)

# NCSN v1's original CIFAR-10 recipe (reference: ncsn/configs/
# ncsn_original.yml): a 10-level ladder 1 -> 0.01, 100 Langevin steps a
# level, no EMA, no final denoise, uniform dequantization, lr 1e-3
NCSN_ORIGINAL = _natural("CIFAR10", 32, 4, 1, 10, 175000, 100, 2e-05, 100,
                         0, 0)
del NCSN_ORIGINAL["fast_fid"], NCSN_ORIGINAL["test"]
del NCSN_ORIGINAL["sampling"]["n_interpolations"]
NCSN_ORIGINAL["training"]["n_iters"] = 300001
NCSN_ORIGINAL["sampling"]["denoise"] = False
NCSN_ORIGINAL["data"]["uniform_dequantization"] = True
NCSN_ORIGINAL["model"]["ema"] = False
NCSN_ORIGINAL["optim"]["lr"] = 0.001

DATASETS = {"ACDC": ACDC, "CINE127": CINE127, "CINE127_1D": CINE127_1D,
            "CINE64": CINE64, "CINE64_1D": CINE64_1D, "MNIST": MNIST,
            "SanityCheck1D": SANITY_CHECK_1D, "CIFAR10": CIFAR10,
            "CELEBA": CELEBA, "BEDROOM": BEDROOM, "CHURCH": CHURCH,
            "TOWER": TOWER, "FFHQ": FFHQ, "NCSN_ORIGINAL": NCSN_ORIGINAL}

# Seg / Clf architectures and generic trainer constants (reference:
# ncsn/configs/general_config.yml, configs/general_configs.py:4-10)
GENERAL = {
    "Seg": {
        "spatial_dims": 2, "in_channels": 1, "out_channels": 2,
        "channels": [64, 128, 256, 512, 1024], "strides": [2, 2, 2, 2],
    },
    "Clf": {
        "in_channels": 1, "num_cls": 10, "resnet_name": "resnet18",
        "pretrained": False,
    },
    "trainer": {
        "max_epochs": 30, "batch_size": 256, "lr": 0.0005, "ema_rate": 0.99,
        "figsize_unit": 3.6,
    },
}

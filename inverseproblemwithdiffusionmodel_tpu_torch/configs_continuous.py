"""Continuous-stack config tree (VE/VP/subVP x NCSN++/DDPM++/DDPM/NCSN).

Port of inverseproblemwithdiffusionmodel_tpu/configs_continuous.py: the same
per-dataset defaults, model presets and leaf registry, so
`get_continuous_config("ve/ffhq_256_ncsnpp_continuous")` gives the same tree
in both packages; `make_sde` builds the VE, VP and subVP SDEs.
"""
from __future__ import annotations

from .config import Config

# ---------------------------------------------------------------------------
# per-dataset defaults (reference: configs/default_{cifar10,celeba,lsun}_configs.py)
# ---------------------------------------------------------------------------

_DATASET_DEFAULTS = {
    "cifar10": dict(dataset="CIFAR10", image_size=32, batch_size=128,
                    n_iters=1300001, preempt=10000, snr=0.16,
                    eval_begin=9, eval_end=26, eval_batch=1024,
                    eval_sampling=False, sigma_max=50, num_scales=1000,
                    dropout=0.1),
    "celeba": dict(dataset="CELEBA", image_size=64, batch_size=128,
                   n_iters=1300001, preempt=10000, snr=0.17,
                   eval_begin=1, eval_end=26, eval_batch=1024,
                   eval_sampling=True, sigma_max=90.0, num_scales=1000,
                   dropout=0.1),
    "lsun": dict(dataset="LSUN", image_size=256, batch_size=64,
                 n_iters=2400001, preempt=5000, snr=0.075,
                 eval_begin=50, eval_end=96, eval_batch=512,
                 eval_sampling=True, sigma_max=378, num_scales=2000,
                 dropout=0.0),
}


def get_default_configs(dataset: str = "cifar10") -> Config:
    """Per-dataset base tree (reference: configs/default_*_configs.py)."""
    ds = _DATASET_DEFAULTS[dataset]
    return Config({
        "training": {
            "batch_size": ds["batch_size"], "n_iters": ds["n_iters"],
            "snapshot_freq": 50000, "log_freq": 50, "eval_freq": 100,
            "snapshot_freq_for_preemption": ds["preempt"],
            "snapshot_sampling": True, "likelihood_weighting": False,
            "continuous": True, "reduce_mean": False, "sde": "vesde",
        },
        "sampling": {
            "n_steps_each": 1, "noise_removal": True,
            "probability_flow": False, "snr": ds["snr"], "method": "pc",
            "predictor": "reverse_diffusion", "corrector": "langevin",
        },
        "eval": {
            "begin_ckpt": ds["eval_begin"], "end_ckpt": ds["eval_end"],
            "batch_size": ds["eval_batch"],
            "enable_sampling": ds["eval_sampling"], "num_samples": 50000,
            "enable_loss": True, "enable_bpd": False, "bpd_dataset": "test",
        },
        "data": {
            "dataset": ds["dataset"], "image_size": ds["image_size"],
            "random_flip": True, "centered": False,
            "uniform_dequantization": False, "num_channels": 3,
            "channels": 3,
        },
        "model": {
            "sigma_min": 0.01, "sigma_max": ds["sigma_max"],
            "num_scales": ds["num_scales"], "beta_min": 0.1,
            "beta_max": 20.0, "dropout": ds["dropout"],
            "embedding_type": "fourier",
        },
        "optim": {
            "weight_decay": 0, "optimizer": "Adam", "lr": 2e-4,
            "beta1": 0.9, "amsgrad": False, "eps": 1e-8, "warmup": 5000,
            "grad_clip": 1.0,
        },
        "seed": 42,
    })


# ---------------------------------------------------------------------------
# model presets
# ---------------------------------------------------------------------------

def _m(d):
    return {f"model.{k}": v for k, v in d.items()}


# reference: configs/ve/cifar10_ncsnpp_continuous.py:36-58
_VE_NCSNPP = dict(
    name="ncsnpp", scale_by_sigma=True, ema_rate=0.999,
    normalization="GroupNorm", nonlinearity="swish", nf=128,
    ch_mult=(1, 2, 2, 2), num_res_blocks=4, attn_resolutions=(16,),
    resamp_with_conv=True, conditional=True, fir=True,
    fir_kernel=[1, 3, 3, 1], skip_rescale=True, resblock_type="biggan",
    progressive="none", progressive_input="residual",
    progressive_combine="sum", attention_type="ddpm", init_scale=0.0,
    fourier_scale=16, conv_size=3)

# reference: configs/vp/cifar10_ncsnpp.py / subvp/cifar10_ncsnpp_continuous.py
_VPSUBVP_NCSNPP = dict(_VE_NCSNPP, scale_by_sigma=False, ema_rate=0.9999,
                       embedding_type="positional")

# reference: configs/ve/{church,bedroom,celebahq_256,ffhq_256}_ncsnpp_continuous.py
_LSUN_NCSNPP = dict(_VE_NCSNPP, ch_mult=(1, 1, 2, 2, 2, 2, 2),
                    num_res_blocks=2, progressive="output_skip",
                    progressive_input="input_skip",
                    embedding_type="fourier")

# reference: configs/ve/{celebahq,ffhq}_ncsnpp_continuous.py (1024px pyramid)
_HQ1024_NCSNPP = dict(_VE_NCSNPP, nf=16, ch_mult=(1, 2, 4, 8, 16, 32, 32, 32),
                      num_res_blocks=1, ema_rate=0.9999, sigma_max=1348,
                      num_scales=2000, dropout=0.0,
                      progressive="output_skip",
                      progressive_input="input_skip",
                      embedding_type="fourier")

# reference: configs/vp/cifar10_ddpmpp_continuous.py
_DDPMPP = dict(
    name="ncsnpp", scale_by_sigma=False, ema_rate=0.9999,
    normalization="GroupNorm", nonlinearity="swish", nf=128,
    ch_mult=(1, 2, 2, 2), num_res_blocks=4, attn_resolutions=(16,),
    resamp_with_conv=True, conditional=True, fir=False,
    fir_kernel=[1, 3, 3, 1], skip_rescale=True, resblock_type="biggan",
    progressive="none", progressive_input="none",
    progressive_combine="sum", attention_type="ddpm", init_scale=0.0,
    embedding_type="positional", fourier_scale=16, conv_size=3)

# reference: configs/vp/ddpm/cifar10.py (embedding stays the dataset default)
_DDPM = dict(
    name="ddpm", scale_by_sigma=False, ema_rate=0.9999,
    normalization="GroupNorm", nonlinearity="swish", nf=128,
    ch_mult=(1, 2, 2, 2), num_res_blocks=2, attn_resolutions=(16,),
    resamp_with_conv=True, conditional=True, init_scale=0.0)

# reference: configs/vp/ddpm/{celebahq,bedroom,church}.py
_DDPM_LSUN = dict(_DDPM, ch_mult=(1, 1, 2, 2, 4, 4), num_scales=1000)

# SDE/sampling blocks ------------------------------------------------------

_VE_CONT = {"training.sde": "vesde", "training.continuous": True,
            "sampling.predictor": "reverse_diffusion",
            "sampling.corrector": "langevin"}
_VE_DISC = dict(_VE_CONT, **{"training.continuous": False})
_VP_CONT = {"training.sde": "vpsde", "training.continuous": True,
            "training.reduce_mean": True, "data.centered": True,
            "sampling.predictor": "euler_maruyama",
            "sampling.corrector": "none"}
_SUBVP_CONT = dict(_VP_CONT, **{"training.sde": "subvpsde"})
_DEEP = {"training.n_iters": 950001, "model.num_res_blocks": 8}

# discrete NCSN v1 (reference: configs/ve/ncsn/cifar10.py) — `num_classes`
# and `ngf` are this framework's aliases for the discrete-stack model ctors
_NCSN1 = {
    "training.sde": "vesde", "training.continuous": False,
    "sampling.predictor": "none", "sampling.corrector": "ald",
    "sampling.n_steps_each": 100, "sampling.snr": 0.316,
    **_m(dict(name="ncsn", scale_by_sigma=False, sigma_max=1.0,
              num_scales=10, num_classes=10, ema_rate=0.0,
              normalization="InstanceNorm++", nonlinearity="elu", nf=128,
              ngf=128, interpolation="bilinear")),
    "optim.lr": 1e-3, "optim.warmup": 0, "optim.grad_clip": -1.0,
}

# discrete NCSNv2 (reference: configs/ve/ncsnv2/cifar10.py)
_NCSNV2 = {
    "training.sde": "vesde", "training.continuous": False,
    "sampling.predictor": "none", "sampling.corrector": "ald",
    "sampling.n_steps_each": 5, "sampling.snr": 0.176,
    **_m(dict(name="ncsnv2_64", scale_by_sigma=True, num_scales=232,
              num_classes=232, ema_rate=0.999,
              normalization="InstanceNorm++", nonlinearity="elu", nf=128,
              ngf=128, interpolation="bilinear")),
    "optim.lr": 1e-4, "optim.warmup": 0, "optim.grad_clip": -1.0,
}


def _ncsn1_ablation(n_steps, snr, num_scales, ema, sigma_max=None):
    """NCSN v1 'techniques' ablations (configs/ve/ncsn/*_{5,124,1245}.py):
    n_steps/snr/num_scales per recipe; sigma_max reverts to the dataset
    default unless pinned; EMA on only when technique 5 is included."""
    u = dict(_NCSN1)
    u["sampling.n_steps_each"] = n_steps
    u["sampling.snr"] = snr
    u["model.num_scales"] = num_scales
    u["model.num_classes"] = num_scales
    u["model.ema_rate"] = ema
    if sigma_max is None:
        del u["model.sigma_max"]
    else:
        u["model.sigma_max"] = sigma_max
    return u


# ---------------------------------------------------------------------------
# the leaf registry: reference path -> (base dataset, updates)
# ---------------------------------------------------------------------------

_LEAF_SPECS = {
    # --- ve ---------------------------------------------------------------
    "ve/cifar10_ncsnpp": ("cifar10", {
        **_VE_DISC, **_m(dict(_VE_NCSNPP, embedding_type="positional"))}),
    "ve/cifar10_ncsnpp_continuous": ("cifar10", {
        **_VE_CONT, **_m(dict(_VE_NCSNPP, embedding_type="fourier"))}),
    "ve/cifar10_ncsnpp_deep_continuous": ("cifar10", {
        **_VE_CONT, **_m(dict(_VE_NCSNPP, embedding_type="fourier")),
        **_DEEP}),
    "ve/cifar10_ddpm": ("cifar10", {
        **_VE_DISC, **_m(dict(_DDPM, scale_by_sigma=True, ema_rate=0.999,
                              conv_size=3))}),
    "ve/celeba_ncsnpp": ("celeba", {
        **_VE_DISC, **_m(dict(_VE_NCSNPP, embedding_type="positional",
                              sigma_begin=90))}),
    "ve/celebahq_ncsnpp_continuous": ("lsun", {
        **_VE_CONT, **_m(_HQ1024_NCSNPP),
        "training.batch_size": 8,
        "training.snapshot_freq_for_preemption": 5000,
        "sampling.snr": 0.15, "eval.begin_ckpt": 1, "eval.end_ckpt": 96,
        "eval.batch_size": 1024,
        "data.dataset": "CelebAHQ", "data.image_size": 1024}),
    "ve/ffhq_ncsnpp_continuous": ("lsun", {
        **_VE_CONT, **_m(_HQ1024_NCSNPP),
        "training.batch_size": 8, "training.reduce_mean": True,
        "training.snapshot_freq_for_preemption": 5000,
        "sampling.snr": 0.15, "eval.begin_ckpt": 1, "eval.end_ckpt": 96,
        "eval.batch_size": 1024,
        "data.dataset": "FFHQ", "data.image_size": 1024}),
    "ve/celebahq_256_ncsnpp_continuous": ("lsun", {
        **_VE_CONT, **_m(dict(_LSUN_NCSNPP, sigma_max=348)),
        "data.dataset": "CelebAHQ", "data.image_size": 256}),
    "ve/ffhq_256_ncsnpp_continuous": ("lsun", {
        **_VE_CONT, **_m(dict(_LSUN_NCSNPP, sigma_max=348)),
        "data.dataset": "FFHQ", "data.image_size": 256}),
    "ve/bedroom_ncsnpp_continuous": ("lsun", {
        **_VE_CONT, **_m(_LSUN_NCSNPP), "data.category": "bedroom"}),
    "ve/church_ncsnpp_continuous": ("lsun", {
        **_VE_CONT, **_m(dict(_LSUN_NCSNPP, sigma_max=380)),
        "data.category": "church_outdoor"}),
    # discrete v1/v2 trees
    "ve/ncsn/cifar10": ("cifar10", dict(_NCSN1)),
    "ve/ncsn/cifar10_5": ("cifar10",
                          _ncsn1_ablation(100, 0.316, 10, 0.999,
                                          sigma_max=1.0)),
    "ve/ncsn/cifar10_124": ("cifar10", _ncsn1_ablation(5, 0.176, 232, 0.0)),
    "ve/ncsn/cifar10_1245": ("cifar10",
                             _ncsn1_ablation(5, 0.176, 232, 0.999)),
    "ve/ncsn/celeba": ("celeba", {**_NCSN1, "training.loss": "vesde"}),
    "ve/ncsn/celeba_5": ("celeba",
                         _ncsn1_ablation(100, 0.316, 10, 0.999,
                                         sigma_max=1.0)),
    "ve/ncsn/celeba_124": ("celeba", _ncsn1_ablation(5, 0.128, 500, 0.0)),
    "ve/ncsn/celeba_1245": ("celeba", _ncsn1_ablation(5, 0.128, 500, 0.999)),
    "ve/ncsnv2/cifar10": ("cifar10", dict(_NCSNV2)),
    "ve/ncsnv2/celeba": ("celeba", {
        **_NCSNV2, "sampling.snr": 0.128,
        "model.num_scales": 500, "model.num_classes": 500}),
    "ve/ncsnv2/bedroom": ("lsun", {
        **_NCSNV2, "training.batch_size": 128,
        "sampling.n_steps_each": 3, "sampling.snr": 0.095,
        "data.category": "bedroom", "data.image_size": 128,
        **_m(dict(name="ncsnv2_128", sigma_max=190, num_scales=1086,
                  num_classes=1086, ema_rate=0.9999))}),
    # --- vp ---------------------------------------------------------------
    "vp/cifar10_ncsnpp": ("cifar10", {
        **_VP_CONT, "training.continuous": False,
        "sampling.predictor": "reverse_diffusion",
        **_m(_VPSUBVP_NCSNPP)}),
    "vp/cifar10_ncsnpp_continuous": ("cifar10", {
        **_VP_CONT, **_m(_VPSUBVP_NCSNPP)}),
    "vp/cifar10_ncsnpp_deep_continuous": ("cifar10", {
        **_VP_CONT, **_m(_VPSUBVP_NCSNPP), **_DEEP}),
    "vp/cifar10_ddpmpp": ("cifar10", {
        **_VP_CONT, "training.continuous": False,
        "sampling.predictor": "ancestral_sampling", **_m(_DDPMPP)}),
    "vp/cifar10_ddpmpp_continuous": ("cifar10", {
        **_VP_CONT, **_m(_DDPMPP)}),
    "vp/cifar10_ddpmpp_deep_continuous": ("cifar10", {
        **_VP_CONT, **_m(_DDPMPP), **_DEEP}),
    "vp/ddpm/cifar10": ("cifar10", {
        **_VP_CONT, "training.continuous": False,
        "sampling.predictor": "ancestral_sampling", **_m(_DDPM)}),
    "vp/ddpm/cifar10_continuous": ("cifar10", {
        **_VP_CONT, **_m(_DDPM)}),
    "vp/ddpm/cifar10_unconditional": ("cifar10", {
        **_VP_CONT, "training.continuous": False,
        "sampling.predictor": "ancestral_sampling",
        **_m(dict(_DDPM, conditional=False))}),
    "vp/ddpm/celebahq": ("lsun", {
        **_VP_CONT, "training.continuous": False,
        "sampling.predictor": "ancestral_sampling", **_m(_DDPM_LSUN),
        "data.dataset": "CelebAHQ", "data.image_size": 256,
        "optim.lr": 2e-5}),
    "vp/ddpm/bedroom": ("lsun", {
        **_VP_CONT, "training.continuous": False,
        "sampling.predictor": "ancestral_sampling", **_m(_DDPM_LSUN),
        "data.category": "bedroom", "optim.lr": 2e-5}),
    "vp/ddpm/church": ("lsun", {
        **_VP_CONT, "training.continuous": False,
        "sampling.predictor": "ancestral_sampling", **_m(_DDPM_LSUN),
        "data.category": "church_outdoor", "optim.lr": 2e-5}),
    # --- subvp ------------------------------------------------------------
    "subvp/cifar10_ncsnpp_continuous": ("cifar10", {
        **_SUBVP_CONT, **_m(_VPSUBVP_NCSNPP)}),
    "subvp/cifar10_ncsnpp_deep_continuous": ("cifar10", {
        **_SUBVP_CONT, **_m(_VPSUBVP_NCSNPP), **_DEEP}),
    "subvp/cifar10_ddpmpp_continuous": ("cifar10", {
        **_SUBVP_CONT, **_m(_DDPMPP)}),
    "subvp/cifar10_ddpmpp_deep_continuous": ("cifar10", {
        **_SUBVP_CONT, **_m(_DDPMPP), **_DEEP}),
    "subvp/cifar10_ddpm_continuous": ("cifar10", {
        **_SUBVP_CONT, **_m(_DDPM)}),
}


def get_continuous_config(name: str) -> Config:
    """Build a leaf config from a reference-style path
    (e.g. 've/cifar10_ncsnpp_continuous', 'vp/ddpm/cifar10',
    've/ncsn/celeba_1245'); see _LEAF_SPECS for the full registry."""
    if name not in _LEAF_SPECS:
        raise KeyError(f"unknown continuous config {name!r}; known: "
                       f"{sorted(_LEAF_SPECS)}")
    dataset, updates = _LEAF_SPECS[name]
    return get_default_configs(dataset).replace(**updates)


def list_continuous_configs():
    return sorted(_LEAF_SPECS)


def make_sde(config):
    """SDE instance from a continuous config (dispatch on
    config.training.sde)."""
    from .sde import VESDE, VPSDE, subVPSDE
    name = config.training.sde.lower()
    m = config.model
    if name == "vesde":
        return VESDE(N=m.num_scales, sigma_min=m.sigma_min,
                     sigma_max=m.sigma_max)
    if name == "vpsde":
        return VPSDE(N=m.num_scales, beta_min=m.beta_min, beta_max=m.beta_max)
    if name == "subvpsde":
        return subVPSDE(N=m.num_scales, beta_min=m.beta_min,
                        beta_max=m.beta_max)
    raise ValueError(f"unknown SDE {config.training.sde!r}")

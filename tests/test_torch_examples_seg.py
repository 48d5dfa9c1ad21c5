"""The port's segmentation-guided ALD ablation against the JAX example at
a tiny setting on the CPU (examples/acdc_seg_guidance.py, run as it is),
on a prior and a seg net the port writes and both load.

Held within ARG_TOL (1e-6 of the largest magnitude): the reconstructor
factory's arguments (the ladder, the masked-Fourier operator, the
proximal's operator, the ALD config, the data-consistency weight, and
the guidance's label map, weight, start and mode) and the measurement
each run starts from. The ZF row (NRMSE, SSIM, Dice) within 1e-4
(results rounded to 4 decimals), the clean seg net's Dice within 1e-2
(argmax maps of one net's two forwards), the result keys. The ALD rows
come from other noise streams and are checked to be finite.
"""
import json

import numpy as np
import torch

from inverseproblemwithdiffusionmodel_tpu_torch.examples import (
    _common, acdc_seg_guidance as pseg)
from inverseproblemwithdiffusionmodel_tpu_torch.models.ncsnv2 import NCSNv2
from inverseproblemwithdiffusionmodel_tpu_torch.models.unet import UNet
from inverseproblemwithdiffusionmodel_tpu_torch.utils import artifacts
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    seeded_weights)
from tests.torch_examples_common import (
    Recorder, assert_same, load_jax_example, same_call)

torch.set_num_threads(2)

RECON = "make_stepped_pair_reconstructor"

SEG_ARGS = ["--size", "32", "--ngf", "8", "--n_train", "8", "--levels", "3",
            "--n_steps_each", "1", "--chains", "2", "--n_test", "1",
            "--lr_scaled_grid", "3e4", "--seg_lamda_grid", "10",
            "--seg_start_time", "0.5", "--seg_mode", "FG"]


def test_seg_guidance_matches_jax(tmp_path):
    """Both runs on one prior and one seg net (Flax files the port
    writes, in each run's --out)."""
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        artifacts.save_prior(seeded_weights(NCSNv2(
            _common.ncsn_config(1, 32, 8)), 0, std_scale=0.1),
            str(tmp_path / side / "prior.msgpack"))
        artifacts.save_prior(seeded_weights(UNet(
            out_channels=2, features=(32, 64, 128), strides=(2, 2),
            ndim=2), 1), str(tmp_path / side / "seg.msgpack"))
    js = load_jax_example("acdc_seg_guidance", tmp_path / "home")
    with Recorder() as jrec:
        jrec.wrap(js, RECON, returns=True)
        jrows = js.main(SEG_ARGS + ["--out", str(tmp_path / "jax")])
    with Recorder() as prec:
        prec.wrap(pseg, RECON, returns=True)
        prows = pseg.main(SEG_ARGS + ["--out", str(tmp_path / "port"),
                                      "--device", "cpu"])
    assert set(prows) == set(jrows) == {"ZF", "ALD", "ALD+seg"}
    for metric in ("nrmse", "ssim", "dice"):
        assert abs(prows["ZF"][metric] - jrows["ZF"][metric]) <= 1e-4, metric
    for name in ("ALD", "ALD+seg"):
        assert np.isfinite(list(prows[name].values())).all()
    pj = json.load(open(tmp_path / "port" / "results.json"))
    jj = json.load(open(tmp_path / "jax" / "results.json"))
    assert set(pj) == set(jj)
    assert abs(pj["tuned"]["clean_seg_dice"]
               - jj["tuned"]["clean_seg_dice"]) <= 1e-2
    jc, pc = jrec.calls, prec.calls
    assert len(pc[RECON]) == len(jc[RECON]) == 4   # val x 2, test x 2
    for p, j in zip(pc[RECON], jc[RECON]):
        same_call(p, j, RECON, positions=[(1, 1), (2, 2), (4, 4)],
                  keywords=["lr_scaled"])
        assert_same(p[0][3].lin_tfm, j[0][3].lin_tfm, "proximal.lin_tfm")
        assert ("seg_label" in p[1]) == ("seg_label" in j[1])
        if "seg_label" in j[1]:
            same_call(p, j, RECON, keywords=[
                "seg_label", "seg_lamda", "seg_start_time", "seg_mode"])
    for p, j in zip(pc[RECON + "()"], jc[RECON + "()"]):
        assert_same(p[0][0], j[0][1], "yrB")
        assert_same(p[0][1], j[0][2], "yiB")

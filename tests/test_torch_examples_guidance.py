"""The port's train-and-reconstruct demo against the JAX example at a
tiny setting on the CPU (examples/train_and_reconstruct_demo.py, run as
it is).

Held within ARG_TOL (1e-6 of the largest magnitude): the trainer's
ladder and data mode, and every training batch; the reconstructor
factory's arguments (the ladder, the masked-Fourier operator, the
proximal's operator and CG count, the ALD config, the data-consistency
weight) and the measurement the chains start from; the original and ZF
arrays it saves. The ZF row within 1e-4, the result keys. The ALD row
comes from other noise streams and is checked to be finite.
"""
import json

import numpy as np
import torch

from inverseproblemwithdiffusionmodel_tpu_torch.examples import (
    train_and_reconstruct_demo as pdemo)
from tests.torch_examples_common import (
    Recorder, assert_same, load_jax_example, same_call)

torch.set_num_threads(2)

RECON = "make_stepped_pair_reconstructor"
STEP = "make_score_train_step"
DEMO_ARGS = ["--steps", "2", "--size", "32", "--ngf", "8", "--batch", "4",
             "--levels", "3", "--chains", "2", "--n_train", "8"]


def test_train_and_reconstruct_demo_matches_jax(tmp_path):
    jd = load_jax_example("train_and_reconstruct_demo", tmp_path / "home")
    with Recorder() as jrec:
        jrec.wrap(jd, STEP, returns=True)
        jrec.wrap(jd, RECON, returns=True)
        jm = jd.main(DEMO_ARGS + ["--out", str(tmp_path / "jax")])
    with Recorder() as prec:
        prec.wrap(pdemo, STEP, returns=True)
        prec.wrap(pdemo, RECON, returns=True)
        pm = pdemo.main(DEMO_ARGS + ["--out", str(tmp_path / "port"),
                                     "--device", "cpu"])
    assert set(pm) == set(jm)
    for k in ("zf_nrmse", "zf_ssim"):
        assert abs(pm[k] - jm[k]) <= 1e-4, k
    assert np.isfinite([pm["nrmse"], pm["ssim"]]).all()
    pargs = json.load(open(tmp_path / "port" / "args.json"))
    jargs = json.load(open(tmp_path / "jax" / "args.json"))
    assert set(pargs) - set(jargs) == {"device"}
    for name in ("original.npy", "ZF.npy", "reconstructions.npy"):
        p = np.load(tmp_path / "port" / name)
        j = np.load(tmp_path / "jax" / name)
        assert p.shape == j.shape and p.dtype == j.dtype
        if name != "reconstructions.npy":
            assert_same(np.stack([p.real, p.imag]),
                        np.stack([j.real, j.imag]), name)
    jc, pc = jrec.calls, prec.calls
    (p,), (j,) = pc[STEP], jc[STEP]
    same_call(p, j, STEP, positions=[(1, 1)], keywords=["data_mode"])
    pb = [c[0][1] for c in pc[STEP + "()"]]
    jb = [c[0][1] for c in jc[STEP + "()"]]
    assert len(pb) == len(jb) == 2
    for i, (a, b) in enumerate(zip(pb, jb)):
        assert_same(a, b, f"training batch {i}")
    (p,), (j,) = pc[RECON], jc[RECON]
    same_call(p, j, RECON, positions=[(1, 1), (2, 2), (4, 4)],
              keywords=["lr_scaled"])
    assert_same(p[0][3].lin_tfm, j[0][3].lin_tfm, "proximal.lin_tfm")
    assert p[0][3].num_iters == j[0][3].num_iters
    (p,), (j,) = pc[RECON + "()"], jc[RECON + "()"]
    assert_same(p[0][0], j[0][1], "yr_b")
    assert_same(p[0][1], j[0][2], "yi_b")

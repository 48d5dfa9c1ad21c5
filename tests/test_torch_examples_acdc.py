"""The port's ACDC SENSE ensemble against the JAX example at a tiny
setting on the CPU (examples/acdc_sense_ensemble.py, run as it is), on a
prior file the port writes and both load.

Held within ARG_TOL (1e-6 of the largest magnitude): the reconstructor
factory's arguments (the ladder, the chains' SENSE operator with its mask
and coil maps, the proximal's operator and CG count, the ALD config, the
data-consistency weight or its annealed schedule) and the measurement
each chain chunk starts from; the MAP and TV optimizers' arguments (the
measurement, the operator, the prior weight or regularizer weight, the
config). The ZF row within 1e-4 (4 decimals); the MAP and TV rows within
rel ROW_TOL (3e-2), the same prior on both sides; the result keys. The
ALD rows come from other noise streams and are checked to be finite.
"""
import json

import numpy as np
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu_torch.examples import (
    acdc_sense_ensemble as pens)
from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
    get_network)
from inverseproblemwithdiffusionmodel_tpu_torch.examples import _common
from inverseproblemwithdiffusionmodel_tpu_torch.utils import artifacts
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    seeded_weights)
from tests.torch_examples_common import (
    NoJit, Recorder, assert_same, load_jax_example, rows_close, same_call)

torch.set_num_threads(2)

ENS_ARGS = ["--size", "32", "--ngf", "8", "--n_train", "8", "--levels", "4",
            "--n_steps_each", "1", "--chains", "3", "--chain_chunk", "2",
            "--map_iters", "5", "--map_lamdas", "0.3", "--tv_regs", "0.01",
            "--ald_lr_scaled_grid", "3e4", "1e5",
            "--ald_anneal_start", "0.1"]
RECON = "make_stepped_pair_reconstructor"


@pytest.fixture(scope="module")
def ens_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("acdc_ens")
    prior = str(tmp / "prior.msgpack")
    artifacts.save_prior(seeded_weights(get_network(
        _common.ncsn_config(1, 32, 8)), 0, std_scale=0.1), prior)
    jm = load_jax_example("acdc_sense_ensemble", tmp / "home")
    real_jax = jm.jax
    jm.jax = NoJit()
    try:
        with Recorder() as jrec:
            jrec.wrap(jm, RECON, returns=True)
            jrec.wrap(jm, "map_optimizer_pair")
            jrec.wrap(jm, "tv_reconstruction_pair")
            jres = jm.main(ENS_ARGS + ["--prior_path", prior,
                                       "--out", str(tmp / "jax")])
    finally:
        jm.jax = real_jax
    with Recorder() as prec:
        prec.wrap(pens, RECON, returns=True)
        prec.wrap(pens, "map_optimizer_pair")
        prec.wrap(pens, "tv_reconstruction_pair")
        pres = pens.main(ENS_ARGS + ["--prior_path", prior, "--out",
                                     str(tmp / "port"), "--device", "cpu"])
    return dict(jres=jres, pres=pres, jrec=jrec.calls, prec=prec.calls,
                tmp=tmp, prior=prior)


def test_ensemble_rows_and_files(ens_runs):
    j, p = ens_runs["jres"], ens_runs["pres"]
    assert set(p) == set(j) == {"ZF", "ALD", "MAP", "TV"}
    for metric in ("nrmse", "ssim"):
        assert abs(p["ZF"][metric] - j["ZF"][metric]) <= 1e-4
    rows_close(p, j, ["MAP", "TV"], where="acdc ensemble")
    assert np.isfinite([p["ALD"]["nrmse"], p["ALD"]["ssim"]]).all()
    pj = json.load(open(ens_runs["tmp"] / "port" / "results.json"))
    jj = json.load(open(ens_runs["tmp"] / "jax" / "results.json"))
    assert set(pj) == set(jj) and set(pj["args"]) >= set(jj["args"])
    assert (ens_runs["tmp"] / "port" / "metrics.txt").exists()


def test_ensemble_reconstructor_arguments(ens_runs):
    jc, pc = ens_runs["jrec"], ens_runs["prec"]
    # two val probes of the lr grid, then the test ensemble
    assert len(pc[RECON]) == len(jc[RECON]) == 3
    for p, j in zip(pc[RECON][:2], jc[RECON][:2]):
        same_call(p, j, RECON, positions=[(1, 1), (2, 2), (4, 4)],
                  keywords=["lr_scaled"])
        assert_same(p[0][3].lin_tfm, j[0][3].lin_tfm, "proximal.lin_tfm")
        assert p[0][3].num_iters == j[0][3].num_iters
    # the measurements: JAX recon(params, yr, yi, key)
    pr, jr = pc[RECON + "()"], jc[RECON + "()"]
    assert len(pr) == len(jr) == 4           # 2 val probes, 2 test chunks
    for p, j in zip(pr, jr):
        assert_same(p[0][0], j[0][1], "yr")
        assert_same(p[0][1], j[0][2], "yi")


def test_ensemble_map_and_tv_arguments(ens_runs):
    jc, pc = ens_runs["jrec"], ens_runs["prec"]
    key = "map_optimizer_pair"
    assert len(pc[key]) == len(jc[key]) == 2          # val, then test
    for p, j in zip(pc[key], jc[key]):
        same_call(p, j, key, positions=[(1, 1), (2, 2), (3, 3)],
                  keywords=["config"])
    key = "tv_reconstruction_pair"
    assert len(pc[key]) == len(jc[key]) == 2
    for p, j in zip(pc[key], jc[key]):
        same_call(p, j, key, positions=[(0, 0), (1, 1)],
                  keywords=["reg_weight", "config"])

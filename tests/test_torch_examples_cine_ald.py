"""The port's cine quality matrix, its ALD variants, against the JAX
example at a tiny setting on the CPU, on prior files the port trains and
the JAX script loads (examples/cine_2d_time_quality_matrix.py, run as it
is; the trainers are held in test_torch_examples_cine.py).

Held within ARG_TOL (1e-6 of the largest magnitude): every numeric
argument of the reconstructor factory (the ladders, the chains' SENSE
operator with its per-frame mask and coil maps, the proximal's operator
and CG count, the ALD config, the data-consistency and temporal weights,
the shift, window and frames) and the measurement each chain starts
from; the ZF row within 1e-4. The ALD rows come from other noise
streams (torch generators against JAX keys) and are only checked to be
finite.
"""
import numpy as np
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu_torch.examples import (
    cine_2d_time_quality_matrix as pmatrix)
from tests.torch_examples_common import (
    assert_same, port_priors, run_both, same_call)

torch.set_num_threads(2)

KEY = "make_stepped_2d_time_pair_reconstructor"


@pytest.fixture(scope="module")
def ald_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cine_ald")
    return run_both(tmp, "ALD", [(KEY, True)],
                    [(pmatrix, KEY, True)], prior_dir=port_priors(tmp))


def test_jax_reads_the_port_priors(ald_runs):
    """The JAX script loaded the port-trained files (it trains nothing
    where they exist) and reconstructed with them."""
    j = ald_runs["jres"]["R_8"]
    assert set(j) == {"ZF", "ALD"}
    assert np.isfinite([j["ALD"]["nrmse"], j["ALD"]["ssim"]]).all()


def test_ald_rows_and_zf(ald_runs):
    j, p = ald_runs["jres"]["R_8"], ald_runs["pres"]["R_8"]
    assert set(p) == set(j)
    for metric in ("nrmse", "ssim"):
        assert abs(p["ZF"][metric] - j["ZF"][metric]) <= 1e-4
    for name in ("ALD",):
        assert np.isfinite([p[name]["nrmse"], p[name]["ssim"]]).all()


def test_reconstructor_arguments(ald_runs):
    jc, pc = ald_runs["jrec"], ald_runs["prec"]
    assert len(pc[KEY]) == len(jc[KEY]) == 2      # 2 videos
    for p, j in zip(pc[KEY], jc[KEY]):
        same_call(p, j, KEY, positions=[(2, 2), (3, 3), (4, 4), (6, 6)],
                  keywords=["lr_scaled", "mode_T", "lamda_T",
                            "if_random_shift", "win_size", "num_frames"])
        assert_same(p[0][5].lin_tfm, j[0][5].lin_tfm, "proximal.lin_tfm")
        assert p[0][5].num_iters == j[0][5].num_iters
    # the measurement: JAX recon(params_S, params_T, yr, yi, key), the
    # port's recon(yr, yi, seed=...)
    assert len(pc[KEY + "()"]) == len(jc[KEY + "()"]) == 2
    for p, j in zip(pc[KEY + "()"], jc[KEY + "()"]):
        assert_same(p[0][0], j[0][2], "yrB")
        assert_same(p[0][1], j[0][3], "yiB")

"""The port's cine quality matrix against the JAX example at a tiny
setting on the CPU (examples/cine_2d_time_quality_matrix.py, run as it
is): both train their priors, then the TV variant. The ALD and MAP
variants are held in test_torch_examples_cine_ald.py and _cine_map.py,
on priors the port trains, which the JAX script loads.

Held: the results' keys; the deterministic inputs (training data, the
ladders, the per-frame mask, the coil maps, the measurement) and every
numeric argument of the sampler, optimizer and trainer calls, recorded on
both sides, within ARG_TOL (1e-6 of the largest magnitude); the ZF row
within 1e-4 (results are rounded to 4 decimals); with the JAX run's
prior files loaded by the port, the MAP and TV rows within rel ROW_TOL
(3e-2). The ALD rows come from other noise streams and are not compared.
"""
import json

import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu_torch.examples import (
    _common as pcommon, cine_2d_time_quality_matrix as pmatrix)
from tests.torch_examples_common import (
    Recorder, assert_same, port_priors, rows_close, run_both, same_call)

torch.set_num_threads(2)

@pytest.fixture(scope="module")
def matrix_runs(tmp_path_factory):
    """Both scripts train their priors (the TV variant alone after it):
    the trainers' calls, the data, ladders, ZF and TV rows."""
    tmp = tmp_path_factory.mktemp("cine_matrix")
    out = run_both(tmp, "TV", [("make_score_train_step", True),
                               ("tv_reconstruction_pair", False),
                               ("get_optimizer", False)],
                   [(pcommon, "make_score_train_step", True),
                    (pmatrix, "tv_reconstruction_pair", False),
                    (pcommon, "get_optimizer", False)])
    # the port's run above loaded the JAX run's priors; this one trains
    with Recorder() as prec:
        prec.wrap(pcommon, "make_score_train_step", returns=True)
        prec.wrap(pcommon, "get_optimizer")
        out["prior_dir"] = port_priors(tmp)
    out["prec"].update(prec.calls)
    return out


def test_matrix_writes_the_jax_results(matrix_runs):
    jj = json.load(open(matrix_runs["jout"] / "results_partial.json"))
    pj = json.load(open(matrix_runs["pout"] / "results_partial.json"))
    assert set(pj) >= set(jj)
    assert set(pj["results"]["R_8"]) == set(jj["results"]["R_8"])
    for name, row in pj["results"]["R_8"].items():
        assert {"nrmse", "ssim"} <= set(row)
        assert (matrix_runs["pout"] / "R_8" / name / "metrics.txt").exists()
    assert pj["tuned_hyperparams"].keys() == jj["tuned_hyperparams"].keys()
    # the ports' prior files load in either package (port-trained ones
    # are written in the Flax layout)
    for name in ("spatial.msgpack", "temporal.msgpack"):
        assert (matrix_runs["prior_dir"] / name).exists()


def test_matrix_zf_and_tv_rows(matrix_runs):
    """ZF depends on the data, mask and maps alone; TV on no prior."""
    j, p = matrix_runs["jres"]["R_8"], matrix_runs["pres"]["R_8"]
    for metric in ("nrmse", "ssim"):
        assert abs(p["ZF"][metric] - j["ZF"][metric]) <= 1e-4
    rows_close(p, j, ["TV"], where="cine matrix")


def test_matrix_tv_arguments(matrix_runs):
    jc, pc = matrix_runs["jrec"], matrix_runs["prec"]
    key = "tv_reconstruction_pair"
    # video 0 (the regularizer grid, two values), then video 1
    assert len(pc[key]) == len(jc[key]) == 3
    for p, j in zip(pc[key], jc[key]):
        same_call(p, j, key, positions=[(0, 0), (1, 1)],
                  keywords=["reg_weight", "config"])


def test_matrix_trainer_arguments(matrix_runs):
    """The port's own priors' training: the same ladders, data mode,
    optimizer settings and first batches as the JAX trainer's."""
    jc, pc = matrix_runs["jrec"], matrix_runs["prec"]
    key = "make_score_train_step"
    assert len(pc[key]) == len(jc[key]) == 2
    for p, j in zip(pc[key], jc[key]):
        same_call(p, j, key, positions=[(1, 1)], keywords=["data_mode"])
    # first batch of each trainer: JAX step(state, batch, key)
    jb = [c[0][1] for c in jc[key + "()"]]
    pb = [c[0][1] for c in pc[key + "()"]]
    assert len(jb) == len(pb) == 4
    for i, (a, b) in enumerate(zip(pb, jb)):
        assert_same(a, b, f"training batch {i}")
    for p, j in zip(pc["get_optimizer"], jc["get_optimizer"]):
        assert_same(p[0][0].optim, j[0][0].optim, "optim config")


def test_matrix_phase_is_the_jax_prng():
    """The phase field: jax.random.normal(PRNGKey(3), (2, 5, 5, 1)) resized,
    computed without JAX."""
    import jax
    from inverseproblemwithdiffusionmodel_tpu.ops.resize import (
        resize_align_corners)
    ref = resize_align_corners(jax.random.normal(jax.random.PRNGKey(3),
                                                 (2, 5, 5, 1)),
                               (16, 16), axes=(1, 2))
    assert_same(pcommon.phase_field(3, 2, 16), ref, "phase", 1e-6)

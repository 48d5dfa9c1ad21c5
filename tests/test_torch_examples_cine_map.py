"""The port's cine quality matrix, its MAP variants, and the cine serving
demo against the JAX examples at a tiny setting on the CPU, on prior
files the port trains and the JAX scripts load
(examples/cine_2d_time_quality_matrix.py and cine_serving_demo.py, run
as they are).

Held: every numeric argument of the MAP optimizer (the measurement, the
operator, the config, the prior weight, the temporal mode, window,
frames and prior label) within ARG_TOL (1e-6 of the largest magnitude);
the MAP rows within rel ROW_TOL (3e-2), the same prior on both sides;
the serving demo's engine inputs (ladders, spec, mask, coil maps) and
each request's measurement and mask within ARG_TOL, and its result keys.
"""
import numpy as np
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu_torch.examples import (
    cine_2d_time_quality_matrix as pmatrix, cine_serving_demo as pserve)
from tests.torch_examples_common import (
    assert_same, load_jax_example, port_priors, rows_close, run_both,
    same_call)

torch.set_num_threads(2)

KEY = "map_optimizer_2d_time_pair"


@pytest.fixture(scope="module")
def priors(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cine_map")
    return tmp, port_priors(tmp)


@pytest.fixture(scope="module")
def map_runs(priors):
    tmp, prior_dir = priors
    return run_both(tmp, "MAP", [(KEY, False)],
                    [(pmatrix, KEY, False)], prior_dir=prior_dir)


def test_map_rows(map_runs):
    j, p = map_runs["jres"]["R_8"], map_runs["pres"]["R_8"]
    assert set(p) == set(j) == {"ZF", "MAP"}
    rows_close(p, j, ["ZF", "MAP"], where="cine matrix")


def test_map_arguments(map_runs):
    jc, pc = map_runs["jrec"], map_runs["prec"]
    # video 0 (the prior-weight grid, one value), then video 1
    assert len(pc[KEY]) == len(jc[KEY]) == 2
    for p, j in zip(pc[KEY], jc[KEY]):
        same_call(p, j, KEY, positions=[(3, 3)],
                  keywords=["config", "prior_weight", "mode_T", "win_size",
                            "num_frames", "prior_label"])
        assert_same(p[0][2], j[0][2], "measurement")


SERVE_ARGS = ["--size", "16", "--T", "4", "--win", "2", "--ngf_s", "8",
              "--ngf_t", "8", "--n_train", "4", "--levels", "3",
              "--levels_t", "3", "--n_steps_each", "1", "--chains", "2",
              "--requests", "2"]


def test_cine_serving_demo_matches_jax(priors):
    """Both demos on the port-trained priors: the engine's ladders, spec,
    mask and coil maps, and each request's measurement and mask, as the
    JAX demo hands them to its engine; the result keys."""
    tmp, prior_dir = priors
    jd = load_jax_example("cine_serving_demo", tmp / "home")
    jcalls = []
    jreal = jd.CineReconstructionEngine

    class JEngine(jreal):
        def __init__(self, *a, **k):
            jcalls.append(("init", a, k))
            super().__init__(*a, **k)

        def reconstruct(self, *a, **k):
            jcalls.append(("reconstruct", a, k))
            return super().reconstruct(*a, **k)

    jd.CineReconstructionEngine = JEngine
    try:
        jres = jd.main(SERVE_ARGS + ["--priors", str(prior_dir),
                                     "--out", str(tmp / "serve_jax")])
    finally:
        jd.CineReconstructionEngine = jreal
    pcalls = []
    preal = pserve.CineReconstructionEngine

    class PEngine(preal):
        def __init__(self, *a, **k):
            pcalls.append(("init", a, k))
            super().__init__(*a, **k)

        def reconstruct(self, *a, **k):
            pcalls.append(("reconstruct", a, k))
            return super().reconstruct(*a, **k)

    pserve.CineReconstructionEngine = PEngine
    try:
        pres = pserve.main(SERVE_ARGS + ["--priors", str(prior_dir),
                                         "--out", str(tmp / "serve_port"),
                                         "--device", "cpu"])
    finally:
        pserve.CineReconstructionEngine = preal
    assert set(pres) == set(jres)
    assert [set(r) for r in pres["requests"]] == \
        [set(r) for r in jres["requests"]]
    assert pres["jit_cache_stable"]
    (_, ja, jk), (_, pa, pk) = jcalls[0], pcalls[0]
    assert_same(pa[1], ja[2], "sigmas_S")
    for name in ("sigmas_T", "mask", "sens_re", "sens_im", "spec"):
        assert_same(pk[name], jk[name], name)
    jr = [c for c in jcalls if c[0] == "reconstruct"]
    pr = [c for c in pcalls if c[0] == "reconstruct"]
    assert len(pr) == len(jr) == 2
    for i, ((_, pa, pk), (_, ja, jk)) in enumerate(zip(pr, jr)):
        assert_same(pa[0], ja[0], f"request {i} y_re")
        assert_same(pa[1], ja[1], f"request {i} y_im")
        for name in ("mask", "sens_re", "sens_im"):
            assert_same(pk[name], jk[name], f"request {i} {name}")
        assert pk["seed"] == jk["seed"]
    for r in pres["requests"]:
        assert np.isfinite([r["nrmse"], r["ssim"]]).all()

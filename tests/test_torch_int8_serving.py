"""Both serving engines in the int8 mode against the JAX engines in theirs,
on the CPU, and serve_recon --dtype int8 over HTTP for both workloads.

The geometries and nets are those of tests/test_torch_serving.py (the
ACDC engine: 16 px, NCSNv2 ngf 8, 3 levels x 2 inner steps, 4 chains) and
tests/test_torch_cine.py (the cine engine: 16 px, 3 frames, NCSNv2 ngf 8
and NCSN1D ngf 8 on 2 x 2 tubes); the port is fed the JAX engines' noise
(and shifts). The int8 score nets are chaotic (tests/test_torch_int8.py:
one float32 ulp of input moves their score as much as the int8 error), so
the two packages' chains part by about the int8 score error times the
step (INT8_REL below).
"""
import io
import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu.serving import (
    CineEngineSpec as JCineSpec, CineReconstructionEngine as JCineEngine)
from inverseproblemwithdiffusionmodel_tpu_torch.models import layers
from inverseproblemwithdiffusionmodel_tpu_torch.scripts import serve_recon
from inverseproblemwithdiffusionmodel_tpu_torch.serving.server import serve
from tests import test_torch_cine as tc
from tests import test_torch_serving as ts

torch.set_num_threads(1)

# Relative L2 of the port's int8 chains to JAX's, the largest over x_re,
# x_im, mean_mag and std_mag. Read here: ACDC 3.1e-3 (x_im; 3.0e-3 with
# the seg guidance), cine 7.9e-4 (std_mag); the gate sits three to ten
# times above.
INT8_REL = 1e-2


@pytest.fixture(scope="module")
def acdc():
    return ts.setup.__wrapped__()


@pytest.fixture(scope="module")
def cine():
    return tc.setup.__wrapped__()


def _held(ours, ref, tol):
    rels = {}
    for name in ("x_re", "x_im", "mean_mag", "std_mag"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.shape == b.shape and np.isfinite(a).all()
        rels[name] = ts.rel_l2(a, b)
    assert max(rels.values()) <= tol, rels
    return rels


def test_acdc_engine_int8_holds_to_jax(acdc):
    """The ACDC engine, dtype int8 in both packages, one request, the port
    fed JAX's noise; the int8 chains are not the bf16 ones."""
    ref = ts.jengine(acdc, dtype="int8").reconstruct(
        acdc["yr"], acdc["yi"], seed=ts.SEED)
    ours = ts.engine(acdc, dtype="int8").reconstruct(
        acdc["yr"], acdc["yi"], seed=ts.SEED, noise=ts.jax_draws(ts.SEED))
    _held(ours, ref, INT8_REL)
    bf16 = ts.engine(acdc, dtype="bf16").reconstruct(
        acdc["yr"], acdc["yi"], noise=ts.jax_draws(ts.SEED))
    assert not np.array_equal(bf16.x_re, ours.x_re)


def test_guided_int8_engine_keeps_the_seg_net_float32(acdc):
    """The seg-guided engine in int8: the score net's copy on the int8
    path, the seg UNet on its float32 convolutions (JAX sets the int8
    context inside the score function only); the guidance moves the
    chains."""
    kw = dict(seed=ts.SEED, seg_label=acdc["label"], seg_lamda=3.0)
    eng = ts.engine(acdc, seg=True, dtype="int8")
    ours = eng.reconstruct(acdc["yr"], acdc["yi"], **kw,
                           noise=ts.jax_draws(ts.SEED))
    plain = ts.engine(acdc, dtype="int8").reconstruct(
        acdc["yr"], acdc["yi"], noise=ts.jax_draws(ts.SEED))
    assert np.isfinite(ours.x_re).all()
    assert not np.allclose(plain.x_re, ours.x_re)
    convs = [m for m in eng.seg_model.modules()
             if isinstance(m, layers.Conv)]
    assert convs and all(m.quant is None for m in convs)


def test_cine_engine_int8_holds_to_jax(cine):
    """The cine engine, dtype int8 in both packages: the spatial NCSNv2 and
    the temporal NCSN1D (1-D convolutions) both on the int8 path; one
    request with the JAX engine's noise and shifts."""
    spec = {**tc.ENGINE_SPEC, "dtype": "int8"}
    jeng = JCineEngine(tc.J_S, cine["pS"], tc.SIG, spec=JCineSpec(**spec),
                       module_T=tc.J_T, params_T=cine["pT"],
                       sigmas_T=tc.SIG_T, mask=cine["mask"],
                       sens_re=cine["maps"])
    ref = jeng.reconstruct(cine["y"], cine["yi"], seed=6)
    eng = tc.engine(cine, dtype="int8")
    noise, shift = tc.cine_draws(jax.random.PRNGKey(6), "diffusion1d", True,
                                 range(tc.LEVELS), tc.NSTEPS)
    ours = eng.reconstruct(cine["y"], cine["yi"], seed=6, noise=noise,
                           shift=shift)
    _held(ours, ref, INT8_REL)
    assert ours.x_re.shape == (tc.CHAINS, tc.TF, tc.H, tc.W, 1)


def _post(base, query, **arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(f"{base}/reconstruct?{query}",
                                 data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req) as r:
        return np.load(io.BytesIO(r.read())), dict(r.headers)


@pytest.mark.parametrize("workload", ["acdc", "cine"])
def test_cli_int8_serves_over_http(workload):
    """serve_recon --dtype int8 builds the engine of each workload (the
    ACDC prior tiny; the cine spatial prior tiny beside the full-width
    CINE127_1D temporal NCSN1D), answers POST /reconstruct with finite
    arrays and counts the request on /healthz."""
    flags = (tc.CLI if workload == "cine" else ts.CLI) + ["--dtype", "int8"]
    eng = serve_recon.build_engine(serve_recon.parse_args(flags))
    assert eng.spec.dtype == "int8"
    s = eng.spec
    frames = (s.frames,) if workload == "cine" else ()
    y = np.random.RandomState(0).rand(2, *frames, s.height, s.width
                                      ).astype(np.float32)
    httpd = serve(eng, "127.0.0.1", 0, background=True)
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        body, headers = _post(base, "seed=3", y_re=y, y_im=0 * y)
        assert float(headers["X-Chain-Steps-Per-S"]) > 0
        assert body["x_re"].shape == (s.chains, *frames, s.height, s.width,
                                      1)
        assert np.isfinite(body["x_re"]).all()
        with urllib.request.urlopen(f"{base}/healthz") as r:
            health = json.loads(r.read())
        assert health["requests"] == 1 and health["spec"]["dtype"] == "int8"
    finally:
        httpd.shutdown()
        httpd.server_close()

"""int8 on a mesh takes the activation scale of the whole batch, as JAX's
max over a sharded array does (ops/quant.ScaleGroup,
samplers/ald_pair.ShardedReconstructor), on the CPU.

- The ACDC int8 engine on a mesh of 2 CPU entries against JAX's int8
  engine on 2 of the 8 virtual CPU devices, fed its noise: JAX's sharded
  int8 chains are its unsharded ones (read: bit for bit), and so are the
  port's, within the sharded bound of tests/test_torch_parallel.py (rel
  L2 1e-6; read: 0). With each shard's own scale, as before this repair,
  they part by 2.8e-3. Against JAX the int8 bound of
  tests/test_torch_int8_serving.py, 1e-2 (read 3.1e-3).
- The cine int8 engine (NCSNv2 and NCSN1D both on the int8 path) on 2
  entries against its run without a mesh, the same bound.
- int8_conv and int8_conv_unfold (K7's geometries and the rest) on two
  threads of one ScaleGroup give the unsharded batch's output bit for
  bit; a NaN in one shard makes both shards NaN, as jnp.max over the
  sharded array is; a shard that fails breaks the group instead of
  leaving the other waiting. Eight shards under a short switch interval
  keep their rows, through the group and through the noise views.
"""
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu import parallel as jparallel
from inverseproblemwithdiffusionmodel_tpu_torch import parallel
from inverseproblemwithdiffusionmodel_tpu_torch.ops import quant
from tests import test_torch_cine as tc
from tests import test_torch_serving as ts
from tests.test_torch_int8_serving import INT8_REL

torch.set_num_threads(1)

SHARDED = 1e-6
CPU = torch.device("cpu")


def worst(a, b):
    return max(ts.rel_l2(getattr(a, k), getattr(b, k))
               for k in ("x_re", "x_im", "mean_mag", "std_mag"))


def test_acdc_int8_engine_on_two_entries_takes_the_batch_scale():
    s = ts.setup.__wrapped__()
    spec = {**ts.SPEC, "dtype": "int8"}

    def jrun(mesh):
        return ts.JEngine(s["module"], s["params"], s["sigmas"],
                          spec=ts.JEngineSpec(**spec), mask=s["mask"],
                          sens_re=s["maps"], mesh=mesh).reconstruct(
            s["yr"], s["yi"], seed=ts.SEED)

    def run(mesh):
        eng = ts.ReconstructionEngine(
            s["model"], torch.tensor(np.asarray(s["sigmas"])),
            spec=ts.EngineSpec(**spec), mask=s["mask"], sens_re=s["maps"],
            mesh=mesh, device="cpu")
        return eng.reconstruct(s["yr"], s["yi"], seed=ts.SEED,
                               noise=ts.jax_draws(ts.SEED))

    jax_two = jrun(jparallel.make_mesh(n_data=2, n_model=1))
    assert worst(jax_two, jrun(None)) == 0.0
    two = run(parallel.make_mesh(devices=[CPU, CPU]))
    assert worst(two, run(None)) <= SHARDED
    assert worst(two, jax_two) <= INT8_REL


def test_cine_int8_engine_on_two_entries_is_its_unsharded_run():
    s = tc.setup.__wrapped__()

    def run(mesh):
        eng = tc.CineReconstructionEngine(
            s["netS"], torch.tensor(np.asarray(tc.SIG)),
            spec=tc.CineEngineSpec(**{**tc.ENGINE_SPEC, "dtype": "int8"}),
            model_T=s["netT"], sigmas_T=torch.tensor(np.asarray(tc.SIG_T)),
            mask=s["mask"], sens_re=s["maps"], mesh=mesh, device="cpu")
        noise, shift = tc.cine_draws(jax.random.PRNGKey(6), "diffusion1d",
                                     True, range(tc.LEVELS), tc.NSTEPS)
        return eng.reconstruct(s["y"], s["yi"], noise=noise, shift=shift)

    two = run(parallel.make_mesh(devices=[CPU, CPU]))
    assert np.isfinite(two.x_re).all()
    assert worst(two, run(None)) <= SHARDED


def on_threads(fn, xs):
    """fn(x) for each shard x, each on a thread of one ScaleGroup."""
    group, out, errors = quant.ScaleGroup(len(xs)), [None] * len(xs), []

    def run(d):
        try:
            with group.member(d):
                out[d] = fn(xs[d])
        except BaseException as e:      # held for the test to read
            errors.append(e)

    threads = [threading.Thread(target=run, args=(d,))
               for d in range(len(xs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return out, errors


@pytest.mark.parametrize("geometry", [
    dict(k=3, ndim=2, dilation=2), dict(k=3, ndim=1, pre_pad=(1, 0)),
    dict(k=3, ndim=2, stride=2), dict(k=3, ndim=3)],
    ids=["k7-2d", "k7-1d", "unfold-stride", "unfold-3d"])
def test_shards_of_one_group_quantize_with_the_batch_scale(geometry):
    geometry = dict(geometry)
    k, ndim = geometry.pop("k"), geometry["ndim"]
    gen = torch.Generator().manual_seed(0)
    w = quant.QuantWeight.of(torch.randn((6, 5) + (k,) * ndim,
                                         generator=gen))
    x = torch.randn((4, 5) + (7,) * ndim, generator=gen)
    x[2:] *= 10.0                  # the second shard holds the batch's max
    pad = geometry.pop("dilation", 1)
    conv = lambda t: quant.int8_conv(t, w, padding=pad, dilation=pad,
                                     **geometry)
    whole = conv(x)
    out, errors = on_threads(conv, list(x.chunk(2)))
    assert not errors
    assert torch.equal(torch.cat(out), whole)
    # each shard alone takes its own scale: another output
    assert not torch.equal(conv(x[:2]), whole[:2])
    x[3, 0, 0] = float("nan")
    out, errors = on_threads(conv, list(x.chunk(2)))
    assert not errors
    assert all(torch.isnan(o).all() for o in out)


def test_many_shards_under_a_short_switch_interval():
    """8 shards (more than this host's workers' cores) through 12 int8
    convolutions each, and 8 views of one noise stream drawing 40 times
    (draws big enough that torch lets go of the interpreter while making
    them), the interpreter switching threads every 1 us: every shard's
    output is its rows of the whole batch's, and every draw its rows of
    the stream's draw in order (a lost update in a meeting's slots or in
    the noise views' counters would break either; without their lock the
    views read wrong rows in 198 of 200 draws here)."""
    from inverseproblemwithdiffusionmodel_tpu_torch.parallel.ensemble import (
        scatter_noise)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.device import (
        gaussian_noise)
    gen = torch.Generator().manual_seed(1)
    ws = [quant.QuantWeight.of(torch.randn(3, 3, 3, 3, generator=gen))
          for _ in range(12)]
    x = torch.randn(16, 3, 5, 5, generator=gen)
    x *= torch.linspace(0.1, 10.0, 16).reshape(-1, 1, 1, 1)

    def net(t):
        for w in ws:
            t = quant.int8_conv(t, w, padding=1)
        return t

    want_noise = gaussian_noise(3, "cpu")
    want = [want_noise((16, 65536)) for _ in range(40)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out, errors = on_threads(net, list(x.chunk(8)))
        views = scatter_noise(gaussian_noise(3, "cpu"), [CPU] * 8)
        drawn, noise_errors = on_threads(
            lambda d: [views[d]((2, 65536)) for _ in range(40)],
            list(range(8)))
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not noise_errors
    assert torch.equal(torch.cat(out), net(x))
    for k in range(40):
        assert torch.equal(torch.cat([d[k] for d in drawn]), want[k])


def test_a_failing_shard_breaks_the_group():
    w = quant.QuantWeight.of(torch.ones(2, 2, 3, 3))

    def conv(x):
        if x.shape[0] == 1:
            raise RuntimeError("shard failed")
        return quant.int8_conv(x, w, padding=1)

    _, errors = on_threads(conv, [torch.ones(1, 2, 4, 4),
                                      torch.ones(2, 2, 4, 4)])
    kinds = sorted(type(e).__name__ for e in errors)
    assert kinds == ["BrokenBarrierError", "RuntimeError"]

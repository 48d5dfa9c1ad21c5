"""The port's parallel/ (mesh, chain sharding, ensembles) against the JAX
package's, on the CPU: tests/test_parallel.py's cases, and the pair
reconstructor, the 2D+time reconstructor and both serving engines sharded
over meshes of CPU entries, held to their unsharded runs and to JAX's
sharded runs fed the same noise.

Tolerances: a shard count of one is the unsharded chain, bit for bit. On
several shards the CG proximal's dot products are summed shard by shard,
so the chains part from the unsharded ones by rounding: rel_l2 <= 1e-6
(rtol 1e-5, atol 1e-6 for the analytic chain, whose Im part is rounding
noise under 1e-8).
Against JAX (its mesh of 2 or 4 of the 8 virtual CPU devices,
tests/conftest.py) the bound is the port's usual REL_L2 = 1e-5 for the
nets, and JAX's own sharded-vs-unsharded bound (rtol 1e-4, atol 1e-5)
for the analytic-score chain.
"""
import contextlib
import io
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from inverseproblemwithdiffusionmodel_tpu import parallel as jparallel
from inverseproblemwithdiffusionmodel_tpu.config import Config as JConfig
from inverseproblemwithdiffusionmodel_tpu.models.ncsnv2 import (
    NCSNv2 as JaxNCSNv2)
from inverseproblemwithdiffusionmodel_tpu.operators import make_sense
from inverseproblemwithdiffusionmodel_tpu.operators import pair as jpair
from inverseproblemwithdiffusionmodel_tpu.operators import proximal as jprox
from inverseproblemwithdiffusionmodel_tpu.models.registry import (
    make_score_fn as jax_make_score_fn)
from inverseproblemwithdiffusionmodel_tpu.samplers import ald as jald
from inverseproblemwithdiffusionmodel_tpu.samplers import (
    ald_pair as jald_pair)
from inverseproblemwithdiffusionmodel_tpu.samplers.sigmas import (
    sigma_ladder as jax_sigma_ladder)
from inverseproblemwithdiffusionmodel_tpu.serving import (
    CineEngineSpec as JCineSpec, CineReconstructionEngine as JCineEngine,
    EngineSpec as JEngineSpec, ReconstructionEngine as JEngine)
from inverseproblemwithdiffusionmodel_tpu.utils.misc import (
    stack_parts as jstack_parts)
from inverseproblemwithdiffusionmodel_tpu_torch import parallel
from inverseproblemwithdiffusionmodel_tpu_torch.config import Config
from inverseproblemwithdiffusionmodel_tpu_torch.models.ncsnv2 import NCSNv2
from inverseproblemwithdiffusionmodel_tpu_torch.operators import pair
from inverseproblemwithdiffusionmodel_tpu_torch.parallel import ensemble
from inverseproblemwithdiffusionmodel_tpu_torch.samplers import ald
from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald_pair import (
    ShardedReconstructor, SteppedPairReconstructor,
    make_stepped_2d_time_pair_reconstructor,
    make_stepped_pair_reconstructor, shard_rows)
from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
    acdc_SENSE_real_img, serve_recon)
from inverseproblemwithdiffusionmodel_tpu_torch.serving import (
    CineEngineSpec, CineReconstructionEngine, EngineSpec,
    ReconstructionEngine)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.device import (
    gaussian_noise)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    flax_to_torch_ncsnv2)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.misc import (
    stack_parts)
from tests import test_torch_cine as cine
from tests.test_torch_ald_pair import jax_noise, replay
from tests.test_torch_cine import setup as cine_setup  # noqa: F401 fixture
from tests.test_torch_ncsnv2 import init_flax
from tests import test_torch_sense_recon as sense
from tests.test_torch_sense_recon import setup as sense_setup  # noqa: F401

torch.set_num_threads(1)

CPU = torch.device("cpu")
SHARDED = 1e-6          # rel_l2, sharded vs unsharded (CG sums reordered)
REL_L2 = 1e-5           # rel_l2, the port vs JAX on the same noise


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def cpu_mesh(n):
    return parallel.make_mesh(devices=[CPU] * n)


def jax_mesh(n):
    return jparallel.make_mesh(n_data=n, n_model=1)


# -- the mesh and its helpers -----------------------------------------------

def test_make_mesh_shapes_and_errors_are_jax():
    mesh, jmesh = cpu_mesh(8), jparallel.make_mesh()
    assert mesh.devices.shape == jmesh.devices.shape == (8, 1)
    assert mesh.axis_names == jmesh.axis_names == ("data", "model")
    assert mesh.shape == dict(jmesh.shape)
    m2 = parallel.make_mesh(4, 2, devices=[CPU] * 8)
    assert m2.devices.shape == jparallel.make_mesh(4, 2).devices.shape
    assert m2.shape == {"data": 4, "model": 2} and len(m2.data_devices) == 4
    for kw in (dict(n_data=64, n_model=64), dict(n_model=3)):
        with pytest.raises(ValueError):
            jparallel.make_mesh(**kw)
        with pytest.raises(ValueError):
            parallel.make_mesh(devices=[CPU] * 8, **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.make_mesh()
    # tensor parallelism is ported (tests/test_torch_tp.py): on a mesh of
    # one model entry, as in JAX, the rule splits nothing
    assert jparallel.tp_sharding(jmesh, jnp.zeros((4, 4)), 1).spec == ()
    assert parallel.tp_sharding(mesh, torch.zeros(4, 4), 1).axis is None
    assert [t.shape for t in parallel.shard_tp(torch.zeros(4, 4), mesh)] \
        == [(4, 4)]


@pytest.mark.parametrize("n,multiple,axis", [(5, 4, 0), (5, 5, 0),
                                              (3, 8, 1), (1, 3, 1)])
def test_pad_to_multiple_is_jax(n, multiple, axis):
    shape = [2, 2]
    shape[axis] = n
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    want, wn = jparallel.pad_to_multiple(x, multiple, axis)
    got, gn = parallel.pad_to_multiple(x, multiple, axis)
    tgot, tn = parallel.pad_to_multiple(torch.from_numpy(x), multiple, axis)
    assert gn == tn == wn == n
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tgot.numpy(), want)


def test_shard_and_replicate_placement():
    mesh = cpu_mesh(4)
    x = torch.arange(16.0).reshape(8, 2)
    chunks = parallel.shard_batch(x, mesh)
    assert [tuple(c.shape) for c in chunks] == [(2, 2)] * 4
    assert torch.equal(torch.cat(chunks), x)
    tree = parallel.shard_batch({"a": x, "b": [x[:4]]}, mesh)
    assert len(tree["a"]) == 4 and tree["b"][0][3].shape == (1, 2)
    copies = parallel.replicate(x, mesh)
    assert len(copies) == 4 and all(torch.equal(c, x) for c in copies)
    assert parallel.data_sharding(mesh).split
    assert not parallel.replicated(mesh).split
    with pytest.raises(ValueError, match="pad it"):
        parallel.shard_batch(x[:7], mesh)


def test_ensemble_keys_distinct_deterministic_and_mesh_free():
    jkeys = jparallel.ensemble_keys(jax.random.PRNGKey(0), 8)
    assert len({tuple(np.asarray(k)) for k in jkeys}) == 8
    keys = parallel.ensemble_keys(0, 1000)
    assert keys.shape == (1000,) and keys.dtype == torch.int64
    assert len(set(keys.tolist())) == 1000
    assert torch.equal(keys, parallel.ensemble_keys(0, 1000))
    # a chain's key is its index's, whatever the ensemble's size or split
    assert torch.equal(parallel.ensemble_keys(0, 8), keys[:8])
    assert not set(parallel.ensemble_keys(1, 8).tolist()) & set(
        keys[:8].tolist())
    draws = [torch.randn(3, generator=torch.Generator().manual_seed(int(k)))
             for k in keys[:8]]
    assert len({tuple(d.tolist()) for d in draws}) == 8


def test_shard_chain_axis_pads_indivisible_batches():
    mesh = cpu_mesh(8)
    y = torch.arange(3 * 4, dtype=torch.float32).reshape(3, 4)
    chunks, n = parallel.shard_chain_axis(y, mesh)
    jchunks, jn = jparallel.shard_chain_axis(jnp.asarray(y.numpy()),
                                             jax_mesh(8))
    assert n == jn == 3 and len(chunks) == 8
    np.testing.assert_array_equal(torch.cat(chunks).numpy(),
                                  np.asarray(jchunks))
    y2 = torch.ones(4, 5, 2)
    chunks2, n2 = parallel.shard_chain_axis(y2, mesh, axis=1)
    assert n2 == 5 and torch.cat(chunks2, dim=1).shape == (4, 8, 2)


def _noisy(y, seed):
    return y + 0.01 * gaussian_noise(seed, y.device)(y.shape)


def test_run_sharded_ensemble_chains_independent_and_unsharded():
    measurement = torch.ones(1, 4, 4) * 2.0
    out = parallel.run_sharded_ensemble(_noisy, measurement, 8, 0,
                                        mesh=cpu_mesh(8))
    assert out.shape == (8, 4, 4)
    assert float(out.std(dim=0).max()) > 0
    mean, std = parallel.ensemble_mean_std(out)
    assert mean.shape == (4, 4) and std.shape == (4, 4)
    np.testing.assert_allclose(mean.numpy(), 2.0, atol=0.1)
    # the sampler sees the whole ensemble: no padding, no other noise
    for mesh in (None, cpu_mesh(1), cpu_mesh(2), cpu_mesh(4)):
        assert torch.equal(parallel.run_sharded_ensemble(
            _noisy, measurement, 8, 0, mesh=mesh), out)
    # 5 chains on 4 entries: padded to 8 with copies of the last chain,
    # the sampler's whole draw, sliced back to 5
    seen = []
    out5 = parallel.run_sharded_ensemble(
        lambda y, seed: seen.append(y.clone()) or _noisy(y, seed),
        torch.arange(5.0)[:, None, None].expand(5, 4, 4), 1, 0,
        mesh=cpu_mesh(4))
    assert seen[0].shape == (8, 4, 4) and torch.equal(seen[0][5:],
                                                      seen[0][4:5].expand(
                                                          3, 4, 4))
    assert torch.equal(out5, _noisy(seen[0], 0)[:5])


def test_run_sharded_ensemble_indivisible_count():
    measurement = torch.ones(1, 4, 4) * 2.0
    out = parallel.run_sharded_ensemble(_noisy, measurement, 105, 0,
                                        mesh=cpu_mesh(8))
    jout = jparallel.run_sharded_ensemble(
        lambda y, k: y + 0.01 * jax.random.normal(k, y.shape),
        jnp.asarray(measurement.numpy()), 105, jax.random.PRNGKey(0),
        mesh=jax_mesh(8))
    assert out.shape == jout.shape == (105, 4, 4)
    np.testing.assert_allclose(parallel.ensemble_mean_std(out)[0].numpy(),
                               2.0, atol=0.05)


def test_run_sharded_ensemble_coil_leading_measurement():
    measurement = torch.arange(2 * 1 * 4 * 4, dtype=torch.float32).reshape(
        2, 1, 4, 4)
    sampler = lambda y, seed: y.sum(dim=0)
    out = parallel.run_sharded_ensemble(sampler, measurement, 5, 0,
                                        mesh=cpu_mesh(8),
                                        measurement_batch_axis=1,
                                        output_batch_axis=0)
    jout = jparallel.run_sharded_ensemble(
        lambda y, k: y.sum(axis=0), jnp.asarray(measurement.numpy()), 5,
        jax.random.PRNGKey(0), mesh=jax_mesh(8), measurement_batch_axis=1,
        output_batch_axis=0)
    assert out.shape == (5, 4, 4)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_noise_views_take_their_rows_of_one_stream():
    draws = [torch.randn(8, 3) for _ in range(3)]
    views = ensemble.scatter_noise(replay([d.numpy() for d in draws]),
                                   [CPU] * 4)
    for k in range(3):
        for d in (2, 0, 3, 1):
            assert torch.equal(views[d]((2, 3)), draws[k][2 * d:2 * d + 2])
    with pytest.raises(ValueError, match="draws"):
        v = ensemble.scatter_noise(lambda s: torch.zeros(s), [CPU] * 2)
        v[0]((2, 3))
        v[1]((1, 3))
    stream = iter([(1, 0), (0, 1), (1, 1)])
    shifts = ensemble.scatter_shift(lambda win: next(stream), 2)
    assert [shifts[0](2) for _ in range(3)] == [(1, 0), (0, 1), (1, 1)]
    assert [shifts[1](2) for _ in range(3)] == [(1, 0), (0, 1), (1, 1)]


# -- the pair reconstructor sharded -------------------------------------------

H = W = 16
B = 8


@pytest.fixture(scope="module")
def pair_problem():
    """tests/test_parallel.py's sharded pair problem: 2 exp coil maps,
    R = 8, a Gaussian blob target tiled over 8 chains, a 10-level ladder
    and the analytic score toward the target."""
    sense = make_sense("exp", 2, 8, 0.1, (H, W, 1), seed=0, num_frames=1)
    jop = jpair.PairSENSE.from_complex(sense)
    yy, xx = jnp.mgrid[0:H, 0:W]
    target = jnp.exp(-(((yy - 8) ** 2 + (xx - 6) ** 2) / 20.0)
                     )[None, :, :, None]
    yr, yi = jop(target, jnp.zeros_like(target))
    yr8, yi8 = (jnp.tile(v, (1, B, 1, 1, 1)) for v in (yr, yi))
    sigmas = jnp.exp(jnp.linspace(jnp.log(1.0), jnp.log(0.01), 10))
    op = pair.PairSENSE(*(torch.tensor(np.asarray(v)) for v in (
        jop.mask, jop.sens_re, jop.sens_im)))
    return dict(jop=jop, op=op, target=target, yr8=yr8, yi8=yi8,
                sigmas=sigmas, key=jax.random.PRNGKey(0))


CFG = dict(n_steps_each=2, step_lr=3e-5)


def _jax_pair(p, yr, yi):
    def score_fn(x, labels):
        sig = p["sigmas"][labels].reshape(-1, *([1] * (x.ndim - 1)))
        tgt = jstack_parts(
            jnp.broadcast_to(p["target"], (x.shape[0] // 2, H, W, 1)),
            jnp.zeros((x.shape[0] // 2, H, W, 1)))
        return (tgt - x) / sig ** 2

    prox = jpair.PairL2Penalty(lin_tfm=p["jop"], num_iters=3)
    recon = jax.jit(lambda yr, yi, k: jald_pair.ald_inverse_proximal_pair(
        score_fn, p["sigmas"], (yr, yi), p["jop"], prox, k,
        jald.ALDConfig(**CFG), lr_scaled=50.0))
    return recon(yr, yi, p["key"])


def _port_pair(p, mesh):
    sigmas = torch.tensor(np.asarray(p["sigmas"]))
    target = torch.tensor(np.asarray(p["target"]))

    def score_fn(x, labels):
        sig = sigmas[labels].reshape(-1, *([1] * (x.ndim - 1)))
        tgt = stack_parts(target.expand(x.shape[0] // 2, H, W, 1),
                          torch.zeros(x.shape[0] // 2, H, W, 1))
        return (tgt - x) / sig ** 2

    prox = pair.PairL2Penalty(lin_tfm=p["op"], num_iters=3)
    n = 1 if mesh is None else mesh.shape["data"]
    shards = [SteppedPairReconstructor(
        score_fn, sigmas, shard_rows(p["op"], n, d), shard_rows(prox, n, d),
        ald.ALDConfig(**CFG), 50.0, device=dev)
        for d, dev in enumerate(mesh.data_devices if mesh else [CPU])]
    recon = shards[0] if mesh is None else ShardedReconstructor(shards)
    draws = jax_noise(p["key"], (B, H, W, 1), 10 * CFG["n_steps_each"])
    return recon(torch.tensor(np.asarray(p["yr8"])),
                 torch.tensor(np.asarray(p["yi8"])), noise=replay(draws))


def test_sharded_pair_reconstruction_matches_unsharded_and_jax(pair_problem):
    p = pair_problem
    jplain = _jax_pair(p, p["yr8"], p["yi8"])
    sh = NamedSharding(jax_mesh(4), P(None, "data"))
    jsharded = _jax_pair(p, jax.device_put(p["yr8"], sh),
                         jax.device_put(p["yi8"], sh))
    plain = _port_pair(p, None)
    assert all(torch.equal(a, b) for a, b in zip(
        _port_pair(p, cpu_mesh(1)), plain))
    for n in (2, 4):
        ours = _port_pair(p, cpu_mesh(n))
        for o, u, j, jp in zip(ours, plain, jsharded, jplain):
            assert o.shape == (B, H, W, 1)
            # Im is rounding noise (|xi| < 1e-8): an absolute bound
            np.testing.assert_allclose(o.numpy(), u.numpy(), rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(o.numpy(), np.asarray(j), rtol=1e-4,
                                       atol=1e-5)
            np.testing.assert_allclose(np.asarray(j), np.asarray(jp),
                                       rtol=1e-4, atol=1e-5)


def test_stepped_pair_reconstructor_on_a_mesh_with_a_net(pair_problem):
    """make_stepped_pair_reconstructor(mesh=...) with the tiny NCSNv2 and
    the normal-kernel CG: the seeded chain over 1, 2 and 4 shards."""
    p = pair_problem
    cfg = Config(cine.tiny(1, H))
    model = NCSNv2(cfg)
    module = JaxNCSNv2(config=JConfig(cine.tiny(1, H)))
    model.load_state_dict(flax_to_torch_ncsnv2(
        init_flax(module, jnp.zeros((1, H, W, 1)), jnp.ones((1,))), cfg,
        "ncsnv2"))
    sigmas = torch.tensor(np.asarray(jax_sigma_ladder(10.0, 0.1, 3)))
    y = torch.tensor(np.asarray(p["yr8"])), torch.tensor(np.asarray(
        p["yi8"]))
    prox = pair.PairL2Penalty.with_normal_kernel(p["op"], num_iters=3)

    def run(mesh, snaps=None):
        snap = None
        if snaps is not None:
            snap = lambda c, sig, xr, xi: snaps.append((c, sig, xr, xi))
        return make_stepped_pair_reconstructor(
            model, sigmas, p["op"], prox,
            ald.ALDConfig(**CFG, snapshot_every=2), 2.0, snapshot_fn=snap,
            device="cpu", mesh=mesh)(*y, seed=3)

    plain_snaps, one_snaps = [], []
    plain = run(None, plain_snaps)
    assert all(torch.equal(a, b) for a, b in zip(run(cpu_mesh(1), one_snaps),
                                                 plain))
    assert [(c, s) for c, s, _, _ in plain_snaps] == [
        (c, float(sigmas[c])) for c in (0, 2)]
    for (_, _, *a), (_, _, *b) in zip(one_snaps, plain_snaps):
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    for n in (2, 4):
        snaps = []
        for o, u in zip(run(cpu_mesh(n), snaps), plain):
            assert rel_l2(o.numpy(), u.numpy()) <= SHARDED
        # the snapshots see the whole ensemble, gathered
        assert [(c, s) for c, s, _, _ in snaps] == [
            (c, s) for c, s, _, _ in plain_snaps]
        for (_, _, *a), (_, _, *b) in zip(snaps, plain_snaps):
            for u, v in zip(a, b):
                assert u.shape == (B, H, W, 1)
                assert rel_l2(u.numpy(), v.numpy()) <= SHARDED


# -- the SENSE script's chains on a mesh -------------------------------------

@pytest.mark.parametrize("guided", [False, True], ids=["plain", "guided"])
def test_sense_script_reconstruct_on_a_mesh_matches_unsharded_and_jax(
        sense_setup, guided):
    """acdc_SENSE_real_img.reconstruct (the script's chains, pair form) on
    tests/test_torch_sense_recon.py's tiny NCSNv2 and 2-coil SENSE, over 2
    CPU entries, against its unsharded run and JAX's complex sampler with
    the measurement sharded over 2 devices, fed JAX's noise. The sampler
    port's bound against JAX is that file's (rel_l2 1e-4)."""
    s = sense_setup
    op, jop, _, _ = sense.operators("sense")
    y = np.asarray(jop(jnp.asarray(s["x"])))                 # (S, 1, H, W, 1)
    kw = dict(lr_scaled=2.0, seg_lamda=3.0, seg_start_time=0.0)
    key = jax.random.PRNGKey(2)
    sigmas = s["sigmas"]
    jseg = {}
    if guided:
        jseg = dict(seg_fn=lambda v: s["seg_module"].apply(
            {"params": s["seg_params"]}, v),
            seg_label=jnp.asarray(s["label"]))
    sh = NamedSharding(jax_mesh(2), P(None, "data"))
    ref = jax.jit(lambda yb: jald.ald_inverse_seg_proximal_real_imag(
        jax_make_score_fn(s["module"], s["params"], sigmas), sigmas, yb,
        jop, jprox.L2Penalty(lin_tfm=jop), key,
        jald.ALDConfig(n_steps_each=sense.NSTEPS, step_lr=1e-5), **jseg,
        **kw))(jax.device_put(jnp.asarray(np.repeat(y, sense.CHAINS, 1)),
                              sh))
    seg = {}
    if guided:
        seg = dict(seg_model=s["seg_model"],
                   seg_label=torch.from_numpy(s["label"][:1]))

    def run(mesh):
        return acdc_SENSE_real_img.reconstruct(
            s["model"], torch.tensor(np.asarray(sigmas)),
            torch.from_numpy(y.copy()), op,
            ald.ALDConfig(n_steps_each=sense.NSTEPS, step_lr=1e-5),
            sense.CHAINS, device="cpu", mesh=mesh, noise=replay(jax_noise(
                key, (sense.CHAINS, H, W, 1), sense.LEVELS * sense.NSTEPS)),
            **seg, **kw)

    plain = run(None)
    assert torch.equal(run(cpu_mesh(1)), plain)
    ours = run(cpu_mesh(2))
    assert ours.shape == (sense.CHAINS, H, W, 1)
    assert ours.dtype == torch.complex64
    assert sense.rel_l2(ours.numpy(), plain.numpy()) <= SHARDED
    assert sense.rel_l2(ours.numpy(), np.asarray(ref)) <= sense.REL_L2


def test_sense_script_use_mesh_on_two_entries(tmp_path):
    """main(--use_mesh) with the mesh of 2 CPU entries in place of the
    cards: the run without the mesh up to the CG's sums, and with 3 chains
    (padded to 4, the padding dropped) 3 reconstructions."""
    guided = ["--seg_start_time", "0.5", "--seg_fraction", "0.5"]
    plain, _ = sense.run_script("sense", tmp_path / "plain", *guided)
    with mock.patch.object(acdc_SENSE_real_img, "script_mesh",
                           lambda device: cpu_mesh(2)):
        meshed, _ = sense.run_script("sense", tmp_path / "mesh", *guided,
                                     "--use_mesh")
        three, _ = sense.run_script("sense", tmp_path / "three",
                                    "--use_mesh", "--num_samples", "3")
    assert rel_l2(np.abs(meshed), np.abs(plain)) <= SHARDED
    assert sense.rel_l2(meshed, plain) <= SHARDED
    assert three.shape == (3, 32, 32, 1) and np.isfinite(three).all()


# -- the 2D+time reconstructor sharded ----------------------------------------

def test_sharded_2d_time_matches_unsharded_and_jax(cine_setup):
    """tests/test_torch_cine.py's stepped chain (2 chains of 3 frames, both
    tiny nets, temporal diffusion with random shifts, per-frame masks
    tiled over the chains), sharded over 2 entries, against the port's
    unsharded chain and JAX's chain sharded over 2 devices, fed JAX's
    noise and shifts."""
    s = cine_setup
    jrecon = jald_pair.make_stepped_2d_time_pair_reconstructor(
        cine.J_S, cine.J_T, cine.SIG, cine.SIG_T, s["jlin"], s["jprox"],
        jald.ALDConfig(n_steps_each=cine.NSTEPS, step_lr=cine.STEP_LR),
        lr_scaled=cine.LR_SCALED, mode_T="diffusion1d",
        lamda_T=cine.LAMDA_T, if_random_shift=True, win_size=cine.WIN,
        num_frames=cine.TF)
    key = jax.random.PRNGKey(11)
    sh = NamedSharding(jax_mesh(2), P(None, "data"))
    ref = jrecon(s["pS"], s["pT"], jax.device_put(jnp.asarray(s["yb"]), sh),
                 jax.device_put(jnp.asarray(s["yib"]), sh), key)
    y = torch.tensor(s["yb"]), torch.tensor(s["yib"])

    def run(mesh):
        noise, shift = cine.cine_draws(key, "diffusion1d", True,
                                       range(cine.LEVELS), cine.NSTEPS)
        recon = make_stepped_2d_time_pair_reconstructor(
            s["netS"], s["netT"], torch.tensor(np.asarray(cine.SIG)),
            torch.tensor(np.asarray(cine.SIG_T)), s["lin"], s["prox"],
            ald.ALDConfig(n_steps_each=cine.NSTEPS, step_lr=cine.STEP_LR),
            lr_scaled=cine.LR_SCALED, mode_T="diffusion1d",
            lamda_T=cine.LAMDA_T, if_random_shift=True, win_size=cine.WIN,
            num_frames=cine.TF, device="cpu", mesh=mesh)
        return recon(*y, noise=noise, shift=shift)

    plain = run(None)
    assert all(torch.equal(a, b) for a, b in zip(run(cpu_mesh(1)), plain))
    for o, u, r in zip(run(cpu_mesh(2)), plain, ref):
        assert o.shape == (cine.CHAINS, cine.TF, H, W, 1)
        assert rel_l2(o.numpy(), u.numpy()) <= SHARDED
        assert rel_l2(o.numpy(), np.asarray(r)) <= REL_L2


# -- the engines with a mesh --------------------------------------------------

def test_cine_engine_on_a_mesh_matches_jax(cine_setup):
    s = cine_setup
    spec = dict(cine.ENGINE_SPEC)
    jeng = JCineEngine(cine.J_S, s["pS"], cine.SIG, spec=JCineSpec(**spec),
                       module_T=cine.J_T, params_T=s["pT"],
                       sigmas_T=cine.SIG_T, mask=s["mask"],
                       sens_re=s["maps"], mesh=jax_mesh(2))
    ref = jeng.reconstruct(s["y"], s["yi"], seed=6)

    def run(mesh):
        eng = CineReconstructionEngine(
            s["netS"], torch.tensor(np.asarray(cine.SIG)),
            spec=CineEngineSpec(**spec), model_T=s["netT"],
            sigmas_T=torch.tensor(np.asarray(cine.SIG_T)), mask=s["mask"],
            sens_re=s["maps"], mesh=mesh, device="cpu")
        noise, shift = cine.cine_draws(jax.random.PRNGKey(6), "diffusion1d",
                                       True, range(cine.LEVELS), cine.NSTEPS)
        return eng, eng.reconstruct(s["y"], s["yi"], noise=noise,
                                    shift=shift)

    _, plain = run(None)
    eng, ours = run(cpu_mesh(2))
    assert eng.stats()["mesh"] == {"data": 2, "model": 1}
    assert eng.stats()["mesh"] == jeng.stats()["mesh"]
    for name in ("x_re", "x_im", "mean_mag", "std_mag"):
        a = getattr(ours, name)
        assert rel_l2(a, getattr(plain, name)) <= SHARDED
        assert rel_l2(a, getattr(ref, name)) <= REL_L2, name
    with pytest.raises(ValueError, match="multiple of the mesh data axis"):
        CineReconstructionEngine(
            s["netS"], cine.SIG, spec=CineEngineSpec(**spec),
            model_T=s["netT"], sigmas_T=cine.SIG_T, mesh=cpu_mesh(4),
            device="cpu")


TINY = {
    "data": {"channels": 1, "image_size": H, "logit_transform": False,
             "rescaled": False},
    "model": {"ngf": 8, "nonlinearity": "elu",
              "normalization": "InstanceNorm++"},
}
SPEC = dict(height=H, width=W, channels=1, num_sens=2, chains=4, levels=3,
            n_steps_each=2, step_lr=1e-5, lr_scaled=2.0, prox_iters=3,
            dtype="f32", mode="steps")


def test_engine_on_a_mesh_matches_unsharded_and_jax():
    """tests/test_torch_serving.py's tiny engine (4 chains, 2 coils) over 2
    CPU entries and over 4 (one chain each), against the unsharded engine
    and JAX's engine on a mesh of 2 devices, fed its noise."""
    module = JaxNCSNv2(config=JConfig(TINY))
    params = init_flax(module, jnp.zeros((1, H, W, 1)), jnp.ones((1,)))
    model = NCSNv2(Config(TINY))
    model.load_state_dict(flax_to_torch_ncsnv2(params, Config(TINY),
                                               "ncsnv2"))
    sigmas = jax_sigma_ladder(10.0, 0.1, 3, "geometric")
    rng = np.random.RandomState(0)
    mask = (rng.rand(1, 1, W, 1) < 0.4).astype(np.float32)
    maps = rng.rand(2, H, W, 1).astype(np.float32) + 0.2
    maps = maps / np.sqrt((maps ** 2).sum(axis=0, keepdims=True))
    y, yi = rng.rand(2, H, W).astype(np.float32), np.zeros((2, H, W),
                                                           np.float32)
    jeng = JEngine(module, params, sigmas, spec=JEngineSpec(**SPEC),
                   mask=mask, sens_re=maps, mesh=jax_mesh(2))
    ref = jeng.reconstruct(y, yi, seed=7)

    def run(mesh):
        eng = ReconstructionEngine(model, torch.tensor(np.asarray(sigmas)),
                                   spec=EngineSpec(**SPEC), mask=mask,
                                   sens_re=maps, mesh=mesh, device="cpu")
        return eng.reconstruct(y, yi, noise=replay(jax_noise(
            jax.random.PRNGKey(7), (4, H, W, 1), 6)))

    plain = run(None)
    one = run(cpu_mesh(1))
    np.testing.assert_array_equal(one.x_re, plain.x_re)
    for n in (2, 4):
        ours = run(cpu_mesh(n))
        for name in ("x_re", "x_im", "mean_mag", "std_mag"):
            a = getattr(ours, name)
            assert rel_l2(a, getattr(plain, name)) <= SHARDED
            assert rel_l2(a, getattr(ref, name)) <= REL_L2, name
    for bad, match in ((object(), "'data' axis"),
                       (cpu_mesh(3), "multiple of the mesh data axis")):
        with pytest.raises(ValueError, match=match):
            ReconstructionEngine(model, sigmas, spec=EngineSpec(**SPEC),
                                 mesh=bad, device="cpu")
    with pytest.raises(ValueError, match="multiple of the mesh data axis"):
        JEngine(module, params, sigmas, spec=JEngineSpec(**SPEC),
                mesh=jax_mesh(3))


CLI = ["--device", "cpu", "--override", f"data.image_size={H}",
       "--override", "model.ngf=8", "--levels", "2", "--chains", "4",
       "--num_sens", "2", "--no_warmup"]


@pytest.mark.parametrize("shards,match", [
    ("2", "exceeds the 1 available devices"),
    ("3", "exceeds the 1 available devices"),
    ("-1", None), ("1", None), ("0", None)])
def test_serve_recon_data_shards(shards, match):
    """--data_shards keeps JAX's checks: -1 is every device (the CPU
    counts as one), a count above them exits; 0 and 1 build no mesh."""
    args = serve_recon.parse_args(CLI + ["--data_shards", shards])
    if match is not None:
        with pytest.raises(SystemExit, match=match):
            serve_recon.build_engine(args)
        return
    with contextlib.redirect_stdout(io.StringIO()):
        eng = serve_recon.build_engine(args)
    want = {"data": 1, "model": 1} if shards == "-1" else None
    assert eng.stats()["mesh"] == want


def test_serve_recon_data_shards_on_four_cards():
    """The mesh --data_shards builds where torch would see four cards:
    -1 takes all four, a count above them or one that does not divide
    --chains exits (the JAX script's checks)."""
    def mesh(shards, chains):
        args = serve_recon.parse_args(
            ["--data_shards", str(shards), "--chains", str(chains)])
        with mock.patch.object(serve_recon, "resolve_device",
                               lambda d: torch.device("cuda")), \
                mock.patch("torch.cuda.device_count", return_value=4):
            return serve_recon._serving_mesh(args)

    assert mesh(-1, 8).shape == {"data": 4, "model": 1}
    assert mesh(2, 4).data_devices == [torch.device("cuda", i)
                                       for i in range(2)]
    with pytest.raises(SystemExit, match="exceeds the 4 available"):
        mesh(8, 8)
    with pytest.raises(SystemExit, match="must be a multiple"):
        mesh(2, 3)

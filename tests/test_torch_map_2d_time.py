"""The port's 2D+time MAP against the JAX package's: map_optimizer_2d_time
on the complex SENSE and map_optimizer_2d_time_pair on the pair SENSE, in
each mode_T (diffusion1d with the random roll fed JAX's shifts, tv, none).

Geometry and nets of tests/test_torch_cine.py (16 px, ngf 8 spatial and
temporal nets, T = 3, 2 chains, 2 coils; the complex operator of
tests/test_torch_cine_complex.py). The checks are those of
tests/test_torch_map_tv.py: the port's ascent direction at each of JAX's
iterates at DIR_REL, the runs after N_ITERS steps at ITER_REL with at most
FLIP_SHARE of the elements more than lr apart.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu.models.registry import (
    make_score_fn as jax_make_score_fn)
from inverseproblemwithdiffusionmodel_tpu.samplers import map_opt as jmap
from inverseproblemwithdiffusionmodel_tpu.samplers import (
    map_pair as jmap_pair)
from inverseproblemwithdiffusionmodel_tpu_torch.samplers import (
    map_opt, map_pair)
from tests.test_torch_cine import J_S, J_T, SIG, SIG_T, WIN, TF, setup
from tests.test_torch_cine_complex import SHAPE, complex_ops, scores
from tests.test_torch_map_tv import (
    LR, N_ITERS, check, parts, probe, recorder)

torch.set_num_threads(1)


def map_shifts(key, n):
    """JAX's rolls of map_optimizer_2d_time: per iteration `key, k_t =
    split(key)`, the roll randint(k_t, (2,), 0, win)."""
    out = []
    for _ in range(n):
        key, k_t = jax.random.split(key)
        out.append(tuple(int(v) for v in jax.random.randint(
            k_t, (2,), 0, WIN)))
    return out


@pytest.mark.parametrize("mode", ["diffusion1d", "tv", "none"])
@pytest.mark.parametrize("form", ["complex", "pair"])
def test_map_optimizer_2d_time_matches_jax(setup, recorder, form, mode):
    """Prior weight, spatial and temporal weights all live; 4 iterations
    from A^H y; in diffusion1d each iteration's roll is JAX's."""
    s = setup
    rec = recorder
    kw = dict(prior_weight=0.8, spatial_step_weight=1.0,
              temporal_step_weight=0.6, mode_T=mode,
              if_random_shift=True, win_size=WIN, num_frames=TF)
    key = jax.random.PRNGKey(0)
    shifts = map_shifts(key, N_ITERS) if mode == "diffusion1d" else []
    cfg = dict(n_iters=N_ITERS, lr=LR)
    jS = jax_make_score_fn(J_S, s["pS"], SIG)
    jT = jax_make_score_fn(J_T, s["pT"], SIG_T)
    score_S, score_T = scores(s)
    if form == "complex":
        c = complex_ops(s)
        ref = jmap.map_optimizer_2d_time(jS, jT, jnp.asarray(c["y"]),
                                         c["jop"], jmap.MAPConfig(**cfg),
                                         key=key, **kw)
        args = (torch.from_numpy(c["y"]), c["op"])
        fn = map_opt.map_optimizer_2d_time
    else:
        y = (jnp.asarray(s["yb"]), jnp.asarray(s["yib"]))
        ref = jmap_pair.map_optimizer_2d_time_pair(
            jS, jT, y, s["jlin"], jmap.MAPConfig(**cfg), key=key, **kw)
        args = ((torch.tensor(s["yb"]), torch.tensor(s["yib"])), s["lin"])
        fn = map_pair.map_optimizer_2d_time_pair

    def run():
        it = iter(shifts)
        return fn(score_S, score_T, *args, map_opt.MAPConfig(**cfg),
                  shift=lambda win: next(it), device="cpu", **kw)

    with probe(rec) as seen:
        run()
    ours = run()
    assert parts(ours).shape == (2,) + SHAPE
    check(rec, seen, ours, ref)


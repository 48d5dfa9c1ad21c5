"""Tensor parallelism over the mesh's model axis in the train step's
other modes, beside tests/test_torch_tp.py (its workloads and bounds):
bf16 with remat on JAX's test NCSNv2, and the tiny NCSN1D in real-imag
mode with the foreground filter and centering, each one step of a state
split over 2 CPU entries against JAX's single-device step.
"""
import jax.numpy as jnp
import numpy as np
import torch

from inverseproblemwithdiffusionmodel_tpu_torch.parallel import tp
from tests.test_torch_tp import (ATOL, LOSS_RTOL, RTOL, held_to_jax,
                                 ncsn1d_job, ncsnv2_job, port_step, rel_l2,
                                 vector)

torch.set_num_threads(1)


def test_tp_bf16_remat_step_matches_jax():
    """compute_dtype bf16 and remat in both packages: the slices cast as
    the whole weight is. Two bf16 steps round each on its own (tests/
    test_torch_train_ncsn.py's bf16 test: XLA sums bf16 cotangents with
    about three times torch's error), so JAX's bounds hold the split step
    to the port's unsplit bf16 step, as JAX's test holds its split step to
    its single-device one; against JAX's bf16 step the loss is held at the
    bf16 gate, 2e-2 (measured 1.2e-3), and the parameters no farther than
    the unsplit step's plus JAX's atol (measured 5.67e-5 against
    5.65e-5)."""
    job = ncsnv2_job(compute_dtype=jnp.bfloat16, remat=True)
    state, loss = port_step(job, compute_dtype=torch.bfloat16, remat=True)
    plain, plain_loss = port_step(job, split=False,
                                  compute_dtype=torch.bfloat16, remat=True)
    np.testing.assert_allclose(loss, plain_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(loss, job["jax_loss"], rtol=2e-2)
    names = list(job["params"])
    got, want, jax_ = (vector(sd, names) for sd in (
        state.params, plain.params, job["jax_params"]))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(vector(state.eval_params, names),
                               vector(plain.eval_params, names), rtol=RTOL,
                               atol=ATOL)
    assert np.abs(got - jax_).max() <= np.abs(want - jax_).max() + ATOL
    assert rel_l2(got, vector(job["params"], names)) > 1e-4


def test_tp_ncsn1d_filtered_step_matches_jax():
    job = ncsn1d_job()
    state, loss = port_step(job)
    held_to_jax(state.params, state.eval_params, loss, job)
    assert sum(split is not None for _, split, _ in
               tp.entries(state.model)) > 0

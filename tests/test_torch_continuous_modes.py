"""The continuous train step's complex data modes
(training/train.make_continuous_score_train_step with data_mode 'complex',
'real-imag', 'real-imag-random') against the JAX package's step, in
float32, on the same weights and batch, the port fed JAX's collation draw
(phi, or the phase patch) and its t and z. A tiny FIR NCSN++ (the VE
leaf ve/ffhq_256_ncsnpp_continuous at 16 x 16, nf 16, ch_mult (1, 2), one
res block) with 2 input channels for 'complex' and 1 for the interleaved
[Re, Im] rows of the other two. The loss at rtol 1e-5 and the gradients at
rel L2 1e-4, as tests/test_torch_training.py holds the real-valued step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu.configs_continuous import (
    make_sde as jax_make_sde)
from inverseproblemwithdiffusionmodel_tpu.training.state import (
    TrainState as JaxTrainState, get_optimizer as jax_get_optimizer)
from inverseproblemwithdiffusionmodel_tpu.training.train import (
    make_continuous_score_train_step as jax_make_step)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    flax_to_torch_ncsnpp)
from test_torch_continuous_bf16 import (VE, build, jax_draws,
                                        jax_loss_and_grads, port_step,
                                        rel_l2, vector)

torch.set_num_threads(2)


@pytest.mark.parametrize("mode", ["complex", "real-imag",
                                  "real-imag-random"])
def test_complex_modes_match_jax_step(mode):
    channels = 2 if mode == "complex" else 1
    jcfg, cfg, module, params = build(
        VE[0], {"data.num_channels": channels, "data.channels": channels,
                "model.ch_mult": (1, 2)})
    jsde = jax_make_sde(jcfg)
    batch = np.random.RandomState(5).rand(2, 16, 16, 1).astype(np.float32)
    key = jax.random.PRNGKey(9)
    jloss, jgrads = jax_loss_and_grads(module, jsde, params, batch, key,
                                       mode=mode)
    if mode == "real-imag":
        # JAX's whole step computes the loss above from the same key
        jstate = JaxTrainState.create(params, jax_get_optimizer(jcfg))
        _, jstep_loss = jax_make_step(module, jsde, data_mode=mode)(
            jstate, jnp.asarray(batch), key)
        assert float(jstep_loss) == pytest.approx(jloss, rel=1e-6)

    loss, grads = port_step(cfg, params, batch, jax_draws(key, batch, mode),
                            mode=mode)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    names = list(grads)
    assert rel_l2(vector(grads, names), vector(
        flax_to_torch_ncsnpp(jgrads, cfg), names)) <= 1e-4

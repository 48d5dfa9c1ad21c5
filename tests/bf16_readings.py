"""Where the bf16 discrete train step of the port and of the JAX package
part, on the tiny NCSNv2Deepest of tests/test_torch_train_ncsn.py (32 px,
ngf 8, the same weights, batch and draws), on the CPU.

Prints, each as rel L2 from the same package's float32:
- the net's output and the first InstanceNorm++ (forward, bf16 casts);
- the gradient, whole and by parameter kind (weight, bias, alpha, gamma,
  beta), and the Adam update of one step;
- a bias gradient alone: the sum of a bf16 cotangent over 4096 rows
  (XLA's CPU backend against torch, both from float64).

Run: python tests/bf16_readings.py (about a minute).
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_train_ncsn as T  # noqa: E402
from inverseproblemwithdiffusionmodel_tpu_torch.training import (  # noqa: E402
    train as port_train)


def setup():
    jcfg = T.jax_load_config("ACDC", "real-imag", **T.OVER)
    module = T.jncsnv2.NCSNv2Deepest(config=jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, T.init_flax(
        module, jnp.zeros((1, T.SIZE, T.SIZE, 1)), jnp.ones((1,)), seed=3))
    rs = np.random.RandomState(7)
    return dict(jcfg=jcfg, cfg=T.load_config("ACDC", "real-imag", **T.OVER),
                module=module, params=params,
                sigmas=np.asarray(T.jax_get_sigmas(jcfg)),
                batches=[rs.rand(T.B, T.SIZE, T.SIZE, 1).astype(np.float32)
                         for _ in range(4)],
                keys=[jax.random.PRNGKey(10 + i) for i in range(4)])


def net_input(acdc):
    """The first step's perturbed, interleaved rows and their sigmas."""
    batch, sigmas = acdc["batches"][0], acdc["sigmas"]
    d = T.jax_draws(acdc["keys"][0], batch.shape, len(sigmas))
    x, phi = 2 * batch - 1, d["phi"].numpy().reshape(-1, 1, 1, 1)
    rows = np.stack([x * np.cos(phi), x * np.sin(phi)], 1).reshape(
        2 * T.B, T.SIZE, T.SIZE, 1)
    s = sigmas[d["labels"].numpy()].astype(np.float32)
    return (rows + d["noise"].numpy() * s.reshape(-1, 1, 1, 1)).astype(
        np.float32), s


def forward(acdc):
    x, s = net_input(acdc)
    out = {}
    for dt in (jnp.float32, jnp.bfloat16):
        p = jax.tree_util.tree_map(lambda a: a.astype(dt), acdc["params"])
        y, st = acdc["module"].apply(
            {"params": p}, jnp.asarray(x, dt), jnp.asarray(s, dt),
            capture_intermediates=True, mutable=["intermediates"])
        norm = st["intermediates"]["res1_0"]["norm1"]["__call__"][0]
        out["jax", dt == jnp.float32] = (np.asarray(y, np.float32),
                                         np.asarray(norm, np.float32))
    model = T.NCSNv2Deepest(acdc["cfg"])
    model.load_state_dict(T.torch_params(acdc["params"], acdc["cfg"]))
    seen = {}
    model.res1_0.norm1.register_forward_hook(
        lambda m, a, o: seen.update(norm=o.float().movedim(1, -1).numpy()))
    for dt in (None, torch.bfloat16):
        with torch.no_grad():
            net = port_train._mixed_precision_apply(model, dt)
            y = net(torch.from_numpy(x), torch.from_numpy(s))
        out["port", dt is None] = (y.numpy(), seen["norm"])
    for pkg in ("jax", "port"):
        (y16, n16), (y32, n32) = out[pkg, False], out[pkg, True]
        print(f"forward {pkg:4s}: output {T.rel_l2(y16, y32):.2e}, "
              f"res1_0.norm1 {T.rel_l2(n16, n32):.2e}")


def gradients(acdc):
    batch, key = acdc["batches"][0], acdc["keys"][0]
    cfg = acdc["cfg"]
    g = {("jax", dt is None): T.torch_params(
        T.jax_loss_and_grad(acdc, batch, key, dt)[1], cfg)
        for dt in (None, jnp.bfloat16)}
    upd = {}
    p0 = T.torch_params(acdc["params"], cfg)
    for dt in (None, torch.bfloat16):
        state, _ = T.port_steps(acdc, T.port_state(acdc), n=1,
                                compute_dtype=dt)
        g["port", dt is None] = {k: p.grad for k, p in
                                 state.model.named_parameters()}
        upd["port", dt is None] = {k: state.params[k] - p0[k]
                                   for k in g["port", dt is None]}
    for dt in (None, jnp.bfloat16):
        step = T.jax_make_step(acdc["module"], jnp.asarray(acdc["sigmas"]),
                               data_mode="real-imag", anneal_power=2.0,
                               if_centering=True, compute_dtype=dt)
        js = T.JaxTrainState.create(acdc["params"],
                                    T.jax_get_optimizer(acdc["jcfg"]),
                                    ema_decay=acdc["jcfg"].model.ema_rate)
        js, _ = step(js, jnp.asarray(batch), key)
        new = T.torch_params(js.params, cfg)
        upd["jax", dt is None] = {k: new[k] - p0[k] for k in new}
    names = list(g["port", True])
    kinds = {}
    for k in names:
        kinds.setdefault(k.rsplit(".", 1)[-1], []).append(k)

    def rel(a, b, ks=names):
        return T.rel_l2(T.state_vector(a, ks), T.state_vector(b, ks))

    for pkg in ("jax", "port"):
        g16, g32 = g[pkg, False], g[pkg, True]
        parts = ", ".join(f"{kind} {rel(g16, g32, ks):.2e}"
                          for kind, ks in kinds.items())
        print(f"gradient {pkg:4s}: all {rel(g16, g32):.2e} ({parts}); "
              f"update {rel(upd[pkg, False], upd[pkg, True]):.2e}")
    print(f"port bf16 vs JAX bf16 gradient: "
          f"{rel(g['port', False], g['jax', False]):.2e}")


def bias_gradient_sum():
    rs = np.random.RandomState(1)
    c = jnp.asarray(rs.randn(4096, 8).astype(np.float32) + 0.3,
                    jnp.bfloat16)
    exact = np.asarray(c, np.float64).sum(0)
    _, vjp = jax.vjp(lambda b: jnp.zeros((4096, 8), jnp.bfloat16) + b,
                     jnp.zeros((8,), jnp.bfloat16))
    xla = np.asarray(jax.jit(lambda c: vjp(c)[0])(c), np.float64)
    tch = torch.from_numpy(np.asarray(c, np.float32)).bfloat16().sum(0)
    print(f"bias gradient, a bf16 sum over 4096 rows, from float64: XLA "
          f"CPU {T.rel_l2(xla, exact):.2e}, torch "
          f"{T.rel_l2(tch.double().numpy(), exact):.2e}")


if __name__ == "__main__":
    torch.set_num_threads(1)
    acdc = setup()
    forward(acdc)
    gradients(acdc)
    bias_gradient_sum()

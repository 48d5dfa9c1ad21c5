"""The port's continuous NCSN++ demo against the JAX example at a tiny
setting on the CPU (examples/continuous_ncsnpp_demo.py, run as it is).

Held: the demo's config and sigma_max from the data, the SDE and the
samplers' arguments (shape, predictor, corrector, snr, steps, denoising)
within ARG_TOL (1e-6 of the largest magnitude), the results' keys, both
runs sampling one NCSN++ prior file the port writes.
"""
import json

import torch

from inverseproblemwithdiffusionmodel_tpu_torch.examples import (
    continuous_ncsnpp_demo as pdemo)
from inverseproblemwithdiffusionmodel_tpu_torch.utils import artifacts
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    seeded_weights)
from tests.torch_examples_common import (
    Recorder, assert_same, load_jax_example, same_call)

torch.set_num_threads(2)

DEMO_ARGS = ["--size", "16", "--nf", "16", "--num_res_blocks", "1",
             "--n_train", "8", "--num_scales", "3", "--samples", "2",
             "--batch", "2", "--steps", "4"]


def test_continuous_demo_matches_jax(tmp_path):
    """Both demos sample one seeded NCSN++ (the port writes it, in the
    JAX run's --out as ncsnpp.msgpack, the file its run would train)."""
    args = pdemo.parse_args(DEMO_ARGS + ["--device", "cpu"])
    data = pdemo.make_data(args.data, args.n_train, args.size, args.seed)
    _, _, model, _ = pdemo.build(args, data)
    (tmp_path / "jax").mkdir()
    prior = str(tmp_path / "jax" / "ncsnpp.msgpack")
    artifacts.save_prior(seeded_weights(model, 0), prior)
    jd = load_jax_example("continuous_ncsnpp_demo", tmp_path / "home")
    with Recorder() as jrec:
        for name in ("get_pc_sampler", "get_ode_sampler", "make_sde"):
            jrec.wrap(jd, name)
        jd.main(DEMO_ARGS + ["--out", str(tmp_path / "jax")])
    with Recorder() as prec:
        for name in ("get_pc_sampler", "get_ode_sampler", "make_sde"):
            prec.wrap(pdemo, name)
        pres = pdemo.main(DEMO_ARGS + ["--out", str(tmp_path / "port"),
                                       "--prior_path", prior,
                                       "--device", "cpu"])
    jres = json.load(open(tmp_path / "jax" / "results.json"))
    assert set(pres) == set(jres)
    for key in ("pc", "ode", "config"):
        assert set(pres[key]) == set(jres[key]), key
    for key, value in jres["config"].items():
        if key == "backend":
            continue
        assert_same(pres["config"][key], value, f"config.{key}")
    assert pres["pc"]["nfe"] == jres["pc"]["nfe"]
    jc, pc = jrec.calls, prec.calls
    (p,), (j,) = pc["make_sde"], jc["make_sde"]
    assert_same(p[0][0].model, j[0][0].model, "config.model")
    (p,), (j,) = pc["get_pc_sampler"], jc["get_pc_sampler"]
    same_call(p, j, "get_pc_sampler", positions=[(0, 0), (1, 1)],
              keywords=["predictor", "corrector", "snr", "n_steps"])
    (p,), (j,) = pc["get_ode_sampler"], jc["get_ode_sampler"]
    same_call(p, j, "get_ode_sampler", positions=[(0, 0), (1, 1)],
              keywords=["denoise"])

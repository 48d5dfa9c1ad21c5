"""The port's classifier-guided MNIST sampling against the JAX example at
a tiny setting on the CPU (examples/mnist_clf_guidance.py, run as it
is), on a prior and two classifiers the port writes and both load.

Held: the result keys and per-class entries; the judge's accuracy on the
held-out digits within 1e-2 (argmax of one net's two forwards); the
numeric arguments both samplers are given (the ladder, the sample shape,
the ALD config) within ARG_TOL (1e-6 of the largest magnitude). The
samples come from other noise streams and are checked to be finite
through the agreement rows.
"""
import json

import numpy as np
import torch

from inverseproblemwithdiffusionmodel_tpu_torch.config import (
    load_general_config)
from inverseproblemwithdiffusionmodel_tpu_torch.examples import (
    _common, mnist_clf_guidance as pmnist)
from inverseproblemwithdiffusionmodel_tpu_torch.models.classifier import (
    ResNetClf)
from inverseproblemwithdiffusionmodel_tpu_torch.models.ncsnv2 import NCSNv2
from inverseproblemwithdiffusionmodel_tpu_torch.utils import artifacts
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    seeded_weights)
from tests.torch_examples_common import (
    Recorder, assert_same, load_jax_example, same_call)

torch.set_num_threads(2)

ARGS = ["--size", "32", "--ngf", "8", "--levels", "3", "--n_steps_each",
        "1", "--per_class", "2"]


def test_mnist_clf_guidance_matches_jax(tmp_path):
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        artifacts.save_prior(seeded_weights(NCSNv2(
            _common.ncsn_config(1, 32, 8)), 0, std_scale=0.1),
            str(tmp_path / side / "prior.msgpack"))
        for name, seed in (("guide", 1), ("judge", 2)):
            artifacts.save_prior(seeded_weights(
                ResNetClf(load_general_config()), seed),
                str(tmp_path / side / f"{name}.msgpack"))
    jm = load_jax_example("mnist_clf_guidance", tmp_path / "home")
    with Recorder() as jrec:
        jrec.wrap(jm, "ald_cls_conditioned")
        jrec.wrap(jm, "ald_unconditional_sampler")
        jres = jm.main(ARGS + ["--out", str(tmp_path / "jax")])
    with Recorder() as prec:
        prec.wrap(pmnist, "ald_cls_conditioned")
        prec.wrap(pmnist, "ald_unconditional_sampler")
        pres = pmnist.main(ARGS + ["--out", str(tmp_path / "port"),
                                   "--device", "cpu"])
    assert set(pres) == set(jres)
    assert set(pres["per_class_agreement"]) == \
        set(jres["per_class_agreement"])
    assert abs(pres["judge_test_accuracy"]
               - jres["judge_test_accuracy"]) <= 1e-2
    assert np.isfinite(list(pres["per_class_agreement"].values())).all()
    pj = json.load(open(tmp_path / "port" / "results.json"))
    assert set(pj) == set(json.load(open(tmp_path / "jax" /
                                         "results.json")))
    # JAX: ald_cls_conditioned(score_fn, clf_fn, cls, sigmas, shape, key,
    # cfg) inside one jitted sampler (traced once: cls is an argument);
    # the port calls it once per class
    jc, pc = jrec.calls, prec.calls
    assert len(pc["ald_cls_conditioned"]) == 10
    j = jc["ald_cls_conditioned"][0]
    for p in pc["ald_cls_conditioned"]:
        same_call(p, j, "ald_cls_conditioned", positions=[(3, 3), (4, 4)])
        assert_same(p[1]["config"], j[0][6], "config")
    for c, p in enumerate(pc["ald_cls_conditioned"]):
        assert (p[0][2].numpy() == c).all()
    (p,), (j,) = pc["ald_unconditional_sampler"], \
        jc["ald_unconditional_sampler"]
    same_call(p, j, "ald_unconditional_sampler", positions=[(1, 1), (2, 2)])
    assert_same(p[1]["config"], j[0][4], "config")

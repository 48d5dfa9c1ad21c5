"""The port's prior training, export and checkpoint sweep against the
JAX examples at a tiny setting on the CPU (examples/train_acdc_prior.py,
export_prior_artifact.py and acdc_ckpt_sweep.py, run as they are).

Held: the trainer's ladder, data mode and optimizer settings and every
training batch (the JAX run's dataset, indices and flips) within ARG_TOL
(1e-6 of the largest magnitude); the files each run writes; the priors
of each run loading in the other package; the exported bf16 artifact of
a JAX checkpoint byte for byte the JAX tool's; the sweep's jobs and JSON
rows, its reconstructor's arguments and the chains' measurement within
ARG_TOL.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from inverseproblemwithdiffusionmodel_tpu.config import Config as JConfig
from inverseproblemwithdiffusionmodel_tpu.models.ncsnv2 import (
    NCSNv2 as JNCSNv2)
from inverseproblemwithdiffusionmodel_tpu_torch.examples import (
    _common, acdc_ckpt_sweep as psweep, export_prior_artifact as pexport,
    train_acdc_prior as ptrain)
from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
    get_network)
from inverseproblemwithdiffusionmodel_tpu_torch.utils import artifacts
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    seeded_weights)
from tests.torch_examples_common import (
    Recorder, assert_same, load_jax_example, same_call)

torch.set_num_threads(2)

RECON = "make_stepped_pair_reconstructor"
TRAIN_ARGS = ["--size", "16", "--ngf", "8", "--n_train", "6", "--ladder_n",
              "6", "--levels", "5", "--steps", "4", "--scan_k", "2",
              "--snap_every", "2", "--ckpt_every", "2", "--sync_every", "1"]


def _template(size=16, ngf=8):
    cfg = JConfig({"data": {"channels": 1, "image_size": size,
                            "logit_transform": False, "rescaled": False},
                   "model": {"ngf": ngf, "nonlinearity": "elu",
                             "normalization": "InstanceNorm++"}})
    return JNCSNv2(config=cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 1)),
        jnp.ones((1,)))["params"]


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_prior")
    jt = load_jax_example("train_acdc_prior", tmp / "home")
    with Recorder() as jrec:
        jrec.wrap(jt, "make_score_train_step")
        jrec.wrap(jt, "get_optimizer")
        jt.main(TRAIN_ARGS + ["--out", str(tmp / "jax")])
    with Recorder() as prec:
        prec.wrap(ptrain, "make_score_train_step", returns=True)
        prec.wrap(ptrain, "get_optimizer")
        ptrain.main(TRAIN_ARGS + ["--out", str(tmp / "port"),
                                  "--device", "cpu"])
    return dict(tmp=tmp, jrec=jrec.calls, prec=prec.calls, jt=jt)


def test_trainer_arguments_and_batches(train_runs):
    jc, pc = train_runs["jrec"], train_runs["prec"]
    key = "make_score_train_step"
    (p,), (j,) = pc[key], jc[key]
    same_call(p, j, key, positions=[(1, 1)], keywords=["data_mode"])
    (p,), (j,) = pc["get_optimizer"], jc["get_optimizer"]
    assert_same(p[0][0].optim, j[0][0].optim, "optim config")
    # every batch the port's step saw is the JAX run's: its dataset, the
    # per-step RandomState([seed, i]) indices and flips
    ens = load_jax_example("acdc_sense_ensemble", train_runs["tmp"] / "home")
    data = ens.make_dataset(6, 16, 0)
    batches = [c[0][1] for c in pc[key + "()"]]
    assert len(batches) == 4
    for i, b in enumerate(batches):
        rs = np.random.RandomState([0, i])
        idx = rs.choice(len(data), 3)
        flip = rs.rand(3) < 0.5
        want = np.where(flip[:, None, None, None], data[idx][:, :, ::-1],
                        data[idx])
        assert_same(b, want, f"batch {i}")


def test_training_files_and_cross_reads(train_runs):
    tmp = train_runs["tmp"]
    ckpts = {"train_state.ckpt", "train_state.ckpt.fp", "train_state.pt",
             "train_state.pt.fp"}
    jfiles = set(os.listdir(tmp / "jax")) - ckpts
    pfiles = set(os.listdir(tmp / "port")) - ckpts
    assert pfiles == jfiles
    assert (tmp / "port" / "train_state.pt").exists()
    template = _template()
    for name in ("prior.msgpack", "prior_000004.msgpack",
                 "raw_final.msgpack"):
        # the port's file restores into the JAX net's params
        restored = serialization.from_bytes(
            template, open(tmp / "port" / name, "rb").read())
        assert jax.tree_util.tree_structure(restored) == \
            jax.tree_util.tree_structure(template)
        # and the JAX run's loads into the port's net
        artifacts.load_prior(str(tmp / "jax" / name), get_network(
            _common.ncsn_config(1, 16, 8)))


def test_export_matches_the_jax_tool(train_runs):
    tmp = train_runs["tmp"]
    je = load_jax_example("export_prior_artifact", tmp / "home")
    je.main(["--run", str(tmp / "jax"), "--out", str(tmp / "jax_art")])
    pexport.main(["--run", str(tmp / "jax"), "--out", str(tmp / "port_art")])
    for name in ("raw_bf16.msgpack", "ema_bf16.msgpack"):
        assert (tmp / "port_art" / name).read_bytes() == \
            (tmp / "jax_art" / name).read_bytes(), name
    assert json.load(open(tmp / "port_art" / "META.json")) == \
        json.load(open(tmp / "jax_art" / "META.json"))
    # a port checkpoint exports in the same layout, and warm-starts a run
    pexport.main(["--run", str(tmp / "port"), "--out", str(tmp / "port_art2")])
    tree = serialization.msgpack_restore(
        (tmp / "port_art2" / "ema_bf16.msgpack").read_bytes())
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(_template())
    assert json.load(open(tmp / "port_art2" / "META.json"))["step"] == 4
    ptrain.main(TRAIN_ARGS[:-6] + ["--steps", "6", "--snap_every", "100",
                                   "--ckpt_every", "100", "--out",
                                   str(tmp / "warm"), "--device", "cpu",
                                   "--warm_start", str(tmp / "jax_art")])
    assert (tmp / "warm" / "prior.msgpack").exists()


SWEEP_ARGS = ["--size", "16", "--ngf", "8", "--levels", "3", "--chains",
              "2", "--lr_grid", "3e5", "--anneal_lr", "1e5", "--anneal_start",
              "0.1", "--raw_lr", "3e5", "--cg_iters", "4"]


def test_ckpt_sweep_matches_jax(tmp_path):
    """Both sweeps over the same two snapshots (EMA and raw Flax files
    the port writes): the jobs, the JSON rows' keys, the reconstructor's
    arguments and the chains' measurement."""
    run = tmp_path / "run"
    run.mkdir()
    for step in (1, 2):
        for kind in ("prior", "raw"):
            artifacts.save_prior(seeded_weights(get_network(
                _common.ncsn_config(1, 16, 8)), step, std_scale=0.1),
                str(run / f"{kind}_{step:06d}.msgpack"))
    js = load_jax_example("acdc_ckpt_sweep", tmp_path / "home")
    with Recorder() as jrec:
        jrec.wrap(js, RECON, returns=True)
        js.main(SWEEP_ARGS + ["--run", str(run), "--out",
                              str(tmp_path / "jax.jsonl")])
    with Recorder() as prec:
        prec.wrap(psweep, RECON, returns=True)
        psweep.main(SWEEP_ARGS + ["--run", str(run), "--out",
                                  str(tmp_path / "port.jsonl"),
                                  "--device", "cpu"])
    jrows = [json.loads(l) for l in open(tmp_path / "jax.jsonl")]
    prows = [json.loads(l) for l in open(tmp_path / "port.jsonl")]
    assert len(prows) == len(jrows) == 6      # 2 snapshots x 3 probes
    for p, j in zip(prows, jrows):
        assert set(p) == set(j)
        for k in ("step", "kind", "lr_scaled", "schedule", "chains",
                  "slice", "n_steps_each", "eff_weight", "R"):
            assert p[k] == j[k], k
        assert np.isfinite([p["nrmse"], p["ssim"]]).all()
    jc, pc = jrec.calls, prec.calls
    # JAX builds a reconstructor per (lr, schedule); the port per probe
    jfac = {(float(np.asarray(c[1]["lr_scaled"]).ravel()[0])): c
            for c in jc[RECON]}
    for p in pc[RECON]:
        lr = float(np.asarray(p[1]["lr_scaled"]).ravel()[0])
        j = jfac[lr]
        same_call(p, j, RECON, positions=[(1, 1), (2, 2), (4, 4)],
                  keywords=["lr_scaled"])
        assert_same(p[0][3].lin_tfm, j[0][3].lin_tfm, "proximal.lin_tfm")
        assert p[0][3].num_iters == j[0][3].num_iters == 4
    for p, j in zip(pc[RECON + "()"], jc[RECON + "()"]):
        assert_same(p[0][0], j[0][1], "yr")
        assert_same(p[0][1], j[0][2], "yi")

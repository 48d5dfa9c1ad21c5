"""The port's chain-scaling experiment against the JAX example on the
CPU (examples/chain_scaling.py, run as it is).

Held: the mesh audit on a mesh of 8 CPU entries (the port: no tensor
crosses shards inside a level, only the CG's scalar sums, 2 x 4 + 1 per
inner step, and the sharded chain equals the chain without a mesh within
rel 1e-4 (float32 CG sums in another order); JAX: its compiled program's
collective census, no tensor collective), the projection's arithmetic,
and the sweep's scaling.json layout (JAX's sweep shells out to bench.py
on a TPU and is not run here).
"""
import json

import numpy as np
import torch

from inverseproblemwithdiffusionmodel_tpu_torch.examples import (
    chain_scaling as pscale)
from tests.torch_examples_common import load_jax_example

torch.set_num_threads(2)


def test_chain_scaling_mesh_audit(capsys):
    jc = load_jax_example("chain_scaling", "/nonexistent-home")
    jc.main(["--mode", "mesh"])
    jout = capsys.readouterr().out
    jres = json.loads(jout[jout.index("\n{\n") + 1:])
    assert jres["n_chips"] == 8
    assert all(jres["collectives"][op] == 0 for op in (
        "all-gather", "all-to-all", "collective-permute", "reduce-scatter"))
    pres = pscale.main(["--mode", "mesh"])
    assert pres["n_chips"] == jres["n_chips"]
    assert pres["census_per_level"]["tensor_gather"] == 0
    # n_steps_each 2 x (2 x 4 CG iterations + the initial residual's)
    assert pres["census_per_level"]["scalar_all_reduce"] == 18
    assert pres["sharded_vs_plain_max_rel"] < 1e-4
    assert pres["projected_8_entry_chain_steps_per_sec"] == \
        jres["projected_v5e8_chain_steps_per_sec"]


def test_chain_scaling_sweep_writes_the_table(tmp_path, monkeypatch):
    """The sweep's scaling.json: one record per chain count with the JAX
    bench record's value and unit (here on the CPU at 32 px)."""
    monkeypatch.setattr(pscale, "SIZE", 32)
    out = pscale.main(["--mode", "sweep", "--batches", "2", "--levels",
                       "1", "--n_steps", "1", "--device", "cpu", "--out",
                       str(tmp_path)])
    rec = json.load(open(tmp_path / "scaling.json"))
    assert sorted(rec) == ["2"] and sorted(out) == [2]
    for r in rec.values():
        assert r["unit"] == "chain-steps/s" and np.isfinite(r["value"])
        assert r["device"] == "cpu"

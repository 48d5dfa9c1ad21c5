"""The port's TensorBoard bridge (utils/tb_export.py, scripts/
export_tensorboard.py, MetricsLogger(tensorboard=True), FitConfig.
tensorboard) read back through tensorboard's event reader, and held to the
JAX package's converter on the same metrics.jsonl."""
import json
import os
import warnings

import numpy as np
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu.utils import tb_export as jtb
from inverseproblemwithdiffusionmodel_tpu_torch.training import (
    FitConfig, MetricsLogger, TrainState, fit)
from inverseproblemwithdiffusionmodel_tpu_torch.utils import tb_export

pytest.importorskip("torch.utils.tensorboard")


def jsonl_records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def as_scalars(records):
    """metrics.jsonl records as {tag: [(step, value, walltime)]}."""
    out = {}
    for rec in records:
        for k, v in rec.items():
            if k not in ("ts", "step"):
                out.setdefault(k, []).append((rec["step"], v, rec["ts"]))
    return out


def assert_same_scalars(events, records):
    want = as_scalars(records)
    assert sorted(events) == sorted(want)
    for tag, rows in want.items():
        got = events[tag]
        assert [s for s, _, _ in got] == [s for s, _, _ in rows]
        np.testing.assert_array_equal(
            np.float32([v for _, v, _ in got]),
            np.float32([v for _, v, _ in rows]))
        np.testing.assert_allclose([w for _, _, w in got],
                                   [w for _, _, w in rows], rtol=0,
                                   atol=1e-3)


def write_jsonl(path, n=5):
    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps({"ts": 1.7e9 + i, "step": 10 * i,
                                "train_loss": 1.0 / (i + 1),
                                "steps_per_sec": 3.5 + i}) + "\n")
        f.write("not json\n\n")
        f.write(json.dumps({"ts": 1.7e9 + 9, "step": 99, "val_loss": 0.25,
                            "note": "text is skipped"}) + "\n")


def test_jsonl_to_events_reads_back_and_matches_jax(tmp_path):
    path = str(tmp_path / "run" / "metrics.jsonl")
    os.makedirs(os.path.dirname(path))
    write_jsonl(path)
    out = tb_export.jsonl_to_events(path)
    assert out == str(tmp_path / "run" / "tb")
    records = [r for r in (json.loads(line) for line in open(path)
                           if line.strip().startswith("{"))]
    records = [{k: v for k, v in r.items() if k != "note"} for r in records]
    ours = tb_export.read_scalars(out)
    assert_same_scalars(ours, records)
    theirs = tb_export.read_scalars(jtb.jsonl_to_events(
        path, str(tmp_path / "jax_tb")))
    assert ours == theirs


def test_metrics_logger_mirrors_to_tensorboard(tmp_path):
    logger = MetricsLogger(str(tmp_path), tensorboard=True)
    for step in range(1, 4):
        logger.log(step, train_loss=2.0 / step, lr=1e-3)
    logger.close()
    assert_same_scalars(tb_export.read_scalars(str(tmp_path / "tb")),
                        jsonl_records(logger.path))
    plain = MetricsLogger(str(tmp_path / "plain"))
    plain.log(1, train_loss=1.0)
    plain.close()
    assert not os.path.exists(tmp_path / "plain" / "tb")


def test_mirror_warns_and_jsonl_is_still_written(tmp_path, monkeypatch):
    """Where tensorboard does not import, the mirror warns once and writes
    nothing, metrics.jsonl is written, and jsonl_to_events raises."""
    import builtins
    real_import = builtins.__import__

    def no_tb(name, *a, **k):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("no tensorboard here")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_tb)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        logger = MetricsLogger(str(tmp_path), tensorboard=True)
        logger.log(1, train_loss=1.5)
        logger.log(2, train_loss=0.5)
        logger.close()
    assert len([w for w in caught if "TensorBoard export unavailable"
                in str(w.message)]) == 1
    assert not os.path.exists(tmp_path / "tb")
    assert [r["train_loss"] for r in jsonl_records(logger.path)] == [1.5,
                                                                      0.5]
    with pytest.raises(RuntimeError, match="not importable"), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tb_export.jsonl_to_events(logger.path)


def test_fit_with_tensorboard_writes_both_streams(tmp_path):
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 1)
    state = TrainState.create(
        model, lambda params: torch.optim.SGD(params, lr=0.1),
        ema_decay=None)

    def step(state, batch, gen):
        loss = model(torch.as_tensor(batch)).pow(2).mean()
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    data = np.random.RandomState(0).rand(8, 3).astype(np.float32)
    fit(state, step, lambda: iter(np.split(data, 4)),
        FitConfig(n_epochs=2, log_every=2, log_dir=str(tmp_path),
                  tensorboard=True))
    records = jsonl_records(str(tmp_path / "metrics.jsonl"))
    assert [r["step"] for r in records] == [2, 4, 6, 8]
    assert_same_scalars(tb_export.read_scalars(str(tmp_path / "tb")),
                        records)


def test_export_tensorboard_cli(tmp_path, capsys):
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
        export_tensorboard)
    for run in ("a", "b/c"):
        os.makedirs(tmp_path / run)
        write_jsonl(str(tmp_path / run / "metrics.jsonl"), n=3)
    assert export_tensorboard.main(["--run_dir", str(tmp_path)]) == 0
    printed = capsys.readouterr().out
    assert printed.count("[export_tensorboard]") == 2
    for run in ("a", "b/c"):
        scalars = tb_export.read_scalars(str(tmp_path / run / "tb"))
        assert [s for s, _, _ in scalars["train_loss"]] == [0, 10, 20]
    single = str(tmp_path / "a" / "metrics.jsonl")
    assert export_tensorboard.main(["--run_dir", single, "--out_dir",
                                    str(tmp_path / "out")]) == 0
    assert "val_loss" in tb_export.read_scalars(str(tmp_path / "out"))
    os.makedirs(tmp_path / "empty")
    with pytest.raises(SystemExit, match="no .jsonl"):
        export_tensorboard.main(["--run_dir", str(tmp_path / "empty")])

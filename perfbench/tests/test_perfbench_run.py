"""A whole run at a tiny size on the CPU (the look for a chip skipped):
the result's shape, its last key, and the refusals."""
import json
import os
import subprocess
import sys

import pytest
import torch

from perfbench import harness, imports, spec

import tiny

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _shape(result, cell, trace):
    keys = list(result)
    assert keys[:5] == RESULT_KEYS and keys[-1] == "checks"
    assert ("breakdown" in keys) == bool(trace)
    wanted = {m["name"] for m in (cell["per_layer"] if trace else cell["end_to_end"])}
    if not trace:
        assert set(result["metrics"]) == wanted - {"train_peak_mem_gib"}  # no CUDA here
    else:
        assert set(result["metrics"]) <= wanted
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for row in result["checks"].values():
        assert set(row) == {"value", "limit"}
    json.dumps(result)


@pytest.mark.parametrize("name,trace", [("case33_mappo.train512", 0),
                                        ("case33_mappo.train8192", 1),
                                        ("case33_mappo.eval1", 0),
                                        ("case33_mappo.eval1", 1)])
def test_result_line(name, trace):
    cell = tiny.cell(name)
    result, rows = harness.run(name, 2 ** 31 + 99, 0.5, trace, device="cpu", cell=cell)
    _shape(result, cell, trace)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    if trace:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert imports.loaded_forbidden() == [] or "jax" in sys.modules  # the suite may load JAX


def test_refuses_without_a_chip():
    """No CUDA device here: the run exits 2 and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, os.path.join(spec.HERE, "run.py"), "--workload",
                          "case33_mappo.train512", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=spec.ROOT, timeout=300)
    assert out.returncode == 2 and out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr


def test_refuses_forbidden_modules(monkeypatch, capsys):
    """A run whose process holds JAX or the JAX package exits 1 with no
    result, naming what it found."""
    monkeypatch.setattr(harness, "run", lambda *a, **k: ({"correct": True}, []))
    monkeypatch.setitem(sys.modules, "mapdn_tpu", type(sys)("mapdn_tpu"))
    args = type("A", (), {"workload": "x", "seed": 1, "seconds": 1, "trace": 0})()
    assert harness.main(args, 0.0) == 1
    out = capsys.readouterr()
    assert out.out == "" and "mapdn_tpu" in out.err


def test_refuses_in_a_bare_checkout(tmp_path):
    """Only BENCHMARK.json and perfbench/: the program is missing, so the
    run fails before any result."""
    import shutil
    shutil.copytree(spec.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "case33_mappo.train512", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_refuses_a_chunk_it_cannot_record(monkeypatch):
    """A trainer whose chunk runs past the recorder's hooks (one replayed
    whole, say) fails the run in set-up instead of looping."""
    import contextlib
    from perfbench import record
    monkeypatch.setattr(record.TrainRecorder, "installed",
                        lambda self, trainer: contextlib.nullcontext(self))
    with pytest.raises(RuntimeError, match="recorder saw fewer chunks"):
        harness.run("case33_mappo.train512", 5, 0.1, 0, device="cpu",
                    cell=tiny.cell("case33_mappo.train512"))

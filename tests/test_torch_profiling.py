"""mapdn_torch.utils.profiling on the CPU: ``PhaseTimer`` (the
counterpart of tests/test_subsystems.py:99-110), ``device_trace`` writing
a Chrome trace of a case33 env step that names the program's spans, and
``enable_nan_debugging``.  Imports no JAX (the tracer on the main path:
tests/test_torch_tracing.py)."""
import json
import os

import pytest
import torch

from mapdn_torch.envs import EnvConfig, make_env
from mapdn_torch.utils.profiling import (PhaseTimer, Tracer, device_trace,
                                         enable_nan_debugging, tracing)

torch.set_num_threads(1)


def test_phase_timer():
    t = PhaseTimer()
    with t.phase("a"):
        x = torch.ones((16, 16)).sum()
    with t.phase("a", block_on={"x": x, "rest": [x, (x,)]}):
        pass
    with t.phase("b", block_on=x):
        pass
    s = t.summary()
    assert s["a"]["count"] == 2 and s["a"]["total_s"] >= 0
    assert s["b"]["count"] == 1 and s["b"]["mean_ms"] >= 0
    assert list(s) == ["a", "b"]


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """A traced env step of 4 case33 lanes: the trace file is JSON whose
    events name the ops that ran (on the CPU: the plain solver's matmuls).
    Under an active tracer it also names the program's spans on the same
    clock: ``env.step`` around ``pf.solve``, and that around the solver's
    ops."""
    env = make_env("case33", EnvConfig(), days=2, dtype=torch.float32, device="cpu")
    state, _, _ = env.reset(4, torch.Generator().manual_seed(0))
    log_dir = str(tmp_path / "trace")
    tracer = Tracer()
    with tracing(tracer), device_trace(log_dir) as prof:
        env.step(state, torch.zeros((4, env.grid.n_sgen)), torch.Generator().manual_seed(1))
    assert prof.trace_path == os.path.join(log_dir, "trace.json")
    with open(prof.trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("matmul" in n or "mm" in n for n in names), sorted(names)[:20]
    assert any(k.key.startswith("aten::") for k in prof.key_averages())

    ranges = {n: [e for e in events if e.get("name") == n and "dur" in e]
              for n in ("env.step", "pf.solve")}
    assert len(ranges["env.step"]) == 1 and len(ranges["pf.solve"]) == 1, sorted(names)[:40]
    inside = lambda e, outer: (outer["ts"] <= e["ts"]
                               and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"])
    step, solve = ranges["env.step"][0], ranges["pf.solve"][0]
    assert inside(solve, step)
    ops = [e for e in events if e.get("name", "").startswith("aten::") and "dur" in e]
    assert any(inside(e, solve) for e in ops)
    assert set(tracer.summary()["spans"]) == {"env.step", "pf.solve"}


def test_enable_nan_debugging_traps_nan_in_backward():
    """Anomaly mode names the op whose backward made a NaN; turned off again
    after the test."""
    before = torch.is_anomaly_enabled()
    try:
        enable_nan_debugging()
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.warns(UserWarning), pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    finally:
        torch.autograd.set_detect_anomaly(before)

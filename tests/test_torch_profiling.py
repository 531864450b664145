"""mapdn_torch.utils.profiling on the CPU: ``PhaseTimer`` (the
counterpart of tests/test_subsystems.py:99-110), ``device_trace`` writing
a Chrome trace of a case33 env step, and ``enable_nan_debugging``.
Imports no JAX."""
import json
import os

import pytest
import torch

from mapdn_torch.envs import EnvConfig, make_env
from mapdn_torch.utils.profiling import PhaseTimer, device_trace, enable_nan_debugging

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
    events name the ops that ran (on the CPU: the plain solver's matmuls)."""
    env = make_env("case33", EnvConfig(), days=2, dtype=torch.float32, device="cpu")
    state, _, _ = env.reset(4, torch.Generator().manual_seed(0))
    log_dir = str(tmp_path / "trace")
    with device_trace(log_dir) as prof:
        env.step(state, torch.zeros((4, env.grid.n_sgen)), torch.Generator().manual_seed(1))
    assert prof.trace_path == os.path.join(log_dir, "trace.json")
    with open(prof.trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("matmul" in n or "mm" in n for n in names), sorted(names)[:20]
    assert any(k.key.startswith("aten::") for k in prof.key_averages())


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

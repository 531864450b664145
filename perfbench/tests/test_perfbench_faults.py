"""Whole runs at a tiny size on the CPU with the timed path broken
underneath: each fault a cell can have turns ``correct`` false, under the
cell's own limits.  A sound run of the same size passes them
(test_perfbench_run.py).  A fault planted after the set-up's followed
chunks breaks only the window's chunks, which the window's sample holds."""
import pytest

from perfbench import harness, spec

import tiny

TRAIN = ["case33_mappo.train512", "case33_mappo.train8192"]


def _run_with(name, fault_name, monkeypatch, window_only=False):
    cell = tiny.cell(name)
    runner_cls = spec.kind(cell["traffic"]["kind"]).Runner
    planted = []
    hook = runner_cls.first_steps if window_only else runner_cls.setup

    def plant(self, *args):
        out = hook(self, *args)
        planted.append(self.fault(fault_name))
        planted[-1].__enter__()
        return out

    monkeypatch.setattr(runner_cls, hook.__name__, plant)
    try:
        result, _ = harness.run(name, 1234567, 0.5, 0, device="cpu", cell=cell)
    finally:
        for p in planted:
            p.__exit__(None, None, None)
    return result


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault_name", ["unchanged", "half_batch", "solver"])
def test_training_faults_fail(name, fault_name, monkeypatch):
    assert not _run_with(name, fault_name, monkeypatch)["correct"]


@pytest.mark.parametrize("fault_name", ["unchanged", "half_batch"])
def test_window_faults_fail(fault_name, monkeypatch):
    result = _run_with("case33_mappo.train512", fault_name, monkeypatch, window_only=True)
    checks = result["checks"]
    assert not result["correct"]
    # the set-up's chunks ran sound: only the window's numbers fail
    failed = {k for k, row in checks.items() if row["value"] > row["limit"]}
    assert failed and all(k.startswith("w_") for k in failed), failed


@pytest.mark.parametrize("fault_name", ["frozen_step", "solver"])
def test_eval_faults_fail(fault_name, monkeypatch):
    assert not _run_with("case33_mappo.eval1", fault_name, monkeypatch)["correct"]

"""The per-layer metrics read from the program's own spans and counters
(perfbench/program_spans.py), in whole tiny ``--trace 1`` runs on the
CPU: the host-side ones are reported, the stream ones (CUDA events) are
not, and every metric read before the program's stretch reads what the
record held before it ran.  A program without the tracer gives none of
them, and the run still succeeds."""
import copy

import pytest

from perfbench import harness, program_spans, spec, traffic

import tiny

NEW = {"rollout_host_ms_per_step", "pf_solve_stream_ms.train", "pf_solve_stream_ms.eval",
       "host_sync_ms_per_step.train", "host_sync_ms_per_step.eval",
       "nr_iters_per_lane_solve", "reset_solves_per_step", "terminated_lanes_per_step"}
HOST_SIDE = {"case33_mappo.train8192": {"rollout_host_ms_per_step",
                                        "host_sync_ms_per_step.train",
                                        "nr_iters_per_lane_solve", "reset_solves_per_step",
                                        "terminated_lanes_per_step"},
             "case33_mappo.eval1": {"host_sync_ms_per_step.eval"}}


def _traced_run(monkeypatch, name):
    """A tiny traced run of ``name``; returns the result and a copy of the
    record ``Runner.trace`` returned, taken before any reader ran."""
    kept = {}
    make = traffic.make

    def keeping(*a, **kw):
        runner = make(*a, **kw)
        trace = runner.trace

        def trace_kept(*ta, **tkw):
            rec = trace(*ta, **tkw)
            kept["rec"] = copy.deepcopy(rec)
            kept["after"] = rec
            return rec
        runner.trace = trace_kept
        return runner

    monkeypatch.setattr(traffic, "make", keeping)
    cell = tiny.cell(name)
    result, _ = harness.run(name, 2 ** 31 + 17, 0.5, 1, device="cpu", cell=cell)
    return cell, result, kept


@pytest.mark.parametrize("name", sorted(HOST_SIDE))
def test_new_metrics_and_the_old_unchanged(monkeypatch, name):
    cell, result, kept = _traced_run(monkeypatch, name)
    assert result["correct"], result["checks"]
    reported = set(result["metrics"])
    assert reported & NEW == HOST_SIDE[name]
    program = kept["after"]["program"]
    assert program["env_steps"] > 0 and program["rate"] > 0 and program["untraced_rate"] > 0
    # the stretch added its summary and changed nothing the other readers read
    assert {k: v for k, v in kept["after"].items() if k != "program"} == kept["rec"]
    for m in cell["per_layer"]:
        if m["name"] in NEW:
            continue
        before = spec.reader(m["name"])(copy.deepcopy(kept["rec"]))
        assert (before is None) == (m["name"] not in reported)
        if before is not None:
            assert result["metrics"][m["name"]]["value"] == before
    for k in HOST_SIDE[name]:
        assert result["metrics"][k]["value"] >= 0.0
    if name.endswith("train8192"):
        spans = program["spans"]
        assert spans["train.rollout_step"]["calls"] == spans["env.step"]["calls"] > 0
        assert result["metrics"]["nr_iters_per_lane_solve"]["value"] >= 1.0


@pytest.mark.parametrize("name", sorted(HOST_SIDE))
def test_a_program_without_the_tracer(monkeypatch, name):
    """As on a checkout from before the tracer: no stretch, no new metric,
    the run as it was."""
    from mapdn_torch.utils import profiling
    monkeypatch.delattr(profiling, "Tracer")
    cell, result, kept = _traced_run(monkeypatch, name)
    assert result["correct"], result["checks"]
    assert not set(result["metrics"]) & NEW
    assert kept["after"]["program"] is None


def test_outside_a_run():
    """A record read with no harness around it gives nothing."""
    rec = {"kind": "train"}
    assert program_spans.of(rec) is None and program_spans.span(rec, "env.step") is None
    for name in NEW:
        assert spec.reader(name)({"kind": "train"}) is None
        assert spec.reader(name)({"kind": "eval"}) is None

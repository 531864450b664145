"""Lanes terminated a vectorized training step (an episode's end, a
diverged solve, a failed reset), from the program's counter
``env.terminated_lanes`` over the calls of its span ``env.step``
(perfbench/program_spans.py)."""
from perfbench import program_spans


def read(rec):
    if rec.get("kind") != "train":
        return None
    steps = program_spans.span(rec, "env.step")
    lanes = program_spans.counter(rec, "env.terminated_lanes")
    if not steps or not steps["calls"] or lanes is None:
        return None
    return lanes / steps["calls"]

"""Host milliseconds of one vectorized rollout step (policy, env step with
its solves, the transition), from the program's own span
``train.rollout_step`` over a stretch with no synchronize
(perfbench/program_spans.py): the time the host spends issuing the step."""
from perfbench import program_spans


def read(rec):
    if rec.get("kind") != "train":
        return None
    s = program_spans.span(rec, "train.rollout_step")
    if not s or not s["calls"]:
        return None
    return s["host_s"] / s["calls"] * 1e3

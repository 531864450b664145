"""Reset solves a vectorized training step: the batched reset attempts
(each one solve, run on a step where some lane terminated) over the env
steps, from the calls of the program's spans ``env.reset`` and
``env.step`` (perfbench/program_spans.py)."""
from perfbench import program_spans


def read(rec):
    if rec.get("kind") != "train":
        return None
    steps, resets = program_spans.span(rec, "env.step"), program_spans.span(rec, "env.reset")
    if not steps or not steps["calls"]:
        return None
    return resets["calls"] / steps["calls"]

"""Newton iterations of one lane's power-flow solve, averaged over every
lane of every solve of a training stretch, from the program's counters
``pf.nr_iters`` and ``pf.lane_solves`` (perfbench/program_spans.py)."""
from perfbench import program_spans


def read(rec):
    if rec.get("kind") != "train":
        return None
    iters = program_spans.counter(rec, "pf.nr_iters")
    lane_solves = program_spans.counter(rec, "pf.lane_solves")
    if iters is None or not lane_solves:
        return None
    return iters / lane_solves

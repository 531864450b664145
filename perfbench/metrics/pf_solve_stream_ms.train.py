"""Milliseconds of the device stream from the start to the end of one
batched power-flow solve of a training rollout (pack, kernel, unpack,
bus and branch results), from the CUDA events of the program's own span
``pf.solve`` (perfbench/program_spans.py): no synchronize closes it.
None on the CPU, where the span has no events."""
from perfbench import program_spans


def read(rec):
    if rec.get("kind") != "train":
        return None
    s = program_spans.span(rec, "pf.solve")
    if not s or not s["calls"] or s["stream_s"] is None:
        return None
    return s["stream_s"] / s["calls"] * 1e3

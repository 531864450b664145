"""Stream milliseconds a training chunk spends gathering its update steps'
windows from a ring longer than a window (span ``replay.gather``), from
the program's own spans over a stretch with no synchronize
(perfbench/program_spans.py).  None where the program opens no such span
or runs on the CPU."""
from perfbench import program_spans


def read(rec):
    if rec.get("kind") != "train":
        return None
    chunks = program_spans.span(rec, "train.chunk")
    gather = program_spans.span(rec, "replay.gather")
    if not chunks or not chunks["calls"] or not gather["calls"] or gather["stream_s"] is None:
        return None
    return gather["stream_s"] / chunks["calls"] * 1e3

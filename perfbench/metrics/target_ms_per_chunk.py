"""Stream milliseconds a training chunk spends on its target networks: the
losses' bootstraps (the next-state policy and the target critic, span
``update.target``) and the soft target update (``train.target_update``),
from the program's own spans over a stretch with no synchronize
(perfbench/program_spans.py).  None where the program opens no
``update.target`` span or runs on the CPU."""
from perfbench import program_spans


def read(rec):
    if rec.get("kind") != "train":
        return None
    chunks = program_spans.span(rec, "train.chunk")
    boot = program_spans.span(rec, "update.target")
    soft = program_spans.span(rec, "train.target_update")
    if not chunks or not chunks["calls"] or not boot["calls"] or boot["stream_s"] is None:
        return None
    return (boot["stream_s"] + (soft["stream_s"] or 0.0)) / chunks["calls"] * 1e3

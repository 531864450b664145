"""Stream milliseconds a training chunk spends in the attention critic's
forwards inside its losses (span ``update.critic``: the behaviour critic's
and the bootstrap's target critic's), from the program's own spans over a
stretch with no synchronize (perfbench/program_spans.py).  None where the
program opens no ``update.critic`` span or runs on the CPU."""
from perfbench import program_spans


def read(rec):
    if rec.get("kind") != "train":
        return None
    chunks = program_spans.span(rec, "train.chunk")
    critic = program_spans.span(rec, "update.critic")
    if not chunks or not chunks["calls"] or not critic["calls"] or critic["stream_s"] is None:
        return None
    return critic["stream_s"] / chunks["calls"] * 1e3

"""Stream milliseconds a training chunk spends in the fused GRU policy's
kernels (spans ``policy.fused_fwd``, the forward kernel in a policy loss,
and ``policy.fused_bwd``, the backward kernel and the blocks' sum), from
the program's own spans over a stretch with no synchronize
(perfbench/program_spans.py).  None where the program opens neither span
or runs on the CPU."""
from perfbench import program_spans

SPANS = ("policy.fused_fwd", "policy.fused_bwd")


def stream_seconds(rec):
    """The two spans' stream seconds over the traced stretch, or None."""
    found = [program_spans.span(rec, name) for name in SPANS]
    if any(s is None for s in found) or not any(s["calls"] for s in found):
        return None
    if any(s["calls"] and s["stream_s"] is None for s in found):
        return None
    return sum(s["stream_s"] or 0.0 for s in found)


def read(rec):
    if rec.get("kind") != "train":
        return None
    chunks = program_spans.span(rec, "train.chunk")
    seconds = stream_seconds(rec)
    if not chunks or not chunks["calls"] or seconds is None:
        return None
    return seconds / chunks["calls"] * 1e3

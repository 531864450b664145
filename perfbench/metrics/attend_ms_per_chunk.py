"""Stream milliseconds a training chunk spends in the attention critic's
attention (span ``update.attend``, inside ``update.critic``: the key,
selector and value projections, the logits, the masked softmax, the
weighted sum and the regulariser), from the program's own spans over a
stretch with no synchronize (perfbench/program_spans.py).  None where the
program opens no ``update.attend`` span or runs on the CPU."""
from perfbench import program_spans


def read(rec):
    if rec.get("kind") != "train":
        return None
    chunks = program_spans.span(rec, "train.chunk")
    attend = program_spans.span(rec, "update.attend")
    if not chunks or not chunks["calls"] or not attend["calls"] or attend["stream_s"] is None:
        return None
    return attend["stream_s"] / chunks["calls"] * 1e3

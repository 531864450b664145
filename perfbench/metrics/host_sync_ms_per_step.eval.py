"""Host milliseconds an evaluation step spends waiting at blocking
reads of the device (the auto-reset gate, the reset retry, the window
start, the read-backs of stats and records), from the program's own span
``host.sync`` over its ``env.step`` calls (perfbench/program_spans.py)."""
from perfbench import program_spans


def read(rec):
    if rec.get("kind") != "eval":
        return None
    steps, s = program_spans.span(rec, "env.step"), program_spans.span(rec, "host.sync")
    if not steps or not steps["calls"]:
        return None
    return s["host_s"] / steps["calls"] * 1e3

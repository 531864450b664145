"""The fused GRU policy kernels' share of their roofline, in percent: the
least time the differentiated policy rows of the traced stretch (counter
``policy.fused_rows``) need at the card's float32 and HBM peaks, counted
at the run's obs width (perfbench/policy_counting.py), over the stream
seconds of the spans ``policy.fused_fwd`` and ``policy.fused_bwd``
(perfbench/program_spans.py).  None where the program counts no fused
rows or opens neither span."""
import json
import os

from perfbench import counting, policy_counting, program_spans, spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def read(rec):
    if rec.get("kind") != "train":
        return None
    runner = program_spans._runner_of(rec)
    rows = program_spans.counter(rec, "policy.fused_rows")
    fused = spec._module("metrics", "policy_fused_ms_per_chunk", ROOT)
    seconds = fused.stream_seconds(rec)
    if runner is None or not rows or not seconds:
        return None
    with open(os.path.join(ROOT, "perfbench", "peaks.json")) as fh:
        peaks = json.load(fh)
    obs = runner.dims["obs"]
    bound, _ = counting.roofline_seconds(policy_counting.step_flops(rows, obs),
                                         policy_counting.step_bytes(rows, obs), peaks)
    return bound / seconds * 100.0

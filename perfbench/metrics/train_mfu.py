"""The whole training step's share of the card's float32 peak, in percent,
over an uninstrumented stretch of chunks: the networks' FLOPs (the
rollout's policy forwards, the ring value fill, the update's forwards and
backwards) and the solves' FLOPs from each lane's own iterations
(perfbench/counting.py), over the stretch's seconds."""

import json
import os

PEAKS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "peaks.json")


def read(rec):
    s = rec.get("stretch")
    if rec.get("kind") != "train" or not s or s["seconds"] <= 0:
        return None
    with open(PEAKS) as fh:
        peak = json.load(fh)["float32_flops"]
    return s["flops"] / s["seconds"] / peak * 100.0

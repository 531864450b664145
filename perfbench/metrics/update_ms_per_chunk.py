"""Milliseconds of one chunk's update phase (every value and policy epoch),
from the synchronize-closed span around ``PGTrainer._update_phase``."""


def read(rec):
    span = rec.get("spans", {}).get("update")
    if rec.get("kind") != "train" or not span or not span["calls"]:
        return None
    return span["seconds"] / span["calls"] * 1e3

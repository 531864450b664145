"""Milliseconds of one batched power-flow solve of an evaluation step
(pack, kernel, unpack, bus and branch results), from the
synchronize-closed span around the env's solver."""


def read(rec):
    span = rec.get("spans", {}).get("pf_solve")
    if rec.get("kind") != "eval" or not span or not span["calls"]:
        return None
    return span["seconds"] / span["calls"] * 1e3

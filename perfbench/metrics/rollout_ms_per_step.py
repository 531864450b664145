"""Milliseconds of one vectorized rollout step (policy, env step with its
solves, the transition), from the synchronize-closed span around
``PGTrainer._rollout_step``."""


def read(rec):
    span = rec.get("spans", {}).get("rollout")
    if rec.get("kind") != "train" or not span or not span["calls"]:
        return None
    return span["seconds"] / span["calls"] * 1e3

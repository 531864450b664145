"""CUDA kernel launches of a profiled training episode per vectorized env
step (every lane stepped once), from the profiler's kernel events."""


def read(rec):
    p = rec.get("profile")
    if rec.get("kind") != "train" or not p or not p.get("env_steps"):
        return None
    return p["launches"] / p["env_steps"]

"""The share of a profiled evaluation day in which no kernel, memcpy or
memset ran on the device: 1 - busy / wall, from the profiler's trace."""


def read(rec):
    p = rec.get("profile")
    if rec.get("kind") != "eval" or not p or p["window_s"] <= 0:
        return None
    return 1.0 - p["busy_s"] / p["window_s"]

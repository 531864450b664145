"""The small NR kernel's share of its roofline, in percent: the least time
the solves of the profiled stretch need at the card's float32 and HBM
peaks (perfbench/counting.py, from each lane's own iterations), over the
kernel's device time in the profile."""

KERNEL = "nr_small"


def read(rec):
    r = rec.get("roofline", {}).get(KERNEL)
    if not r or r["kernel_s"] <= 0:
        return None
    return r["bound_s"] / r["kernel_s"] * 100.0

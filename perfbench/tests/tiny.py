"""Cells of BENCHMARK.json cut to a size the CPU tests hold: 8 lanes,
16-step episodes, 8-step update windows on a ring of 8 steps (as the
cells' rings hold one window), a few checked pairs; one day for an
evaluation cell."""
import copy

from perfbench import spec


def cell(name):
    c = copy.deepcopy(spec.cell(name))
    if c["traffic"]["kind"] == "train":
        over = dict(c["traffic"]["overrides"], batch_size=8, replay_buffer_size=64)
        if "update_lanes" in over:
            over["update_lanes"] = 4
        c["traffic"] = dict(c["traffic"], lanes=8, max_steps=16, overrides=over)
        c["check"]["check"] = dict(c["check"]["check"], lanes=4, pairs=64)
    else:
        c["check"]["check"] = dict(c["check"]["check"], days=1)
    return c

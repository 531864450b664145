"""The work the inputs need, counted from shapes and per-lane iteration
counts, whatever implements it: the yardstick of the roofline and MFU
metrics.

Power flow.  The solver iterates Newton directions refined by Richardson
steps on a frozen preconditioner W (the inverse flat-start Jacobian, dense
over the 2(n-1) non-slack unknowns): each lane evaluates the mismatch once
(one product with the real block admittance operator [[G, -B], [B, G]]),
and each of its own ``n_iter`` iterations takes ``inner + 1`` products with
W and ``inner + 1`` products with Y (``inner`` refinements and the next
mismatch).  A product costs two FLOPs a nonzero.  Bytes: each lane's
injections and start voltages read once and its voltages, error and count
written once, and the operators (Y's nonzeros with a 4-byte index each,
W's live block, two per-bus vectors) read once a call, all in float32.

Networks.  Two FLOPs a multiply-add of the dense layers; the forward of a
backward pass counts three times the forward.
"""
from __future__ import annotations

import numpy as np

F32 = 4


def y_nonzeros(g, b):
    """Nonzeros of the real block operator [[G, -B], [B, G]]."""
    return 2 * int(np.count_nonzero(g)) + 2 * int(np.count_nonzero(b))


def nr_flops(n_iter, n_bus, nnz_y, inner):
    """FLOPs of the solves of lanes that ran ``n_iter`` iterations each."""
    it = np.asarray(n_iter, np.float64)
    live = 2 * (n_bus - 1)
    y_products = (1.0 + it * (inner + 1)).sum()
    w_products = (it * (inner + 1)).sum()
    return 2.0 * nnz_y * y_products + 2.0 * live * live * w_products


def nr_bytes(lanes, n_bus, nnz_y):
    """Bytes one call of ``lanes`` lanes reads and writes at least."""
    live = 2 * (n_bus - 1)
    per_lane = (2 * n_bus * 2 + 2 * n_bus + 2) * F32
    operators = (2 * nnz_y + live * live + 4 * n_bus) * F32
    return lanes * per_lane + operators


def roofline_seconds(flops, nbytes, peaks):
    """(least seconds, what bounds it) at the card's published peaks."""
    t_f, t_b = flops / peaks["float32_flops"], nbytes / peaks["hbm_bytes_per_s"]
    return (t_f, "flops") if t_f >= t_b else (t_b, "bytes")


def policy_flops(obs_dim, n_agents, hid, act_dim):
    """One agent row of the GRU policy: fc1, the GRU's two products, the head."""
    return 2.0 * ((obs_dim + n_agents) * hid + 2 * hid * 3 * hid + hid * act_dim)


def critic_flops(obs_dim, n_agents, hid):
    """One sample of the central critic: fc1 over the joint obs once, then
    fc2 and the head for each agent."""
    return 2.0 * (obs_dim * n_agents * hid + n_agents * (hid * hid + hid))


def chunk_net_flops(dims, lanes, steps, ring, batch_rows, epochs):
    """Network FLOPs of one training chunk: the rollout's policy forwards,
    the ring value fill (``ring`` steps of every lane and the live obs), and
    ``epochs`` = {"value": E_v, "policy": E_p} update steps on
    ``batch_rows`` samples each, forward and backward."""
    pol = policy_flops(dims["obs"], dims["agents"], dims["hid"], dims["act"])
    cri = critic_flops(dims["obs"], dims["agents"], dims["hid"])
    rollout = steps * lanes * dims["agents"] * pol
    fill = (ring + 1) * lanes * cri
    update = 3.0 * batch_rows * (epochs["value"] * cri
                                 + epochs["policy"] * dims["agents"] * pol)
    return rollout + fill + update

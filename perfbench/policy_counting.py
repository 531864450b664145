"""The work of the shared GRU policy's differentiated steps, counted from
rows and the obs width whatever implements it: the yardstick of
``policy_gru_roofline``.

A row is one (sample, agent) of a policy loss: its forward and the
backward to the policy's parameters, hidden width 64, one action.  The
agent-id one-hot is one column of fc1 a row, an add and no product, so the
agent count does not enter the count.

* Forward, multiply-adds: fc1's obs columns (o x 64), the GRU's input and
  hidden products (2 x 64 x 192), the head (64).
* Backward: the stem's cotangent through W_ih (3 x 64 x 64), the
  gradients of W_ih and W_hh (2 x 192 x 64) and of fc1's obs columns
  (o x 64).
* Bytes, float32: obs and the hidden state read by both passes, and what
  the backward needs of the forward (LayerNorm's normalised input, the
  gates r, z, n and the hidden path's n, 5 x 64, and 1/std) written once
  and read once.

At case322's update batch (4,096 lanes x 32 steps x 38 agents, o = 62)
a step is 691.7 GFLOP.
"""
from __future__ import annotations

HID = 64
F32 = 4


def row_fmas(obs_dim):
    """(forward, backward) multiply-adds of one row."""
    fwd = obs_dim * HID + 2 * HID * 3 * HID + HID
    bwd = 3 * HID * HID + 2 * 3 * HID * HID + obs_dim * HID
    return fwd, bwd


def step_flops(rows, obs_dim):
    """FLOPs of the forward and backward over ``rows`` rows (an FMA is two)."""
    return 2.0 * rows * sum(row_fmas(obs_dim))


def step_bytes(rows, obs_dim):
    """Bytes the forward and backward over ``rows`` rows move at least."""
    return float(rows) * F32 * (2 * (obs_dim + HID) + 2 * (5 * HID + 1))

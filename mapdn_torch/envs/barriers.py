"""Voltage barrier (reward-shaping) functions, elementwise over tensors.

PyTorch port of mapdn_tpu/envs/barriers.py (reference
voltage_barrier/{l1,l2,courant_beltrami,bowl,bump}.py): each barrier is an
elementwise function of a voltage tensor of any shape, selected once by name.
"""
from __future__ import annotations

import math

import torch


def l1(v, v_ref=1.0):
    """|v - v_ref|  (reference l1.py:5-7)."""
    return torch.abs(v - v_ref)


def l2(v, v_ref=1.0):
    """2 (v - v_ref)^2  (reference l2.py:5-7)."""
    return 2.0 * torch.square(v - v_ref)


def courant_beltrami(v, v_lower=0.95, v_upper=1.05):
    """Hinge-squared outside the deadband (reference courant_beltrami.py:5-7)."""
    return torch.square(torch.clamp(v - v_upper, min=0.0)) + torch.square(
        torch.clamp(v_lower - v, min=0.0))


def bowl(v, v_ref=1.0, scale=0.1):
    """Piecewise linear/Gaussian bowl (reference bowl.py:5-12).

    Linear 2|v-v_ref|-0.095 outside the 0.05 band, inverted Gaussian inside.
    """
    dev = torch.abs(v - v_ref)
    normal = 1.0 / math.sqrt(2 * math.pi * scale**2) * torch.exp(
        -0.5 * torch.square(v - v_ref) / scale**2)
    outside = 2.0 * dev - 0.095
    inside = -0.01 * normal + 0.04
    return torch.where(dev > 0.05, outside, inside)


def bump(v):
    """Smooth bump barrier (reference bump.py:5-12).

    exp(-1/(1-v^4)) for |v|<1, exp(-1/(1-(v-2)^4)) for 1<v<3, else 0.
    (For the voltage-control use case v is ~1 pu so the second branch is the
    live one.)  Guarded denominators keep the masked branches finite.
    """
    d1 = 1.0 - v**4
    d2 = 1.0 - (v - 2.0) ** 4
    b1 = torch.exp(-1.0 / torch.where(d1 > 0, d1, torch.ones_like(d1)))
    b2 = torch.exp(-1.0 / torch.where(d2 > 0, d2, torch.ones_like(d2)))
    in1 = torch.abs(v) < 1.0
    in2 = (v > 1.0) & (v < 3.0)
    return torch.where(in1, b1, torch.where(in2 & (d2 > 0), b2,
                                            torch.zeros_like(b2)))


BARRIERS = {
    "l1": l1,
    "l2": l2,
    "courant_beltrami": courant_beltrami,
    "bowl": bowl,
    "bump": bump,
}


def get_barrier(name):
    if name not in BARRIERS:
        raise KeyError(f"unknown barrier '{name}'; available: {sorted(BARRIERS)}")
    return BARRIERS[name]

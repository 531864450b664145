"""Weights of a run, drawn from its seed on the device.

One ``torch.Generator`` on the run's device, seeded with ``--seed``, draws
each network's parameters in one call; each leaf is then scaled by its
kind: ``dense`` kernels N(0, 0.1) (the init_std of the configuration),
``fan_in`` kernels N(0, 1/fan_in), ``bias`` N(0, 0.05), ``scale``
1 + N(0, 0.05).  Random biases and scales make every leaf take part in the
comparison with the reference.  Both the program and the reference receive
the same tensors.
"""
from __future__ import annotations

import math

import torch

SCALE = {"dense": lambda shape: 0.1, "fan_in": lambda shape: 1.0 / math.sqrt(shape[-1]),
         "bias": lambda shape: 0.05, "scale": lambda shape: 0.05}


def draw(leaves, generator, dtype=torch.float32):
    """{name: tensor} for ``leaves`` [(name, shape, kind)] from one draw."""
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    flat = torch.randn(sum(sizes), generator=generator, dtype=dtype,
                       device=generator.device)
    out, at = {}, 0
    for (name, shape, kind), size in zip(leaves, sizes):
        x = flat[at:at + size].reshape(shape) * SCALE[kind](shape)
        out[name] = x + 1.0 if kind == "scale" else x
        at += size
    return out


def make(specs, seed, device):
    """{network: {name: tensor}} for {network: leaves}, in order."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return {net: draw(leaves, gen) for net, leaves in specs.items()}

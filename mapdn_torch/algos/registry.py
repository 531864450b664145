"""Algorithm registry (PyTorch port of mapdn_tpu/algos/registry.py;
reference models/model_registry.py:14-36).

``maac`` and ``facmaddpg`` are not ported yet: asking for either raises
``NotImplementedError``.
"""
from __future__ import annotations

import torch

from mapdn_torch.algos.coma import COMA
from mapdn_torch.algos.iac import IAC
from mapdn_torch.algos.iddpg import IDDPG
from mapdn_torch.algos.ippo import IPPO
from mapdn_torch.algos.maddpg import MADDPG
from mapdn_torch.algos.mappo import MAPPO
from mapdn_torch.algos.matd3 import MATD3
from mapdn_torch.algos.random_agent import RandomAgent
from mapdn_torch.algos.sqddpg import SQDDPG

MODEL_REGISTRY = dict(
    maddpg=MADDPG,
    sqddpg=SQDDPG,
    iac=IAC,
    iddpg=IDDPG,
    coma=COMA,
    matd3=MATD3,
    ippo=IPPO,
    mappo=MAPPO,
    random=RandomAgent,
)

_NOT_PORTED = {
    "maac": "it needs AttentionCritic and the Gaussian agents",
    "facmaddpg": "it needs QMixer, a third optimizer and the mixer epochs",
}


def make_model(alg: str, cfg, device=None, param_dtype=torch.float32):
    if alg in _NOT_PORTED:
        raise NotImplementedError(
            f"--alg {alg} is not ported to mapdn_torch yet: {_NOT_PORTED[alg]} "
            "(ROADMAP A7)")
    if alg not in MODEL_REGISTRY:
        raise KeyError(f"unknown algorithm '{alg}'; available: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[alg](cfg, device=device, param_dtype=param_dtype)

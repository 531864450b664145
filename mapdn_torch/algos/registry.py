"""Algorithm registry (PyTorch port of mapdn_tpu/algos/registry.py;
reference models/model_registry.py:14-36)."""
from __future__ import annotations

import torch

from mapdn_torch.algos.coma import COMA
from mapdn_torch.algos.facmaddpg import FACMADDPG
from mapdn_torch.algos.iac import IAC
from mapdn_torch.algos.iddpg import IDDPG
from mapdn_torch.algos.ippo import IPPO
from mapdn_torch.algos.maac import MAAC
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
    maac=MAAC,
    matd3=MATD3,
    ippo=IPPO,
    mappo=MAPPO,
    facmaddpg=FACMADDPG,
    random=RandomAgent,
)


def make_model(alg: str, cfg, device=None, param_dtype=torch.float32):
    if alg not in MODEL_REGISTRY:
        raise KeyError(f"unknown algorithm '{alg}'; available: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[alg](cfg, device=device, param_dtype=param_dtype)

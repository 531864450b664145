"""PV / load time-series tables (PyTorch port of mapdn_tpu/envs/timeseries.py).

The tables are device tensors gathered by a time index inside each env step.
:func:`synthetic_dataset` draws from ``np.random.RandomState(seed)`` exactly
as the JAX package does, so the arrays are bitwise the same in float64.
Reading the real MAPDN CSV data is not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mapdn_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TimeSeries:
    pv: torch.Tensor          # (T, n_sgen) PV active power [MW]
    load_p: torch.Tensor      # (T, n_load) demand active power [MW]
    load_q: torch.Tensor      # (T, n_load) demand reactive power [Mvar]
    pv_std: torch.Tensor      # (n_sgen,) per-column std/100 (noise scale)
    load_p_std: torch.Tensor  # (n_load,)
    load_q_std: torch.Tensor  # (n_load,)
    p_max: torch.Tensor       # (n_sgen,) historical max PV output [MW]
    s_max: torch.Tensor       # (n_sgen,) inverter capacity = 1.2 * p_max
    time_delta: int = 3       # minutes per step
    n_steps: int = 0


def _finalize(pv, load_p, load_q, time_delta, dtype, device=None):
    """Noise std = column std / 100 and s_max = 1.2 * max(pv), as in the
    reference (voltage_control_env.py:70-72, :515-521)."""
    device = resolve_device(device)
    pv = np.asarray(pv, np.float64)
    load_p = np.asarray(load_p, np.float64)
    load_q = np.asarray(load_q, np.float64)
    a = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=device).to(dtype)
    p_max = pv.max(axis=0)
    return TimeSeries(
        pv=a(pv), load_p=a(load_p), load_q=a(load_q),
        pv_std=a(pv.std(axis=0) / 100.0),
        load_p_std=a(load_p.std(axis=0) / 100.0),
        load_q_std=a(load_q.std(axis=0) / 100.0),
        p_max=a(p_max), s_max=a(1.2 * p_max),
        time_delta=int(time_delta), n_steps=pv.shape[0])


def synthetic_dataset(base_load_p, base_load_q, pv_capacity, *, days=40,
                      time_delta=3, seed=0, dtype=torch.float32, device=None):
    """Deterministic synthetic dataset with MAPDN-like statistics: a
    clear-sky PV bell x AR(1) daily weather x cloud noise, and a double-peak
    demand with weekly modulation and noise."""
    rng = np.random.RandomState(seed)
    steps_per_day = 24 * 60 // time_delta
    t = np.arange(days * steps_per_day)
    hour = (t % steps_per_day) * time_delta / 60.0
    day = t // steps_per_day

    solar = np.clip(np.sin(np.pi * (hour - 6.0) / 12.0), 0.0, None) ** 1.3
    weather = np.empty(days)
    w = 0.7
    for d in range(days):
        w = np.clip(0.6 * w + 0.4 * rng.uniform(0.15, 1.0), 0.05, 1.0)
        weather[d] = w
    cloud = np.clip(1.0 - 0.25 * np.abs(rng.randn(len(t), len(pv_capacity))), 0.2, 1.0)
    pv = (solar[:, None] * weather[day][:, None] * cloud) * np.asarray(pv_capacity)[None, :]

    base_shape = (
        0.55
        + 0.25 * np.exp(-0.5 * ((hour - 9.0) / 2.5) ** 2)
        + 0.45 * np.exp(-0.5 * ((hour - 19.5) / 2.0) ** 2)
    )
    weekly = 1.0 - 0.12 * ((day % 7) >= 5).astype(np.float64)
    shape = base_shape * weekly
    jitter_p = 1.0 + 0.05 * rng.randn(len(t), len(base_load_p))
    jitter_q = 1.0 + 0.05 * rng.randn(len(t), len(base_load_q))
    load_p = np.clip(shape[:, None] * jitter_p, 0.05, None) * np.asarray(base_load_p)[None, :]
    load_q = np.clip(shape[:, None] * jitter_q, 0.05, None) * np.asarray(base_load_q)[None, :]
    return _finalize(pv, load_p, load_q, time_delta, dtype, device)


def dataset_for_case(case_name, load_p, load_q, pv_max, *, data_path=None,
                     days=40, seed=0, dtype=torch.float32, device=None,
                     pv_scale=1.0, demand_scale=1.0):
    """Synthetic data for a case; real CSV data is not ported yet."""
    if data_path:
        raise NotImplementedError(
            "CSV datasets are not ported to mapdn_torch yet; use the "
            "synthetic dataset (data_path=None)")
    return synthetic_dataset(load_p, load_q, pv_max, days=days, seed=seed,
                             dtype=dtype, device=device)

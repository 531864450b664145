"""Three-layer configuration system (port of mapdn_tpu/utils/config.py).

Reads the repository's shared ``configs/`` YAMLs as data: the env YAML, the
defaults and the per-algorithm YAML merged with algorithm-args precedence
(reference train.py:24-67), then CLI-style overrides, into a frozen typed
dataclass whose defaults equal the reference's default.yaml values.
Unknown keys fail loudly.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Any, Optional

import yaml

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "configs")


@dataclass(frozen=True)
class AlgoConfig:
    """Algorithm/trainer hyperparameters (defaults = reference args/default.yaml)."""
    # action sampling / policy family
    gumbel_softmax: bool = False
    epsilon_softmax: bool = False
    softmax_eps: Optional[float] = None
    continuous: bool = True
    gaussian_policy: bool = False
    LOG_STD_MIN: float = 0.0
    LOG_STD_MAX: float = 0.5
    fixed_policy_std: float = 1.0
    action_enforcebound: bool = True
    clip_c: float = 1.0
    action_scale: float = 0.8
    action_bias: float = 0.0

    # network
    agent_type: str = "rnn"            # rnn / mlp
    agent_id: bool = True
    shared_params: bool = True
    layernorm: bool = True
    hid_size: int = 64
    hid_activation: str = "relu"
    init_type: str = "normal"
    init_std: float = 0.1

    # learning
    episodic: bool = False
    policy_lrate: float = 1e-4
    value_lrate: float = 1e-4
    mixer_lrate: Optional[float] = None
    target: bool = True
    target_lr: float = 0.1
    entr: float = 1e-3
    gamma: float = 0.99
    normalize_advantages: bool = False
    reward_normalisation: bool = True
    grad_clip_eps: float = 1.0
    double_q: bool = True
    mixer: bool = False

    # cadence
    max_steps: int = 240
    batch_size: int = 32
    replay: bool = True
    replay_buffer_size: int = 5000
    replay_warmup: int = 0
    behaviour_update_freq: int = 60
    target_update_freq: int = 120
    policy_update_epochs: int = 1
    value_update_epochs: int = 10
    mixer_update_epochs: Optional[int] = None
    train_episodes_num: int = 400
    save_model_freq: int = 40
    eval_freq: int = 20
    num_eval_episodes: int = 10

    # algorithm-specific extras
    sample_size: Optional[int] = None        # coma / sqddpg
    lambda_: Optional[float] = None          # ppo GAE
    eps_clip: Optional[float] = None         # ppo
    value_loss_coef: Optional[float] = None  # ppo
    # "bootstrap": reference-parity one-step target off the live critic
    # (reference ppo.py:56 — diverges at large batch, the critic chases
    # itself); "gae": standard PPO target advantages + old values, fixed
    # within the update
    ppo_value_target: str = "bootstrap"
    attend_heads: Optional[int] = None       # maac
    norm_in: Optional[bool] = None           # maac
    soft: Optional[bool] = None              # maac
    reward_scale: Optional[float] = None     # maac
    hypernet_layers: Optional[int] = None    # facmaddpg
    hypernet_embed: Optional[int] = None
    mixing_embed_dim: Optional[int] = None
    hyper_initialization_nonzeros: Any = False
    gated: Optional[bool] = None
    skip_connections: Optional[bool] = None

    # environment-derived (filled by the CLI like reference train.py:66-68)
    agent_num: int = 0
    obs_size: int = 0
    action_dim: int = 1

    # vectorized-rollout extensions (no reference equivalent: the reference
    # runs one CPU env)
    n_envs: int = 1
    seed: int = 0
    # lanes (envs) per update minibatch: each update epoch samples a random
    # subset of this many env lanes from the replay window, so update-side
    # compute stays bounded as n_envs scales (the reference's batch_size
    # counts transitions of its single env).  None = all lanes.
    update_lanes: Optional[int] = None
    # XLA scan-unroll factors of the JAX package: accepted so the shared
    # YAMLs and overrides stay valid; the port's loops are plain Python
    gae_unroll: int = 8
    update_epoch_unroll: int = 10
    rollout_unroll: int = 4
    # store the replay ring's bulk tensors (state/next_state/hid) in
    # bfloat16; compute stays float32 (batches are upcast at sample time)
    replay_bf16: bool = False

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _load_yaml(path):
    with open(path) as f:
        return yaml.safe_load(f) or {}


def load_config(alg: str, *, env: str = "var_voltage_control",
                scenario: str = "case33", mode: str = "distributed",
                voltage_barrier_type: str = "l1", overrides=None,
                config_dir: str = CONFIG_DIR):
    """Reference-equivalent 3-layer merge -> (AlgoConfig, env_config_dict).

    Matches reference train.py:24-67: env yaml + per-scenario action range,
    default yaml, alg yaml (alg wins), CLI overrides last.
    """
    env_cfg = _load_yaml(os.path.join(config_dir, "env", env + ".yaml"))["env_args"]
    # per-scenario action ranges hardcoded in the reference CLIs (train.py:33-42)
    scen = scenario.replace("_3min_final", "")
    action_scale = {"case33": 0.8, "case141": 0.6, "case322": 0.8}.get(scen, 0.8)
    env_cfg["action_scale"] = action_scale
    env_cfg["action_bias"] = 0.0
    env_cfg["mode"] = mode
    env_cfg["voltage_barrier_type"] = voltage_barrier_type
    env_cfg["scenario"] = scenario

    default_cfg = _load_yaml(os.path.join(config_dir, "default.yaml"))
    alg_cfg = _load_yaml(os.path.join(config_dir, "alg", alg + ".yaml"))
    alg_args = alg_cfg.get("alg_args", {}) or {}
    merged = {**default_cfg, **alg_args}
    merged["action_scale"] = env_cfg["action_scale"]
    merged["action_bias"] = env_cfg["action_bias"]
    if overrides:
        merged.update(overrides)

    merged.pop("cuda", None)  # the device is an explicit argument instead
    valid = {f.name for f in dataclasses.fields(AlgoConfig)}
    unknown = set(merged) - valid
    if unknown:
        raise KeyError(f"unknown config keys: {sorted(unknown)}")
    if merged.get("replay_buffer_size") is not None:
        merged["replay_buffer_size"] = int(float(merged["replay_buffer_size"]))
    return AlgoConfig(**merged), env_cfg

"""mapdn_torch — the PyTorch/CUDA port of mapdn_tpu (multi-agent RL for
active voltage control), for one NVIDIA Hopper GPU.

The module tree mirrors mapdn_tpu's so each file has an obvious counterpart:

    config      mapdn_torch.utils.config   (3-layer YAML merge -> dataclass)
    runtime     mapdn_torch.learn          (trainer, replay, losses, sampling)
    algorithms  mapdn_torch.algos          (MAPPO)
    networks    mapdn_torch.nets           (GRU/MLP agents, critics)
    environment mapdn_torch.envs           (natively batched voltage control)
    physics     mapdn_torch.pf + .grid     (batched NR power flow, Y-bus)
    kernels     mapdn_torch/csrc           (hand-written CUDA, built at first use)

Nothing here imports JAX or mapdn_tpu.  Entry points run on the GPU unless
the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

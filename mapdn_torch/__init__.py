"""mapdn_torch — the PyTorch/CUDA port of mapdn_tpu (multi-agent RL for
active voltage control), for one NVIDIA Hopper GPU.

The module tree mirrors mapdn_tpu's so each file has an obvious counterpart:

    CLIs        mapdn_torch.train, .test   (python -m mapdn_torch.train / .test,
                                            as train.py / test.py)
    examples    mapdn_torch.code_examples  (python -m mapdn_torch.code_examples, as
                                            code_examples.py)
    scripts     mapdn_torch.scripts        (the zoo and its learning report, as
                                            scripts/train_zoo.py, learning_report.py)
    config      mapdn_torch.utils.config   (3-layer YAML merge -> dataclass)
    utils       mapdn_torch.utils          (metrics logging, checkpoints, kernel build,
                                            profiling hooks, lane sharding)
    runtime     mapdn_torch.learn          (trainer with eval, transition and episodic
                                            modes; tester, replay, losses, sampling)
    multi-GPU   mapdn_torch.parallel       (the trainer over a torch.distributed group)
    algorithms  mapdn_torch.algos          (the 10 and random; registry)
    networks    mapdn_torch.nets           (GRU/MLP agents, critics, mixer; shared or
                                            per-agent parameters)
    environment mapdn_torch.envs           (natively batched voltage control; the
                                            PyMARL wrapper VoltageControlWrapper)
    physics     mapdn_torch.pf + .grid     (batched NR power flow, Y-bus)
    native      mapdn_torch.native         (the C++ float64 NR oracle, built by g++)
    kernels     mapdn_torch/csrc           (hand-written CUDA, built at first use)

Nothing here imports JAX or mapdn_tpu.  Entry points run on the GPU unless
the caller passes ``device="cpu"`` (``--platform cpu`` on the CLI).
"""

__version__ = "0.1.0"

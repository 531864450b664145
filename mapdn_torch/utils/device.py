"""Device selection: entry points run on the GPU unless asked for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; a missing GPU is an error, never a silent
    fall-back to the CPU (pass ``device="cpu"`` explicitly for that)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)

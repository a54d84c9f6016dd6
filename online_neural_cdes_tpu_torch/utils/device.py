"""Where the port's entry points run.

The port runs on a CUDA card.  An entry point runs on the CPU only when the
caller asks for it (``device="cpu"``); with no device named and no card
visible it raises, so a run never drifts to the CPU unnoticed.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run on the "
                "CPU explicitly"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device

"""Explicit device selection: no silent fallback to the CPU.

Every entry point of the port takes `device=`. "cuda" (the default of the
runner and the CLI) requires a card and raises `RuntimeError` without one;
the CPU runs only when a caller asks for it (the tests do, with the plain
PyTorch versions of the kernels).
"""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev

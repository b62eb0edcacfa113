"""Lossless carriage of state between numpy (and so JAX) and the port.

The system has no weights: its state is the circuit-static device arrays
and the (L, n) Montgomery limb planes that flow between prover stages. JAX
holds them as uint32; the port holds the same bit patterns as int32
(`torch.uint32` lacks add, shift and compare on the CPU). These casts are
bit-exact both ways, so a test can feed one stage's inputs to the JAX
function and to its port and compare the outputs.
"""

from __future__ import annotations

import numpy as np
import torch


def planes_from_numpy(arr, device) -> torch.Tensor:
    """uint32 (or int32) array -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(arr)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype != np.int32:
        raise TypeError(f"expected a uint32/int32 array, got {a.dtype}")
    return torch.from_numpy(a.copy()).to(device)


def planes_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 array with the same bits."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected an int32 tensor, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def tree_from_numpy(obj, device):
    """Dicts, lists and tuples of arrays -> the same structure of tensors:
    uint32/int32 arrays become int32 planes, other arrays keep their dtype."""
    if isinstance(obj, dict):
        return {k: tree_from_numpy(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(tree_from_numpy(v, device) for v in obj)
    if isinstance(obj, np.ndarray):
        if obj.dtype in (np.uint32, np.int32):
            return planes_from_numpy(obj, device)
        return torch.from_numpy(np.ascontiguousarray(obj).copy()).to(device)
    return obj


def tree_to_numpy(obj):
    """Inverse of `tree_from_numpy`: int32 tensors come back as uint32."""
    if isinstance(obj, dict):
        return {k: tree_to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(tree_to_numpy(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        if obj.dtype == torch.int32:
            return planes_to_numpy(obj)
        return obj.detach().cpu().numpy()
    return obj

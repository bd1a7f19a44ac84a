"""Carry parameter trees of the JAX package into the port.

``from_jax_params`` takes the tree a JAX ``lm_init`` returns, with its
leaves already turned into numpy arrays (``np.asarray``), and returns the
same nested dicts of torch tensors: the stacked leading ``L`` axis, the
``(d, H, D)`` / ``(H, D, d)`` attention layouts and the dtype (bfloat16
included) are kept as they are.  This module does not import JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.api import resolve_device


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' type: move the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def from_jax_params(tree, device="cuda"):
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(conv(v) for v in t)
        return _tensor(t).to(dev)

    return conv(tree)

"""A loop over stacked layer params (the JAX package's ``lax.scan``).

Parameters of all layers sit in one tree whose leaves carry a leading
``L`` axis; ``scan_layers`` hands layer ``i``'s slice of every leaf (a view,
no copy) to ``body`` in turn.
"""
from __future__ import annotations

import torch


def _slice(tree, i):
    if isinstance(tree, dict):
        return {k: _slice(v, i) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_slice(v, i) for v in tree)
    return tree[i]


def scan_layers(body, carry, xs):
    """Like ``jax.lax.scan(body, carry, xs)``: ``body(carry, x_i) ->
    (carry, y_i)``; returns ``(carry, ys)`` with each tensor of the tuples
    ``y_i`` stacked on a new leading axis, or ``None`` when the body
    returns ``None``."""
    leaf = xs
    while not isinstance(leaf, torch.Tensor):
        leaf = next(iter(leaf.values() if isinstance(leaf, dict) else leaf))
    ys = []
    for i in range(leaf.shape[0]):
        carry, y = body(carry, _slice(xs, i))
        ys.append(y)
    if ys[0] is None:
        return carry, None
    return carry, tuple(torch.stack(col) for col in zip(*ys))

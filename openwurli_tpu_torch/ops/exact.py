"""Selects and index-order sums that the f64 engine kernels reproduce bit
for bit (`csrc/engine.cu`).

The reference's `jnp.maximum`, `jnp.minimum` and `jnp.clip` propagate NaN;
CUDA's `fmax`/`fmin` drop it. The plain versions therefore take every
max/min as a select, `x if (x != x or x > y) else y`, which the kernels
write the same way. Matrix-vector products sum their columns in index
order, never through `torch.matmul` or `torch.sum`, whose order depends on
the device and the width.
"""

from __future__ import annotations

import torch


def maximum(a, b):
    """jnp.maximum: NaN when either is NaN (b a tensor or a float)."""
    return torch.where(torch.isnan(a) | (a > b), a, b)


def minimum(a, b):
    """jnp.minimum: NaN when either is NaN (b a tensor or a float)."""
    return torch.where(torch.isnan(a) | (a < b), a, b)


def clip(x, lo, hi):
    """jnp.clip(x, lo, hi) = minimum(maximum(x, lo), hi)."""
    return minimum(maximum(x, lo), hi)


def div(a, b: float):
    """a / b for a Python-number divisor, as a true division. (On a CUDA
    tensor, `a / 22.0` multiplies by the rounded reciprocal of 22, as the
    kernels, like the reference, do not.)"""
    return a / torch.full_like(a, b)


def max_abs(x):
    """max |x| over the last axis, NaN if any entry is NaN (order-free)."""
    return torch.amax(torch.abs(x), dim=-1)


def matvec(a, x):
    """a (..., r, c) @ x (..., c) → (..., r), the products summed over c
    in index order starting from the first product (batch axes
    broadcast)."""
    terms = (a * x.unsqueeze(-2)).unbind(-1)
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc

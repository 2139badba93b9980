"""Fused multiply-add arithmetic that reproduces the JAX package's rounding.

The JAX package's jitted programs are compiled with floating-point
contraction on: a product feeding an add is computed as one fused
multiply-add (one rounding), and a 3-term reduction as the chain
fma(a2, b2, fma(a1, b1, fma(a0, b0, 0))). Where the port's integer
decisions hinge on exact float ties (the 12 orderings of a 4-point base
have mathematically equal segment distances, so the ordering chosen
depends on the last ULP), the port computes the same expressions the same
way. ``fma`` evaluates in float64 (the product of two float32 values is
exact there) and rounds once to float32; on any device.

The same ties make the port's results depend on rounding that differs
between torch's CPU and CUDA kernels (a quotient by a constant, a square
root). ``div_const`` and ``sqrt_rn`` give the correctly rounded float32
result on both, so the card and the CPU pick the same bases, sets,
transforms and ladder leaders.
"""

from __future__ import annotations

import torch


def fma(x, y, z):
    """float32(x * y + z) with a single rounding (x, y, z float32)."""
    return (x.double() * y.double() + z.double()).float()


def dot3(a, b):
    """Sum over the last axis (size 3) of a * b as the contracted chain
    fma(a2, b2, fma(a1, b1, fma(a0, b0, 0)))."""
    acc = (a[..., 0].double() * b[..., 0].double() + 0.0).float()
    acc = fma(a[..., 1], b[..., 1], acc)
    return fma(a[..., 2], b[..., 2], acc)


def f32(c: float) -> float:
    """The float32 value nearest to `c`, as a Python float."""
    return float(torch.tensor(c, dtype=torch.float32))


def div_const(x, c: float):
    """float32(x / float32(c)), correctly rounded on every device. On CUDA
    torch divides by a Python scalar as a product with its rounded
    reciprocal, which can differ from the CPU's quotient in the last bit;
    a float64 quotient rounded once to float32 is the correctly rounded
    float32 quotient (53 >= 2 * 24 + 2 bits) on both."""
    return (x.double() / f32(c)).float()


def mul_recip(x, c: float):
    """float32(x * float32(1 / float32(c))): a division by a constant as the
    JAX package's compiled programs evaluate it (XLA rewrites x / c into a
    product with the rounded reciprocal; measured on the back-projection in
    tests/test_torch_ingest.py). A product is correctly rounded on every
    device."""
    return x * f32(1.0 / f32(c))


def div(a, b):
    """float32 a / b of two tensors, correctly rounded on every device (the
    float64 quotient rounded once; 53 >= 2 * 24 + 2)."""
    return (a.double() / b.double()).float()


def sqrt_rn(x):
    """float32 square root, correctly rounded on every device: torch's
    vectorized CPU sqrt can miss by one ULP next to a rounding midpoint
    where CUDA's is exact; a float64 root rounded once to float32 is the
    correctly rounded float32 root (53 >= 2 * 24 + 2 bits) on both."""
    return torch.sqrt(x.double()).float()


def norm3(d):
    """float32 Euclidean norm over the last axis (size 3) as numpy's
    linalg.norm rounds it: (x*x + y*y) + z*z, each step a float32
    operation, then a correctly rounded root."""
    s = d * d
    return sqrt_rn((s[..., 0] + s[..., 1]) + s[..., 2])


def xla_sum0(x, window: int = 32):
    """float32 sum over axis 0 in the order of the JAX package's compiled
    reduction: XLA's CPU tree-reduction rewrite sums windows of 32 rows
    (the axis zero-padded to a multiple of 32, half of the padding in
    front), each window in order from 0, until fewer than 32 rows remain,
    and then those in order. Each step is a float32 add, correctly rounded
    on every device."""
    while x.shape[0] >= window:
        n = x.shape[0]
        pad = -n % window
        if pad:
            z = x.new_zeros((pad,) + x.shape[1:])
            x = torch.cat([z[:pad // 2], x, z[pad // 2:]])
        x = x.reshape((-1, window) + x.shape[1:])
        acc = x[:, 0]
        for j in range(1, window):
            acc = acc + x[:, j]
        x = acc
    acc = torch.zeros_like(x[0])
    for j in range(x.shape[0]):
        acc = acc + x[j]
    return acc

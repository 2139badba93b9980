"""Counter-based random numbers that equal ``jax.random``'s bit for bit.

The JAX package draws every random number through ``jax.random`` with the
threefry2x32 generator in partitionable mode (the jax 0.9.0 default). To
make the port's sampling and selection reproduce the JAX package's exactly,
this module implements the same generator in torch:

* a key is an int64 tensor of shape [..., 2] holding two uint32 words,
  kept on the CPU (keys are tiny; the bits they seed are made on the
  device of the caller's tensors);
* ``split``, ``fold_in`` and ``bits`` hash the counter pair
  (hi, lo) of the flat element index with threefry2x32, as jax does;
* ``uniform``, ``gumbel`` and ``categorical`` use jax's float32
  expressions on those bits.

torch has no uint32 shift or max on every backend, so the uint32
arithmetic runs in int64 with 32-bit masks.
"""

from __future__ import annotations

import math

import torch

from .ops import fmath

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_FLOAT32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) of counters (x1, x2) under key (k1, k2).

    k1/k2 are Python ints or int64 tensors, x1/x2 int64 tensors, all
    holding uint32 values; returns two int64 tensors of uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def PRNGKey(seed: int) -> torch.Tensor:
    """jax.random.PRNGKey for a 32-bit seed: words (0, seed mod 2^32)."""
    if not -(2 ** 31) <= int(seed) < 2 ** 32:
        raise ValueError(f"seed {seed} does not fit 32 bits")
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64)


def _words(key: torch.Tensor):
    if key.shape != (2,):
        raise ValueError(f"expected one key of shape [2], got {tuple(key.shape)}")
    return int(key[0]), int(key[1])


def _hash_iota(key: torch.Tensor, n: int, device):
    """threefry2x32 of the counters (0, i), i < n (n < 2^32)."""
    k1, k2 = _words(key)
    lo = torch.arange(n, dtype=torch.int64, device=device)
    return threefry2x32(k1, k2, torch.zeros_like(lo), lo)


def _hash_iota_batched(keys: torch.Tensor, n: int, device):
    """threefry2x32 of the counters (0, i), i < n, under every key of a
    [K, 2] batch -> two [K, n] tensors on `device` (no host read of the
    key words)."""
    if keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"expected keys of shape [K, 2], got {tuple(keys.shape)}")
    k = keys.to(device)
    lo = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    return threefry2x32(k[:, 0:1], k[:, 1:2], torch.zeros_like(lo), lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """[num, 2] keys: key i is threefry2x32(key, (0, i)). A [B, 2] batch of
    keys gives [B, num, 2], each row split on its own
    (jax.vmap(lambda k: jax.random.split(k, num)))."""
    if key.dim() == 2:
        b1, b2 = _hash_iota_batched(key, num, "cpu")
    else:
        b1, b2 = _hash_iota(key, num, "cpu")
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """jax.random.fold_in: threefry2x32(key, (0, data))."""
    k1, k2 = _words(key)
    b1, b2 = threefry2x32(
        k1, k2, torch.zeros(1, dtype=torch.int64),
        torch.tensor([int(data) & _M32], dtype=torch.int64),
    )
    return torch.cat([b1, b2])


def bits(key: torch.Tensor, shape=(), device="cpu") -> torch.Tensor:
    """32 uniform random bits per element (int64 holding uint32)."""
    shape = tuple(shape)
    b1, b2 = _hash_iota(key, math.prod(shape), device)
    return (b1 ^ b2).reshape(shape)


def bits_batched(keys: torch.Tensor, device="cpu") -> torch.Tensor:
    """One 32-bit draw per key of a [B, 2] batch — bits(keys[i], ()) for
    every i, computed as one vector op."""
    k = keys.to(device)
    zero = torch.zeros(k.shape[0], dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k[:, 0], k[:, 1], zero, zero)
    return b1 ^ b2


def _uniform_from_bits(b, minval, maxval, device):
    fb = (b >> 9) | 0x3F800000
    floats = fb.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def uniform(key, shape=(), minval=0.0, maxval=1.0, device="cpu"):
    """float32 uniform in [minval, maxval): 23 random mantissa bits under
    the exponent of 1.0, minus 1, scaled (jax's expression)."""
    return _uniform_from_bits(bits(key, shape, device), minval, maxval, device)


def gumbel(key, shape=(), device="cpu"):
    """float32 Gumbel noise, jax's "low" mode: -log(-log(u)), u uniform in
    [tiny, 1)."""
    u = uniform(key, shape, _FLOAT32_TINY, 1.0, device)
    return -fmath.log(-fmath.log(u))


def gumbel_keys(keys, shape, device="cpu"):
    """[len(keys), *shape] float32: gumbel(k, shape) for each key k, the
    logs taken over all of them at once."""
    u = torch.stack([uniform(k, shape, _FLOAT32_TINY, 1.0, device) for k in keys])
    return -fmath.log(-fmath.log(u))


def gumbel_rows(keys: torch.Tensor, n: int, device="cpu"):
    """[K, n] float32 Gumbel noise, row i equal to gumbel(keys[i], (1, n))
    (what jax.vmap of a [1, n] draw over a batch of keys gives)."""
    b1, b2 = _hash_iota_batched(keys, n, device)
    u = _uniform_from_bits(b1 ^ b2, _FLOAT32_TINY, 1.0, device)
    return -fmath.log(-fmath.log(u))


def categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row over the last axis: argmax(gumbel + logits), ties to
    the lower index (torch.argmax returns the first maximum)."""
    g = gumbel(key, logits.shape, logits.device)
    return torch.argmax(g + logits, dim=-1)

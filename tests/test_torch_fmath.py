"""ops/fmath.py against the JAX package's compiled transcendentals, on the CPU.

Inputs: 1,000,003 float32 values per function (an odd count, so XLA's
vector loop and its scalar tail both run), made from a seed with numpy over
the domains of the port's call sites, plus the edge cases: signed zeros,
+-1 and their neighbours, float32 tiny, denormals, infinities, NaN and
large arguments. Each function is held bit for bit against
`jax.jit(jnp.<f>)` (NaN against NaN). glibc's own atan2f, sinf and cosf,
called through ctypes, are a second oracle on normal-range inputs.
`fp.xla_sum0` is held bit for bit against a jitted `jnp.sum(..., axis=0)`.
`fmath.pow` is held against `jax.jit(jnp.power)` on the block decay's
domain (bases in (0, 1], integer exponents 0..256), on random finite
pairs and on every pair of edge values, and against glibc's powf."""

import ctypes
import ctypes.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from model_matching_tpu_torch.ops import fmath
from model_matching_tpu_torch.ops.fp import xla_sum0

N = 1_000_003
TINY = np.finfo(np.float32).tiny


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads while this module runs (several test workers share
    the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _edges():
    one = np.float32(1.0)
    base = np.array([
        0.0, 1.0, np.nextafter(one, np.float32(0)), np.nextafter(one, np.float32(2)),
        TINY, np.nextafter(TINY, np.float32(1)), 1e-45, 1e-40, 5e-39,
        np.nextafter(TINY, np.float32(0)), np.inf, np.nan, 0.5, 2.0, 2.4375,
        0.4375, 0.6875, 1.1875, 2.0 ** -29, 2.0 ** 25, 1e30, 3.4e38,
        np.pi, np.pi / 2, np.pi / 4, 119.9, 120.0, 1e5, 1e10,
    ], np.float32)
    return np.concatenate([base, -base])


def _bits_equal(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    same = (got.view(np.uint32) == want.view(np.uint32)) | (np.isnan(got) & np.isnan(want))
    return int((~same).sum())


def _domain(name, rng):
    """N seeded inputs over the arguments the port's call sites pass."""
    if name == "log":
        u = np.maximum(rng.random(400_000, dtype=np.float32), TINY)   # Gumbel draws
        g = -np.log(np.maximum(rng.random(300_000), TINY)).astype(np.float32)
        p = (10.0 ** rng.uniform(-30, 0, N - 700_000)).astype(np.float32)  # weights
        return np.concatenate([u, g, p])
    if name in ("acos", "asin"):
        x = rng.uniform(-1, 1, N).astype(np.float32)
        x[:1000] = np.float32(1) - rng.integers(0, 64, 1000) * np.float32(2 ** -24)
        return x
    if name in ("sin", "cos"):
        return np.concatenate([
            rng.uniform(0, 2 * np.pi, 400_000),          # cone sample angles
            rng.uniform(2 * np.pi / 3, np.pi, 200_000),  # the eigen-solve's cos
            rng.normal(0, 0.05, 200_000),                # ICP rotation angles
            rng.uniform(-120, 120, N - 800_000),
        ]).astype(np.float32)
    raise KeyError(name)


SEEDS = {"log": 1, "acos": 2, "asin": 3, "sin": 4, "cos": 5}
UNARY = {
    "log": (jnp.log, fmath.log),
    "acos": (jnp.arccos, fmath.acos),
    "asin": (jnp.arcsin, fmath.asin),
    "sin": (jnp.sin, fmath.sin),
    "cos": (jnp.cos, fmath.cos),
    "atan": (jnp.arctan, fmath.atan),
    "log2": (jnp.log2, fmath.log2),
}


@pytest.mark.parametrize("name", ["log", "acos", "asin", "sin", "cos"])
def test_unary_bit_equal_to_xla(name):
    jf, tf = UNARY[name]
    x = _domain(name, np.random.default_rng(SEEDS[name]))
    assert x.size >= 1_000_000
    want = np.asarray(jax.jit(jf)(jnp.asarray(x)))
    assert _bits_equal(tf(torch.from_numpy(x)), want) == 0


def test_atan2_bit_equal_to_xla():
    rng = np.random.default_rng(11)
    n = N // 3
    y = np.concatenate([
        rng.random(n),                                   # PPF: |cross| >= 0
        rng.normal(0, 1, n),                             # Euler: both signs
        rng.normal(0, 1, N - 2 * n) * 10.0 ** rng.uniform(-20, 20, N - 2 * n),
    ]).astype(np.float32)
    x = np.concatenate([
        rng.uniform(-1, 1, n), rng.normal(0, 1, n),
        rng.normal(0, 1, N - 2 * n) * 10.0 ** rng.uniform(-20, 20, N - 2 * n),
    ]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.arctan2)(jnp.asarray(y), jnp.asarray(x)))
    assert _bits_equal(fmath.atan2(torch.from_numpy(y), torch.from_numpy(x)), want) == 0


@pytest.mark.parametrize("name", ["log", "acos", "asin", "sin", "cos", "atan", "log2"])
def test_edge_cases_bit_equal_to_xla(name):
    jf, tf = UNARY[name]
    e = _edges()
    want = np.asarray(jax.jit(jf)(jnp.asarray(e)))
    assert _bits_equal(tf(torch.from_numpy(e)), want) == 0


def test_atan2_every_sign_and_special_combination():
    """atan2 over every pair of edge values: the signed zeros in all four
    sign combinations, the infinities, NaN, denormals (XLA runs with
    denormals flushed) and x == 1, which glibc sends straight to atanf."""
    e = _edges()
    y, x = (v.ravel() for v in np.meshgrid(e, e))
    want = np.asarray(jax.jit(jnp.arctan2)(jnp.asarray(y), jnp.asarray(x)))
    got = fmath.atan2(torch.from_numpy(y), torch.from_numpy(x))
    assert _bits_equal(got, want) == 0
    zeros = np.array([0.0, -0.0], np.float32)
    zy, zx = (v.ravel() for v in np.meshgrid(zeros, zeros))
    got = fmath.atan2(torch.from_numpy(zy), torch.from_numpy(zx)).numpy()
    # (y, x) = (+0, +0), (-0, +0), (+0, -0), (-0, -0)
    np.testing.assert_array_equal(got.view(np.uint32), np.array(
        [0.0, -0.0, np.pi, -np.pi], np.float32).view(np.uint32))


@pytest.mark.parametrize("name", ["atan2f", "sinf", "cosf"])
def test_against_glibc(name):
    """The functions XLA calls, through ctypes, on normal-range inputs."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    f = getattr(libm, name)
    f.restype = ctypes.c_float
    rng = np.random.default_rng(5)
    if name == "atan2f":
        f.argtypes = [ctypes.c_float, ctypes.c_float]
        y, x = rng.normal(0, 1, (2, 20_000)).astype(np.float32)
        want = np.array([f(a, b) for a, b in zip(y.tolist(), x.tolist())], np.float32)
        got = fmath.atan2(torch.from_numpy(y), torch.from_numpy(x))
    else:
        f.argtypes = [ctypes.c_float]
        x = rng.uniform(-200, 200, 20_000).astype(np.float32)
        want = np.array([f(a) for a in x.tolist()], np.float32)
        got = (fmath.sin if name == "sinf" else fmath.cos)(torch.from_numpy(x))
    assert _bits_equal(got, want) == 0


def _pow_domain(kind, rng):
    if kind == "decay":
        # dispersion ** counts: bases in (0, 1], integer exponents 0..256
        x = (1.0 - rng.random(N)).astype(np.float32)
        x[:1000] = np.float32(1) - rng.integers(0, 64, 1000) * np.float32(2 ** -24)
        return x, rng.integers(0, 257, N).astype(np.float32)
    x = (rng.normal(size=N) * 10.0 ** rng.uniform(-30, 30, N)).astype(np.float32)
    y = (rng.normal(size=N) * 10.0 ** rng.uniform(-3, 3, N)).astype(np.float32)
    y[: N // 3] = np.round(y[: N // 3])      # negative bases need integers
    return x, y


@pytest.mark.parametrize("kind", ["decay", "random"])
def test_pow_bit_equal_to_xla(kind):
    x, y = _pow_domain(kind, np.random.default_rng(13 if kind == "decay" else 17))
    want = np.asarray(jax.jit(jnp.power)(jnp.asarray(x), jnp.asarray(y)))
    assert _bits_equal(fmath.pow(torch.from_numpy(x), torch.from_numpy(y)), want) == 0


def test_pow_every_pair_of_edge_values():
    """Signed zeros, +-1 and neighbours, denormals (XLA's DAZ/FTZ), the
    infinities, NaN, odd and even integers, and exponents at the overflow
    and underflow edges, in every combination."""
    e = np.concatenate([_edges(), np.array(
        [3.0, -3.0, 0.25, 126.0, 127.0, 128.0, 149.0, 150.0, 151.0, -149.5,
         2.0 ** 24, 2.0 ** 24 + 2, 2.0 ** 23 + 1], np.float32)])
    y, x = (v.ravel() for v in np.meshgrid(e, e))
    want = np.asarray(jax.jit(jnp.power)(jnp.asarray(x), jnp.asarray(y)))
    assert _bits_equal(fmath.pow(torch.from_numpy(x), torch.from_numpy(y)), want) == 0


def test_pow_against_glibc():
    """powf itself, through ctypes, where no denormal is involved."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.powf.restype = ctypes.c_float
    libm.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    rng = np.random.default_rng(19)
    x = rng.uniform(0.5, 2.0, 20_000).astype(np.float32)
    y = rng.uniform(-40, 40, 20_000).astype(np.float32)
    want = np.array([libm.powf(a, b) for a, b in zip(x.tolist(), y.tolist())], np.float32)
    assert _bits_equal(fmath.pow(torch.from_numpy(x), torch.from_numpy(y)), want) == 0


@pytest.mark.parametrize("n", [31, 32, 33, 1000, 4096, 16384, 19200, 100_000])
def test_xla_sum0_bit_equal_to_xla(n):
    """The scene centroid's sum: XLA's tree of 32-row windows (kSame
    padding) then the remaining rows in order."""
    rng = np.random.default_rng(n)
    p = (rng.normal(size=(n, 3)) * [0.1, 0.1, 0.3] + [0.0, 0.0, 0.9]).astype(np.float32)
    v = rng.random(n) < 0.8
    want = np.asarray(jax.jit(lambda a, b: jnp.sum(jnp.where(b[:, None], a, 0.0), axis=0))(
        jnp.asarray(p), jnp.asarray(v)))
    got = xla_sum0(torch.where(torch.from_numpy(v)[:, None], torch.from_numpy(p), 0.0))
    np.testing.assert_array_equal(got.numpy(), want)

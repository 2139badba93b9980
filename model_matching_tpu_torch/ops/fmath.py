"""float32 transcendental functions rounded as the JAX package rounds them.

The JAX package's jitted programs on the CPU (x86-64 with FMA) evaluate
atan2, sin and cos as calls into glibc's libm (glibc 2.36: the fdlibm
`atan2f` over `atanf`, and the FMA build of `sinf` and `cosf`, which work
in float64 over `__sincosf_table`). XLA expands acos, asin and atan into
atan2, and evaluates log with its own vectorized float32 polynomial (the
Cephes `logf` of Eigen), contracting its multiply-adds into FMAs. torch's
kernels round all of these differently by an ULP or two, and differently
on the CPU and on the card, and the port's integer decisions (angle bins,
angle thresholds, Gumbel argmaxes, cone cells) sit on such ties.

Each function here repeats the reference's sequence of operations as
separate torch ops that are correctly rounded on every device: float32 and
float64 + - *, float32 quotients and fused multiply-adds formed in float64
and rounded once (`fp.div`, as `fp.fma`), `fp.sqrt_rn`, a float64 fused
multiply-add built from Dekker's exact product and Knuth's exact sum, and
integer bit manipulation. The card
therefore gives the CPU's bits, and both give XLA's.
tests/test_torch_fmath.py holds every function bit-equal to
`jax.jit(jnp.<f>)` on the CPU over seeded inputs and edge cases, and
chip_smoke.py holds the card to the CPU.
"""

from __future__ import annotations

import functools
import math
import struct

import torch

from .fp import div, f32, sqrt_rn

_F32 = torch.float32
_I32 = torch.int32
_I64 = torch.int64
_MIN_NORM = 2.0 ** -126


def _from_hex(s: str) -> float:
    return float.fromhex(s)


def _bits(x):
    return x.view(_I32)


@functools.lru_cache(maxsize=None)
def _table(values: tuple, dtype, device: str):
    """A constant tensor, made once per device: a tensor built from Python
    values on each call would copy from the host and stall the launch
    queue."""
    return torch.tensor(values, dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _scalar(value: str, dtype, device: str):
    return torch.tensor(float(value), dtype=dtype, device=device)


def _k(value, like):
    """`value` as a 0-dim tensor of `like`'s dtype and device, made once: a
    Python scalar in torch.where costs a fill kernel on the card at every
    call."""
    return _scalar(repr(float(value)), like.dtype, str(like.device))


def _flush(x):
    """Denormals to signed zero: XLA's CPU programs run with the FTZ and DAZ
    flags set, so a denormal operand of an arithmetic instruction counts as
    zero and a denormal result becomes zero."""
    return torch.where(torch.abs(x) < _MIN_NORM, x * 0.0, x)


# ----------------------------------------------------------------- atan2

def _fbits(*words):
    """float32 values (as Python floats) from their IEEE bit patterns."""
    return tuple(struct.unpack("<f", struct.pack("<I", w))[0] for w in words)


# glibc's atanf: atan(0.5), atan(1), atan(1.5), atan(inf) split in hi + lo
_ATANHI = _fbits(0x3EED6338, 0x3F490FDA, 0x3F7B985E, 0x3FC90FDA)
_ATANLO = _fbits(0x31AC3769, 0x33222168, 0x33140FB4, 0x33A22168)
# its polynomial in w = x^4 as its build evaluates it: the even chain
# aT[10], aT[8], .., aT[0] added, the odd chain aT[9] then -aT[7], .., -aT[1]
# subtracted
_AT_EVEN = _fbits(0x3C8569D7, 0x3D4BDA59, 0x3D886B35, 0x3DBA2E6E, 0x3E124925,
                  0x3EAAAAAB)
_AT_ODD = _fbits(0xBD15A221, 0x3D6EF16B, 0x3D9D8795, 0x3DE38E38, 0x3E4CCCCD)
_PI, _PI_O_2, _PI_O_4 = _fbits(0x40490FDB, 0x3FC90FDB, 0x3F490FDB)
_PI_LO_NEG, _HALF_PI_LO_NEG = _fbits(0x33BBBD2E, 0x333BBD2E)   # -pi_lo, -pi_lo/2
_3PI_O_4 = f32(3.0 * _PI_O_4)


def _atanf_nonneg(t):
    """glibc 2.36 atanf of t >= 0 (or NaN)."""
    it = _bits(t)
    tiny = it < 0x31000000                 # t < 2^-29: atan(t) = t
    big = it >= 0x4C000000                 # t >= 2^25: pi/2
    id0 = it < 0x3F300000                  # [7/16, 11/16)
    id1 = it < 0x3F980000                  # [11/16, 19/16)
    id2 = it < 0x401C0000                  # [19/16, 39/16)
    small = it < 0x3EE00000                # < 7/16: no reduction
    num = torch.where(id0, (t + t) - 1.0,
                      torch.where(id1, t - 1.0,
                                  torch.where(id2, t - 1.5, _k(-1.0, t))))
    den = torch.where(id0, t + 2.0,
                      torch.where(id1, t + 1.0,
                                  torch.where(id2, t * 1.5 + 1.0, t)))
    x = torch.where(small, t, div(num, den))
    z = x * x
    w = z * z
    s1 = w * _AT_EVEN[0]
    for c in _AT_EVEN[1:-1]:
        s1 = (s1 + c) * w
    s1 = (s1 + _AT_EVEN[-1]) * z
    s2 = w * _AT_ODD[0]
    for c in _AT_ODD[1:]:
        s2 = (s2 - c) * w
    xs = (s1 + s2) * x
    idx = (it >= 0x3F300000).to(_I64) + (it >= 0x3F980000) + (it >= 0x401C0000)
    hi = _table(_ATANHI, _F32, str(t.device))[idx]
    lo = _table(_ATANLO, _F32, str(t.device))[idx]
    reduced = hi - ((xs - lo) - x)
    out = torch.where(small, x - xs, reduced)
    out = torch.where(tiny, t, out)
    return torch.where(big & ~torch.isnan(t), _k(f32(_ATANHI[3] + _ATANLO[3]), t), out)


def atan2(y, x):
    """float32 atan2(y, x) as glibc 2.36's atan2f computes it (the fdlibm
    code: the quadrant from the signs, atanf of |y / x| with the
    atanhi/atanlo reduction, pi - (z - pi_lo) in the left half plane) and
    as XLA's `atan2` calls it. Bit-equal to `jax.jit(jnp.arctan2)` on
    1,000,003 seeded pairs and every signed-zero, infinity and NaN
    combination (tests/test_torch_fmath.py)."""
    y, x = torch.broadcast_tensors(y.to(_F32), x.to(_F32))
    hx, hy = _bits(x), _bits(y)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    y_neg, x_neg = hy < 0, hx < 0
    k = (iy - ix) >> 23
    # x == 1 calls atanf(y) itself, so a denormal y is not flushed there
    q = torch.where(hx == 0x3F800000, y, _flush(div(_flush(y), _flush(x))))
    z = _atanf_nonneg(torch.abs(q))
    z = torch.where(k > 60, _k(f32(_PI_O_2 - _HALF_PI_LO_NEG), z), z)
    z = torch.where(x_neg & (k < -60), _k(0.0, z), z)
    zl = z + _PI_LO_NEG                                     # z - pi_lo
    out = torch.where(x_neg, torch.where(y_neg, zl - _PI, _PI - zl),
                      torch.where(y_neg, -z, z))
    # the special cases, in the order glibc tests them (last wins here)
    x_inf, y_inf = ix == 0x7F800000, iy == 0x7F800000
    half_pi = torch.where(y_neg, _k(-_PI_O_2, x), _k(_PI_O_2, x))
    out = torch.where(y_inf, half_pi, out)
    both = torch.where(x_neg, _k(_3PI_O_4, x), _k(_PI_O_4, x))
    along = torch.where(x_neg, _k(_PI, x), _k(0.0, x))
    at_inf = torch.where(y_inf, both, along)
    out = torch.where(x_inf, torch.where(y_neg, -at_inf, at_inf), out)
    out = torch.where(ix == 0, half_pi, out)
    pi = torch.where(y_neg, _k(-_PI, x), _k(_PI, x))
    out = torch.where(iy == 0, torch.where(x_neg, pi, y), out)
    nan = (ix > 0x7F800000) | (iy > 0x7F800000)
    return torch.where(nan, x + y, out)


def atan(x):
    """float32 atan(x) as XLA expands it: atan2(x, 1)."""
    x = x.to(_F32)
    return atan2(x, _k(1.0, x).expand(x.shape))


def acos(x):
    """float32 acos(x) as XLA expands `chlo.acos`:
    atan2(sqrt((1 - x) * (1 + x)), x), each step rounded to float32.
    Bit-equal to `jax.jit(jnp.arccos)` on 1,000,003 seeded inputs in
    [-1, 1] and the edge cases (tests/test_torch_fmath.py)."""
    x = x.to(_F32)
    return atan2(sqrt_rn((1.0 - x) * (x + 1.0)), x)


def asin_atan2_args(x):
    """(y, x) with asin(x) = 2 * atan2(y, x): XLA's expansion of
    `chlo.asin`, for callers that batch it with other atan2s."""
    x = x.to(_F32)
    return x, sqrt_rn((1.0 - x) * (x + 1.0)) + 1.0


def asin(x):
    """float32 asin(x) as XLA expands `chlo.asin`:
    2 * atan2(x, 1 + sqrt((1 - x) * (1 + x))), each step rounded to
    float32. Bit-equal to `jax.jit(jnp.arcsin)` on 1,000,003 seeded inputs
    in [-1, 1] and the edge cases (tests/test_torch_fmath.py)."""
    r = atan2(*asin_atan2_args(x))
    return r + r


# ----------------------------------------------------------- sin and cos

# __sincosf_table[0]: 2/pi * 2^24, pi/2, the cosine (C0..C4) and sine
# (S1..S3) coefficients; table 1 negates C0..C4, i.e. the cosine result
_HPI_INV = _from_hex("0x1.45f306dc9c883p+23")
_HPI = _from_hex("0x1.921fb54442d18p+0")
_C = (1.0, _from_hex("-0x1.ffffffd0c621cp-2"), _from_hex("0x1.55553e1068f19p-5"),
      _from_hex("-0x1.6c087e89a359dp-10"), _from_hex("0x1.99343027bf8c3p-16"))
_S = (_from_hex("-0x1.555545995a603p-3"), _from_hex("0x1.1107605230bc4p-7"),
      _from_hex("-0x1.994eb3774cf24p-13"))
_PI63 = _from_hex("0x1.921fb54442d18p-62")
# 4/pi in 192 bits, as 32-bit words with byte-aligned offsets (__inv_pio4)
_INV_PIO4 = (
    0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44, 0x6e4e4415,
    0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1, 0x2757d1f5,
    0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62, 0xc0db6295,
    0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041,
)
_SPLITTER = 134217729.0  # 2^27 + 1


def _split(a):
    t = a * _SPLITTER
    hi = t - (t - a)
    return hi, a - hi


def _fma64(a, b, c):
    """float64 a * b + c with one rounding: Dekker's exact product plus
    Knuth's exact sum, the two error terms added last. It misses the
    correctly rounded result only where the exact value lies within
    2^-106 of a float64 rounding midpoint."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    es = (p - (s - bb)) + (c - bb)
    return s + (es + e)


def _reduce_large(xi):
    """glibc's reduce_large for |x| >= 120: the 2.62-bit fixed-point
    product of the mantissa with 4/pi, as (float64 remainder, quadrant
    0..3). 64-bit unsigned words are kept as two 32-bit halves in int64,
    so no product overflows."""
    u = xi.to(_I64) & 0xFFFFFFFF
    tab = _table(_INV_PIO4, _I64, str(xi.device))
    j = (u >> 26) & 15
    m = ((u & 0x7FFFFF) | 0x800000) << ((u >> 23) & 7)
    res0 = (m * tab[j]) & 0xFFFFFFFF
    res1 = m * tab[j + 4]
    res2 = m * tab[j + 8]
    lo = (res2 >> 32) + (res1 & 0xFFFFFFFF)
    hi = (res0 + (res1 >> 32) + (lo >> 32)) & 0xFFFFFFFF
    lo = lo & 0xFFFFFFFF
    n = ((hi + 0x20000000) & 0xFFFFFFFF) >> 30
    hi = (hi - (n << 30)) & 0xFFFFFFFF
    hi = torch.where(hi >= 0x80000000, hi - 0x100000000, hi)
    r = hi.double() * 4294967296.0 + lo.double()
    return r * _PI63, n


def sincos(y):
    """(sin(y), cos(y)) in float32 as glibc 2.36's sinf and cosf compute
    them (their x86-64 FMA build, which XLA's `sine` and `cosine` call):
    float64 polynomials after a pi/2 reduction (|y| < 120) or a 4/pi
    fixed-point reduction, rounded once; the build contracts x - n * pi/2
    and every Horner step. Both come from one evaluation of the two
    polynomials. Bit-equal to `jax.jit(jnp.sin)` and `jax.jit(jnp.cos)` on
    1,000,003 seeded inputs each and the edge cases
    (tests/test_torch_fmath.py)."""
    shape = y.shape
    y = y.to(_F32).reshape(-1)
    xi = _bits(y)
    top = (xi >> 20) & 0x7FF
    small, fast, finite = top <= 0x3F3, top <= 0x42E, top <= 0x7F7
    x = y.double()
    # |y| < 120: n = round(x * 2 / pi) through the 2^24-scaled product
    r = torch.where(fast, x * _HPI_INV, _k(0.0, x))
    n_fast = (r.to(_I64) + 0x800000) >> 24
    x_fast = _fma64(n_fast.double(), -_HPI, x)
    x_large, n_large = _reduce_large(xi)
    xr = torch.where(small, x, torch.where(fast, x_fast, x_large))
    n = torch.where(small, _k(0, n_fast), torch.where(fast, n_fast, n_large))
    # the quadrant that picks the sign and the table; large reductions
    # ignore the sign bit and add it here
    q = torch.where(fast, n, n + ((xi >> 31) & 1))
    # both polynomials on every lane, their independent FMAs batched
    x2 = xr * xr
    dev = str(y.device)
    k1 = _table(((_S[1],), (_C[0],), (_C[3],)), torch.float64, dev)
    k2 = _table(((_S[2],), (_C[1],), (_C[4],)), torch.float64, dev)
    s1p, c1, c2 = _fma64(x2[None], k2, k1)
    x3 = x2 * xr
    x4 = x2 * x2
    b2 = _table(((_S[0],), (_C[2],)), torch.float64, dev)
    s, c = _fma64(torch.stack([x3, x4]), b2, torch.stack([xr, c1]))
    x7 = x2 * x3
    x6 = x2 * x4
    rs, rc = _fma64(torch.stack([s1p, c2]), torch.stack([x7, x6]), torch.stack([s, c]))
    rs = torch.where(((q + 1) & 2) != 0, -rs, rs)       # sign[q & 3]
    rc = torch.where((q & 2) != 0, -rc, rc)             # table 1
    odd = (n & 1) != 0                                  # sinf takes the cosine
    sin = torch.where(odd, rc, rs).float()              # polynomial, cosf the
    cos = torch.where(odd, rs, rc).float()              # sine one
    tiny = top <= 0x397
    sin = torch.where(tiny, y, sin)
    cos = torch.where(tiny, _k(1.0, cos), cos)
    nan = y - y
    return (torch.where(finite, sin, nan).reshape(shape),
            torch.where(finite, cos, nan).reshape(shape))


def sin(x):
    """float32 sin(x) as glibc's sinf computes it (see `sincos`)."""
    return sincos(x)[0]


def cos(x):
    """float32 cos(x) as glibc's cosf computes it (see `sincos`)."""
    return sincos(x)[1]


# -------------------------------------------------------------------- log

# Cephes' logf coefficients p0..p8, the split ln 2 (q1 + q2) and sqrt(1/2),
# as the constants of XLA's compiled log
_LOG_P = _fbits(0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A, 0xBDFE5D4F, 0x3E11E9BF,
                0xBE2AAE50, 0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA)
_LOG_Q1, _LOG_Q2, _SQRTHF = _fbits(0xB95E8083, 0x3F318000, 0x3F3504F3)
_INV_LN2 = f32(1.0 / f32(math.log(2.0)))


def log(x):
    """float32 log(x) as XLA's CPU backend computes it: Eigen's Cephes
    polynomial (mantissa in [sqrt(1/2), sqrt(2)), degree-8 polynomial in
    three Horner chains, ln 2 in two parts), with the FMAs that XLA's
    x86-64 code contracts. Denormals count as zero (log = -inf), as under XLA's DAZ flag.
    Bit-equal to `jax.jit(jnp.log)` on 1,000,003 seeded inputs over
    [2^-126, 1), the Gumbel draws' second logs and the edge cases
    (tests/test_torch_fmath.py)."""
    x = x.to(_F32)
    t = torch.where(x > _MIN_NORM, x, _k(_MIN_NORM, x))
    ti = _bits(t)
    m = ((ti & -2139095041) | 0x3F000000).view(_F32)   # mantissa in [0.5, 1)
    below = m < _SQRTHF
    e = ((ti >> 23) - 126 - below.to(_I32)).to(_F32)
    f = (m - 1.0) + torch.where(below, m, _k(0.0, m))
    f2 = f * f
    f3 = f2 * f
    fd, f3d = f.double(), f3.double()

    def horner(c0, c1, c2):
        """fma(fma(f, c0, c1), f, c2), each fma formed exactly in float64
        and rounded once (fp.fma)."""
        return ((fd * c0 + c1).float().double() * fd + c2).float()

    p = _LOG_P
    y, y1, y2 = horner(*p[0:3]), horner(*p[3:6]), horner(*p[6:9])
    y = (y.double() * f3d + y1.double()).float()
    y = (y.double() * f3d + y2.double()).float()
    y = (y.double() * f3d + (e * _LOG_Q1).double()).float()
    r = (f - f2 * 0.5) + y
    r = (e.double() * _LOG_Q2 + r.double()).float()
    r = torch.where(x > 0, r, _k(torch.nan, r))
    r = torch.where(torch.abs(x) < _MIN_NORM, _k(-torch.inf, r), r)   # DAZ: +-0
    return torch.where(x == torch.inf, _k(torch.inf, r), r)


def log2(x):
    """float32 log2(x) as jnp.log2 compiles: log(x) * float32(1 / ln 2)."""
    return log(x) * _INV_LN2


# -------------------------------------------------------------------- pow

# glibc 2.36's powf tables: __powf_log2_data (1/c and log2(c) for 16
# subintervals of the mantissa, the log2(1 + r) polynomial A0..A4) and
# __exp2f_data (the bit patterns of 2^(i/32) less i << 47, the shift that
# rounds to multiples of 1/32, the 2^r polynomial C0..C2), as the library's
# rodata holds them
_POW_INVC = tuple(_from_hex(h) for h in (
    "0x1.661ec79f8f3bep+0", "0x1.571ed4aaf883dp+0", "0x1.49539f0f010b0p+0",
    "0x1.3c995b0b80385p+0", "0x1.30d190c8864a5p+0", "0x1.25e227b0b8ea0p+0",
    "0x1.1bb4a4a1a343fp+0", "0x1.12358f08ae5bap+0", "0x1.0953f419900a7p+0",
    "0x1.0p+0", "0x1.e608cfd9a47acp-1", "0x1.ca4b31f026aa0p-1",
    "0x1.b2036576afce6p-1", "0x1.9c2d163a1aa2dp-1", "0x1.886e6037841edp-1",
    "0x1.767dcf5534862p-1"))
_POW_LOGC = tuple(_from_hex(h) for h in (
    "-0x1.efec65b963019p-2", "-0x1.b0b6832d4fca4p-2", "-0x1.7418b0a1fb77bp-2",
    "-0x1.39de91a6dcf7bp-2", "-0x1.01d9bf3f2b631p-2", "-0x1.97c1d1b3b7af0p-3",
    "-0x1.2f9e393af3c9fp-3", "-0x1.960cbbf788d5cp-4", "-0x1.a6f9db6475fcep-5",
    "0x0.0p+0", "0x1.338ca9f24f53dp-4", "0x1.476a9543891bap-3",
    "0x1.e840b4ac4e4d2p-3", "0x1.40645f0c6651cp-2", "0x1.88e9c2c1b9ff8p-2",
    "0x1.ce0a44eb17bccp-2"))
_POW_A = tuple(_from_hex(h) for h in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0"))
_EXP2_T = (
    0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f, 0x3fef9301d0125b51,
    0x3fef72b83c7d517b, 0x3fef54873168b9aa, 0x3fef387a6e756238, 0x3fef1e9df51fdee1,
    0x3fef06fe0a31b715, 0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
    0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429, 0x3feea47eb03a5585,
    0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74, 0x3feea11473eb0187, 0x3feea589994cce13,
    0x3feeace5422aa0db, 0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
    0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c, 0x3fef3720dcef9069,
    0x3fef5818dcfba487, 0x3fef7c97337b9b5f, 0x3fefa4afa2a490da, 0x3fefd0765b6e4540,
)
_EXP2_SHIFT = _from_hex("0x1.8p+47")
_EXP2_C = tuple(_from_hex(h) for h in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1"))
_POW_OFLOW = _from_hex("0x1.fffffffd1d571p+6")   # y * log2(x) above: +-inf


def _checkint(iy):
    """glibc's checkint of float32 bits (int64 in [0, 2^32)): 0 if not an
    integer, 1 if odd, 2 if even."""
    e = (iy >> 23) & 0xFF
    sh = (150 - e).clamp(0, 31)
    frac = iy & ((1 << sh) - 1)
    odd = (iy >> sh) & 1
    out = torch.where(frac != 0, 0, torch.where(odd != 0, 1, 2))
    return torch.where(e < 0x7F, 0, torch.where(e > 150, 2, out))


def pow(x, y):
    """float32 x ** y as glibc 2.36's powf computes it (its x86-64 FMA
    build, which XLA's `power` calls): log2(|x|) in float64 from a 16-entry
    table and a degree-5 polynomial, times y, then 2^(y log2 x) from a
    32-entry table and a cubic, every multiply-add contracted, rounded once
    to float32; the sign from an odd integer y; XLA's FTZ/DAZ flags (a
    denormal x is scaled by 2^23 as zero, a denormal y counts as zero, a
    denormal result becomes zero). Bit-equal to `jax.jit(jnp.power)` on
    seeded bases in (0, 1] with integer exponents 0..256, on random
    finite pairs, and on every pair of edge values
    (tests/test_torch_fmath.py)."""
    x, y = torch.broadcast_tensors(x.to(_F32), y.to(_F32))
    dev = str(x.device)
    ix = _bits(x).to(_I64) & 0xFFFFFFFF
    iy = _bits(y).to(_I64) & 0xFFFFFFFF
    yint = _checkint(iy)
    x_neg = ix >= 0x80000000
    ax = ix & 0x7FFFFFFF
    # a denormal |x|: glibc normalizes x * 2^23, which DAZ makes 0
    an = torch.where(ax < 0x800000, _k(0xF4800000, ax), ax)
    tmp = (an - 0x3F330000) & 0xFFFFFFFF
    i = (tmp >> 19) & 15
    top = tmp & 0xFF800000
    iz = ((an - top) & 0xFFFFFFFF) ^ 0x80000000
    z = (iz - 0x80000000).to(_I32).view(_F32).double()
    k = ((top ^ 0x80000000) - 0x80000000) >> 23
    invc = _table(_POW_INVC, torch.float64, dev)[i]
    logc = _table(_POW_LOGC, torch.float64, dev)[i]
    a = _POW_A
    r = _fma64(z, invc, _k(-1.0, z))
    y0 = logc + k.double()
    r2 = r * r
    p1 = _fma64(r, _k(a[0], r), _k(a[1], r))
    p2 = _fma64(r, _k(a[2], r), _k(a[3], r))
    r4 = r2 * r2
    q = _fma64(r, _k(a[4], r), y0)
    q = _fma64(r2, p2, q)
    ylogx = _flush(y).double() * _fma64(r4, p1, q)
    # 2^ylogx: n / 32 the nearest multiple of 1/32, s = 2^(n / 32); beyond
    # +-160 the result is 0 or inf whatever the clamped lanes compute
    yl = torch.nan_to_num(ylogx, nan=0.0).clamp(-160.0, 160.0)
    kd = (yl + _EXP2_SHIFT) - _EXP2_SHIFT
    e = yl - kd
    n = (kd * 32.0).to(_I64)
    t = _table(_EXP2_T, _I64, dev)[n & 31] + n * (1 << 47)
    s = t.view(torch.float64)
    c = _EXP2_C
    w = _fma64(e, _k(c[0], e), _k(c[1], e))
    v = _fma64(e, _k(c[2], e), _k(1.0, e))
    out = (_fma64(w, e * e, v) * s).float()
    out = torch.where(ylogx > _POW_OFLOW, _k(torch.inf, out), _flush(out))
    out = torch.where(x_neg & (yint == 1), -out, out)
    # the special cases, in the reverse of glibc's order (the last wins)
    nan = _k(torch.nan, out)
    out = torch.where(x_neg & (yint == 0), nan, out)
    x_zin = (ax == 0) | (ax >= 0x7F800000)
    x2 = x * x
    x2 = torch.where(x_neg & (yint == 1), -x2, x2)
    out = torch.where(x_zin, torch.where(iy >= 0x80000000, 1.0 / x2, x2), out)
    ay = iy & 0x7FFFFFFF
    y_zin = (ay == 0) | (ay >= 0x7F800000)
    y_inf = (ay == 0x7F800000) & ((ax < 0x3F800000) == (iy < 0x80000000))
    yy = torch.where(y_inf, _k(0.0, out), y * y)
    yy = torch.where(ax == 0x3F800000, _k(1.0, out), yy)
    yy = torch.where((ax > 0x7F800000) | (ay > 0x7F800000), x + y, yy)
    yy = torch.where((ix == 0x3F800000) | (ay == 0), _k(1.0, out), yy)
    return torch.where(y_zin, yy, out)

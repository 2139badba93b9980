"""PPF keys and the PPF table: the port's numpy build equals the JAX
package's build array for array, and every device lookup returns the same
integers on the same inputs (tables handed over through convert.py)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from model_matching_tpu import ppf_table as jppf
from model_matching_tpu.ops import ppf as jops
from model_matching_tpu_torch import convert
from model_matching_tpu_torch import ppf_table as tppf
from model_matching_tpu_torch.ops import ppf as tops


def _cloud(seed, n):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.08, 0.08, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pos, nrm


@pytest.fixture(scope="module")
def tables():
    pos, nrm = _cloud(0, 96)
    jt, jmax = jppf.build_ppf_table(pos, nrm, 5, 5)
    tt, tmax = tppf.build_ppf_table(pos, nrm, 5, 5)
    return pos, nrm, jt, tt, jmax, tmax


def test_table_build_equal(tables):
    _pos, _nrm, jt, tt, jmax, tmax = tables
    assert jmax == pytest.approx(tmax, rel=1e-6)
    for f in ("exist_keys", "bin_keys", "bin_offset", "bin_count", "pairs",
              "bin_direct", "exist_direct"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jt, f)).astype(np.int64),
            getattr(tt, f).numpy().astype(np.int64), err_msg=f,
        )
    for f in ("tr_disc", "rot_disc", "exist_max_probes", "bin_max_probes"):
        assert getattr(jt, f) == getattr(tt, f), f


def test_keys_equal(tables):
    """Integer features of random pairs: ppf_bins, pack_key and the
    transcendental-free ppf_keys_fast."""
    pos, nrm, _jt, _tt, _a, _b = tables
    rng = np.random.default_rng(1)
    i, j = rng.integers(0, len(pos), (2, 4000))
    args = (pos[i], nrm[i], pos[j], nrm[j])
    jb = np.asarray(jops.ppf_bins(*map(jnp.asarray, args), 5, 5))
    tb = tops.ppf_bins(*map(torch.from_numpy, args), 5, 5).numpy()
    np.testing.assert_array_equal(jb, tb)
    np.testing.assert_array_equal(
        np.asarray(jops.pack_key(jnp.asarray(jb), 5, 5)),
        tops.pack_key(torch.from_numpy(tb), 5, 5).numpy(),
    )
    np.testing.assert_array_equal(
        np.asarray(jops.ppf_keys_fast(*map(jnp.asarray, args), 5, 5)),
        tops.ppf_keys_fast(*map(torch.from_numpy, args), 5, 5).numpy(),
    )
    c = rng.uniform(-1, 1, 5000).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jops.angle_bin_index(jnp.asarray(c), 5)),
        tops.angle_bin_index(torch.from_numpy(c), 5).numpy(),
    )
    np.testing.assert_array_equal(jops.fanout_deltas(5, 5), tops.fanout_deltas(5, 5))


def test_angle_bin_thresholds_made_once_per_device(monkeypatch):
    """angle_bin_index makes its threshold tensor on a device once: later
    calls read the same tensor and make no host array to copy (a copy a
    call would stall the card's launch queue and break a graph capture)."""
    made = []
    real = tops._angle_bin_cos_thresholds
    monkeypatch.setattr(tops, "_angle_bin_cos_thresholds",
                        lambda rot: made.append(rot) or real(rot))
    tops._angle_bin_thresholds.cache_clear()
    c = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, 999).astype(np.float32))
    first = tops.angle_bin_index(c, 5)
    th = tops._angle_bin_thresholds(5, "cpu")
    for _ in range(3):
        assert torch.equal(tops.angle_bin_index(c, 5), first)
    assert made == [5]
    assert tops._angle_bin_thresholds(5, "cpu") is th
    np.testing.assert_array_equal(th.numpy(), real(5))
    np.testing.assert_array_equal(
        first.numpy(), np.asarray(jops.angle_bin_index(jnp.asarray(c.numpy()), 5)))


@pytest.mark.parametrize("direct", [True, False])
def test_lookups_equal(tables, direct):
    """Existence, pair ranges and the per-pair / per-block gathers, on the
    direct-mapped tables and on the probing fallback."""
    pos, nrm, jt, _tt, _a, _b = tables
    if not direct:
        jt = dataclasses.replace(jt, bin_direct=None, exist_direct=None)
    tt = convert.ppf_table(jt)
    rng = np.random.default_rng(2)
    i, j = rng.integers(0, len(pos), (2, 600))
    keys = np.array(jops.ppf_keys_fast(
        jnp.asarray(pos[i]), jnp.asarray(nrm[i]),
        jnp.asarray(pos[j]), jnp.asarray(nrm[j]), 5, 5))
    keys[::7] = -1
    np.testing.assert_array_equal(
        np.asarray(jax.jit(jppf.ppf_exists)(jt, jnp.asarray(keys))),
        tppf.ppf_exists(tt, torch.from_numpy(keys)).numpy(),
    )
    bins = np.array(jops.ppf_bins(
        jnp.asarray(pos[i[:40]]), jnp.asarray(nrm[i[:40]]),
        jnp.asarray(pos[j[:40]]), jnp.asarray(nrm[j[:40]]), 5, 5))

    @jax.jit
    def jax_side(q):
        off, cnt = jax.vmap(lambda b: jppf.lookup_pair_range(jt, b))(q)
        out = [off, cnt]
        for cap in (64, 512):
            out += jax.vmap(lambda o, c: jppf.gather_pair_srcs(jt, o, c, cap))(off, cnt)
            out += jax.vmap(lambda o, c: jppf.gather_pair_block_srcs(
                jt, o, c, cap, 4, 160))(off, cnt)
        return out

    jout = jax_side(jnp.asarray(bins))
    toff, tcnt = tppf.lookup_pair_range(tt, torch.from_numpy(bins))
    tout = [toff, tcnt]
    for cap in (64, 512):
        tout += tppf.gather_pair_srcs(tt, toff, tcnt, cap)
        tout += tppf.gather_pair_block_srcs(tt, toff, tcnt, cap, 4, 160)
    assert len(jout) == len(tout)
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert np.asarray(jout[1]).sum() > 0
    probe_keys = np.asarray(jt.exist_keys)[:300].copy()
    probe_keys[::5] = rng.integers(0, 2**30, probe_keys[::5].shape)
    np.testing.assert_array_equal(
        np.asarray(jppf.probe_slots(jt.exist_keys, jnp.asarray(probe_keys),
                                    jt.exist_max_probes)),
        tppf.probe_slots(tt.exist_keys, torch.from_numpy(probe_keys),
                         tt.exist_max_probes).numpy(),
    )
    m = np.arange(2**16, dtype=np.uint32) * np.uint32(2654435761)
    np.testing.assert_array_equal(
        np.asarray(jppf._mix32_jnp(jnp.asarray(m))).astype(np.int64),
        tppf._mix32(torch.from_numpy(m.astype(np.int64))).numpy(),
    )

"""The port's public helpers against their JAX counterparts, on the CPU, on
the same inputs made from a seed with numpy: the padded point cloud
(types.PointCloud) and the package's exports, congruent.quads_of,
ppf_table.pack_query_np / unpack_key_np / gather_pairs and ops/ppf.ppf_keys /
inverse_fanout_deltas. Integers are held equal, floats bit for bit (the
helpers move values, they compute none), except the PPF keys of random
pairs: the port's atan2 (torch's vectorized one) and XLA's round apart by
an ulp, which moves a truncated angle across a bin boundary for about 1 of
3,000 pairs, so at most 1e-3 of the keys may differ, each by one bin of
one angle."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_matching_tpu as jpkg
import model_matching_tpu_torch as tpkg
from model_matching_tpu import congruent as jcong
from model_matching_tpu import ppf_table as jppf
from model_matching_tpu import types as jtypes
from model_matching_tpu.ops import ppf as jops
from model_matching_tpu_torch import congruent as tcong
from model_matching_tpu_torch import convert
from model_matching_tpu_torch import ppf_table as tppf
from model_matching_tpu_torch import types as ttypes
from model_matching_tpu_torch.ops import ppf as tops


def _cloud(seed, n):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.08, 0.08, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pos, nrm


@pytest.fixture(scope="module")
def tables():
    pos, nrm = _cloud(11, 64)
    jt, _d = jppf.build_ppf_table(pos, nrm, 5, 5)
    return pos, nrm, jt, convert.ppf_table(jt)


@pytest.mark.parametrize("capacity", [None, 160])
def test_point_cloud_equals_jax(capacity):
    rng = np.random.default_rng(2)
    n = 120
    arrays = dict(pos=rng.normal(size=(n, 3)).astype(np.float32),
                  normal=rng.normal(size=(n, 3)).astype(np.float32),
                  pixel=rng.integers(0, 480, (n, 2)).astype(np.int32),
                  class_prob=rng.uniform(size=n).astype(np.float32))
    jc = jtypes.PointCloud.from_numpy(**arrays, capacity=capacity)
    tc = ttypes.PointCloud.from_numpy(**arrays, capacity=capacity, device="cpu")
    for f in dataclasses.fields(jtypes.PointCloud):
        j, t = np.asarray(getattr(jc, f.name)), getattr(tc, f.name)
        assert t.device == torch.device("cpu")
        assert t.numpy().dtype == j.dtype, f.name
        np.testing.assert_array_equal(t.numpy(), j, err_msg=f.name)
    assert tc.capacity == jc.capacity == (capacity or n)
    assert int(tc.count()) == int(jc.count()) == n
    jt, tt = jc.to_numpy_trimmed(), tc.to_numpy_trimmed()
    assert jt.keys() == tt.keys()
    for k in jt:
        np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)
    with pytest.raises(ValueError, match="exceed capacity"):
        ttypes.PointCloud.from_numpy(arrays["pos"], capacity=n - 1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttypes.PointCloud.from_numpy(arrays["pos"])


def test_package_exports_the_jax_names():
    jnames = {n for n in vars(jpkg) if not n.startswith("_")
              and not isinstance(getattr(jpkg, n), type(jpkg))}
    assert jnames == {"CameraIntrinsics", "MatchConfig", "PreprocessConfig", "Preset",
                      "PRESETS", "get_preset", "PointCloud", "PoseCandidates"}
    for n in jnames:
        assert hasattr(tpkg, n), n
    assert tpkg.PointCloud is ttypes.PointCloud
    assert sorted(tpkg.PRESETS) == sorted(jpkg.PRESETS)


def test_pack_query_and_unpack_equal_jax():
    rng = np.random.default_rng(5)
    bins = np.stack([rng.integers(-5, 300, 2000), rng.integers(-5, 181, 2000),
                     rng.integers(-5, 181, 2000), rng.integers(-5, 181, 2000)],
                    axis=-1).astype(np.int32) // 5 * 5
    jq, tq = jppf.pack_query_np(bins, 5, 5), tppf.pack_query_np(bins, 5, 5)
    np.testing.assert_array_equal(tq, jq)
    assert (tq == -1).any() and (tq >= 0).any()
    keys = tq[tq >= 0]
    np.testing.assert_array_equal(tppf.unpack_key_np(keys, 5, 5),
                                  jppf.unpack_key_np(keys, 5, 5))
    np.testing.assert_array_equal(tppf.unpack_key_np(keys, 5, 5), bins[tq >= 0])


def test_ppf_keys_and_inverse_fanout_equal_jax():
    pos, nrm = _cloud(8, 90)
    i, j = np.random.default_rng(8).integers(0, 90, (2, 3000))
    args = (pos[i], nrm[i], pos[j], nrm[j])
    want = np.asarray(jops.ppf_keys(*map(jnp.asarray, args), 5, 5))
    got = tops.ppf_keys(*map(torch.from_numpy, args), 5, 5)
    assert got.dtype == torch.int32
    # the PPF angles go through ops/fmath.atan2 (glibc's atan2f, as XLA
    # calls it): every key equal
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).any()
    for tr, rot in ((5, 5), (10, 12)):
        d = tops.inverse_fanout_deltas(tr, rot)
        np.testing.assert_array_equal(d, np.asarray(jops.inverse_fanout_deltas(tr, rot)))
        assert d.shape == (128, 4) and d.dtype == np.int32


def test_gather_pairs_equals_jax(tables):
    """The pair rows of every occupied bin, through each package's
    lookup_pair_range and gather_pairs."""
    _pos, _nrm, jt, tt = tables
    occ = np.asarray(jt.bin_keys)
    occ = occ[occ >= 0][:40]
    bins = tppf.unpack_key_np(occ, 5, 5)
    for b in bins:
        joff, jcnt = jppf.lookup_pair_range(jt, jnp.asarray(b))
        toff, tcnt = tppf.lookup_pair_range(tt, torch.from_numpy(b))
        jp, jv, jtot = jppf.gather_pairs(jt, joff, jcnt, 256)
        tp, tv, ttot = tppf.gather_pairs(tt, toff, tcnt, 256)
        assert int(ttot) == int(jtot) > 0
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tp.numpy()[tv.numpy()], np.asarray(jp)[np.asarray(jv)])


def test_quads_of_equals_jax(tables):
    _pos, _nrm, jt, tt = tables
    rows = np.random.default_rng(9).integers(0, int(jt.pairs.shape[0]), (5, 7, 2))
    want = np.asarray(jcong.quads_of(jt, jnp.asarray(rows.astype(np.int32))))
    got = tcong.quads_of(tt, torch.from_numpy(rows.astype(np.int32)))
    assert got.shape == (5, 7, 4)
    np.testing.assert_array_equal(got.numpy(), want)

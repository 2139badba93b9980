"""Scene query structures: the port's builders (on CPU tensors or numpy
arrays) equal the JAX package's numpy builders array for array, and
field_lookup plus the three restricted-NN queries return the same winners
on the same points."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from model_matching_tpu.ops import densefield as jdf
from model_matching_tpu.ops import gridhash as jgh
from model_matching_tpu_torch import convert
from model_matching_tpu_torch.ops import densefield as tdf
from model_matching_tpu_torch.ops import gridhash as tgh

EPS = 0.005


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(3)
    pos = rng.uniform(-0.06, 0.06, (700, 3)).astype(np.float32)
    pos[:300, 2] = rng.normal(0, 0.001, 300)  # a dense plane
    nrm = rng.normal(size=(700, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    prob = rng.uniform(0.1, 1.0, 700).astype(np.float32)
    q = (pos[rng.integers(0, 700, 3000)]
         + rng.normal(0, 0.003, (3000, 3))).astype(np.float32)
    q[:50] = 5.0  # outside every grid
    return pos, nrm, prob, q


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=msg)


@pytest.mark.parametrize("baked", [True, False])
def test_neighbor_grid_build_and_queries(scene, baked):
    pos, nrm, prob, q = scene
    kw = dict(normal=nrm, prob=prob) if baked else {}
    jg = jgh.build_neighbor_grid(pos, cell_size=EPS, **kw)
    tg = tgh.build_neighbor_grid(pos, cell_size=EPS, **kw)
    for f in ("origin", "dims", "cell_size", "table_keys", "table_offset",
              "table_count", "cand_idx", "cell_map", "payload"):
        _eq(getattr(jg, f), getattr(tg, f), f)
    for f in ("max_probes", "cell_cap", "has_normals", "has_probs"):
        assert getattr(jg, f) == getattr(tg, f), f

    tpos, tnrm, tq = map(torch.from_numpy, (pos, nrm, q))
    jq = jnp.asarray(q)
    # exact NN: payload path, and the probe + scan path without payload
    ji, jd = jgh.query_restricted_nn(jg, jq, jnp.asarray(pos), EPS)
    ti, td = tgh.query_restricted_nn(tg, tq, tpos, EPS)
    _eq(ji, ti)
    assert (np.asarray(ji) >= 0).sum() > 1000
    # squared distances: same candidate, float32 rounding of a 3-term sum
    # (atol far below EPS^2 = 2.5e-5)
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), rtol=0, atol=1e-10)
    jg_scan = jgh.build_neighbor_grid(pos, cell_size=EPS, payload=False)
    tg_scan = convert.neighbor_grid(jg_scan)
    ji2, _ = jgh.query_restricted_nn(jg_scan, jq, jnp.asarray(pos), EPS)
    ti2, _ = tgh.query_restricted_nn(tg_scan, tq, tpos, EPS)
    _eq(ji2, ti2)
    _eq(ji, ti2)
    ji3, _d, jn3 = jgh.query_restricted_nn_normal(
        jg, jq, jnp.asarray(pos), jnp.asarray(nrm), EPS)
    ti3, _d, tn3 = tgh.query_restricted_nn_normal(tg, tq, tpos, tnrm, EPS)
    _eq(ji3, ti3)
    hit = np.asarray(ji3) >= 0
    np.testing.assert_array_equal(np.asarray(jn3)[hit], tn3.numpy()[hit])
    if baked:
        js = jgh.query_restricted_nn_scored(jg, jq, EPS)
        ts = tgh.query_restricted_nn_scored(tg, tq, EPS)
        _eq(js[0], ts[0])
        hit = np.asarray(js[0]) >= 0
        for a, b in zip(js[2:], ts[2:]):
            np.testing.assert_array_equal(np.asarray(a)[hit], b.numpy()[hit])


@pytest.mark.parametrize("baked", [True, False])
def test_dense_field_build_and_lookup(scene, baked):
    pos, nrm, prob, q = scene
    jf = jdf.build_dense_field(pos, nrm, EPS, prob=prob if baked else None)
    tf = tdf.build_dense_field(pos, nrm, EPS, prob=prob if baked else None)
    for f in ("rows", "origin", "dims", "cell"):
        _eq(getattr(jf, f), getattr(tf, f), f)
    assert jf.has_probs == tf.has_probs
    for a, b in zip(jdf.field_lookup(jf, jnp.asarray(q)),
                    tdf.field_lookup(tf, torch.from_numpy(q))):
        _eq(a, b)


def _tie_scene():
    """Exact distance ties: eight duplicated points, and points mirrored
    about their field cell's centre, on a 1/64 lattice with eps = 1/4 and
    the corner pinned by two anchors, so every coordinate and distance is
    exact in float32."""
    rng = np.random.default_rng(5)
    eps, lo = 0.25, -1.5                    # lo = anchor min - 2 * eps
    base = rng.integers(-40, 41, (120, 3)) / 64.0
    cell = np.floor((base - lo) / eps)
    centre = (cell + 0.5) * eps + lo
    pos = np.concatenate([[[-1.0] * 3, [1.0] * 3], base, 2 * centre - base, base[:8]])
    nrm = rng.normal(size=pos.shape)
    prob = rng.uniform(0.1, 1.0, len(pos))
    return pos.astype(np.float32), nrm.astype(np.float32), prob.astype(np.float32), eps


def _build_case(case, scene):
    """(pos, normal, prob, builder name, kwargs) of one case."""
    pos, nrm, prob, _q = scene
    if case == "ties":
        return _tie_scene()
    if case == "past-guards":
        # a 3 m cube at 5 mm is 603^3 cells, over the cell map's guard
        rng = np.random.default_rng(6)
        far = rng.uniform(-1.5, 1.5, (40, 3)).astype(np.float32)
        return far, nrm[:40], prob[:40], EPS
    if case == "one-point":
        return pos[:1], nrm[:1], prob[:1], EPS
    return pos, nrm, prob, EPS


_CASES = [
    ("scene", "grid", dict(baked=True)),
    ("scene", "grid", dict(baked=False)),
    ("scene", "grid", dict(cell_cap=8)),
    ("scene", "grid", dict(payload=False)),
    ("scene", "field", dict(baked=True)),
    ("scene", "field", dict(baked=False)),
    ("ties", "grid", dict(baked=True)),
    ("ties", "field", dict(baked=True)),
    ("ties", "field", dict(baked=False)),
    ("past-guards", "grid", dict(baked=True)),
    ("one-point", "grid", dict(baked=True)),
    ("one-point", "field", dict(baked=True)),
]


@pytest.mark.parametrize("case,kind,kw", [
    pytest.param(*c, id="-".join([c[0], c[1]] + [f"{k}={v}" for k, v in c[2].items()]))
    for c in _CASES])
def test_tensor_builders_equal_numpy_builders(scene, case, kind, kw, monkeypatch):
    """The builders on CPU tensors give the JAX package's numpy structures
    field for field (dtype, shape and bits), including the lowest-index
    tie-break, an explicit cap that truncates (and warns), the table-only
    grid past the payload guards and a one-point scene."""
    from model_matching_tpu_torch.utils import log

    pos, nrm, prob, eps = _build_case(case, scene)
    kw = dict(kw)
    baked = kw.pop("baked", False)
    warned = []
    monkeypatch.setattr(log, "warn", lambda msg, **f: warned.append(msg))
    t = torch.from_numpy
    if kind == "grid":
        extra = dict(normal=nrm, prob=prob) if baked else {}
        want = jgh.build_neighbor_grid(pos, cell_size=eps, **extra, **kw)
        got = tgh.build_neighbor_grid(t(pos), cell_size=eps,
                                      **{k: t(v) for k, v in extra.items()}, **kw)
    else:
        want = jdf.build_dense_field(pos, nrm, eps, prob=prob if baked else None)
        got = tdf.build_dense_field(t(pos), t(nrm), eps, prob=t(prob) if baked else None)
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if a is None or b is None:
            assert a is None and b is None, f.name
        elif isinstance(b, torch.Tensor):
            a = torch.from_numpy(np.array(a))
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    assert (warned != []) == ("cell_cap" in kw)
    if case == "past-guards":
        assert got.payload is None and got.cell_map is None
    if case == "ties" and kind == "field":
        # the duplicates (the last eight points) lose every tie to their
        # originals, which win somewhere
        idx = got.rows[:, 6][got.rows[:, 7] != (-1.0 if baked else 0.0)]
        assert not bool(torch.isin(idx, torch.arange(len(pos) - 8, len(pos)).float()).any())
        assert bool(torch.isin(idx, torch.arange(2, 10).float()).any())


@pytest.mark.parametrize("case", ["sparse", "min_size", "wrapping_cluster"])
def test_open_table_equals_build_open_table(case):
    """gridhash._open_table equals ppf_table._build_open_table (table and
    probe bound) on sorted unique keys: spread keys, a `min_size` above 4x
    the keys, and keys whose home slots crowd the table's end, so runs wrap
    past slot 0 and the insertion takes several read rounds."""
    from model_matching_tpu_torch.ppf_table import _build_open_table, _mix32_np

    rng = np.random.default_rng(5)
    cand = np.unique(rng.integers(0, 1 << 31, 200_000).astype(np.int32))
    if case == "wrapping_cluster":
        keys = cand[(_mix32_np(cand) & 255) >= 244][:64]    # 64 keys, 12 home slots of 256
    else:
        keys = np.sort(rng.choice(cand, 300, replace=False))
    min_size = 1 << 12 if case == "min_size" else 0
    want, want_probes = _build_open_table(keys, min_size=min_size)
    got, probes, _ = tgh._open_table(torch.from_numpy(keys), min_size=min_size)
    _eq(want, got)
    assert probes == want_probes
    if case == "wrapping_cluster":
        assert want_probes > 2 * tgh._TABLE_ROUNDS and want[0] >= 0

"""Pose clustering of the port against the JAX package, on poses made from
a numpy seed.

Tolerances: quaternions within 1e-5; Euler angles and the pose difference
bit-equal, the gimbal pole included (ops/fmath.py gives atan2 and asin the
JAX package's rounding); the greedy selection's indices equal, on data not
placed on a threshold."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from model_matching_tpu import clustering as jcl
from model_matching_tpu_torch import clustering as tcl


def rand_poses(rng, n, t_scale=0.1):
    m = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    m[:, :3, :3] = Rotation.random(n, rng=rng).as_matrix()
    m[:, :3, 3] = rng.normal(0, t_scale, (n, 3))
    return m


def _t(a):
    return torch.from_numpy(np.array(a))


def test_quaternion_and_euler_equal_jax():
    rng = np.random.default_rng(0)
    rots = rand_poses(rng, 256)[:, :3, :3]
    # every Shepperd branch: rotations by ~180 degrees about each axis
    for i, ax in enumerate("xyz"):
        rots[i] = Rotation.from_euler(ax, 179.0, degrees=True).as_matrix()
    jq = jcl.matrix_to_quaternion(jnp.asarray(rots))
    tq = tcl.matrix_to_quaternion(_t(rots))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-5)
    back = Rotation.from_quat(np.concatenate([tq.numpy()[:, 1:], tq.numpy()[:, :1]], 1))
    np.testing.assert_allclose(back.as_matrix(), rots, atol=1e-4)
    je = jcl.quaternion_to_euler(jq)
    te = tcl.quaternion_to_euler(_t(np.asarray(jq)))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    # the gimbal branch: |sin(pitch)| >= 1
    q = np.array([[np.sqrt(0.5), 0, np.sqrt(0.5), 0],
                  [np.sqrt(0.5), 0, -np.sqrt(0.5), 0]], np.float32) * 1.0001
    np.testing.assert_array_equal(tcl.quaternion_to_euler(_t(q)).numpy(),
                                  np.asarray(jcl.quaternion_to_euler(jnp.asarray(q))))


@pytest.mark.parametrize("sym", [(0, 0, 0), (0, 0, 360), (90, 0, 180), (180, 90, 0)])
def test_pose_difference_equals_jax(sym):
    """Bit-equal, the poses near the gimbal pole included (there an
    angle's error would be unbounded in the rounding of atan2 and asin)."""
    rng = np.random.default_rng(1)
    a, b = rand_poses(rng, 400), rand_poses(rng, 400)
    s = np.array(sym, np.float32)
    jr, jt = jcl.pose_difference(jnp.asarray(a), jnp.asarray(b), jnp.asarray(s))
    tr, tt = tcl.pose_difference(_t(a), _t(b), _t(s))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    # the argument order matters: test^T @ base, not base^T @ test
    swapped, _ = tcl.pose_difference(_t(b), _t(a), _t(s))
    if sym == (0, 0, 0):
        assert float((swapped - tr).abs().max()) > 1.0
    # one test pose against many bases broadcasts
    one, _ = tcl.pose_difference(_t(a[3]), _t(b), _t(s))
    want, _ = jcl.pose_difference(jnp.asarray(a[3]), jnp.asarray(b), jnp.asarray(s))
    keep = np.abs((a[3, :3, :3].T @ b[:, :3, :3])[:, 2, 0]) < np.sin(np.radians(85.0))
    np.testing.assert_allclose(one.numpy()[keep], np.asarray(want)[keep], rtol=0, atol=1e-3)


def clustered_pool(rng, n_clusters=6, per=40, tie=True):
    """Tight clusters of poses around distinct centres (members 2 degrees
    and 2 mm from their centre, centres 20 cm and tens of degrees apart:
    nothing near the 15 degree / 5 cm thresholds), shuffled, with LCPs in
    [0.3, 0.9], some invalid, and exact score ties."""
    centres = rand_poses(rng, n_clusters, t_scale=0.2)
    poses, lcp = [], []
    for c in centres:
        for _ in range(per):
            m = c.copy()
            d = Rotation.from_rotvec(rng.normal(0, np.radians(1.0), 3)).as_matrix()
            m[:3, :3] = (d @ c[:3, :3]).astype(np.float32)
            m[:3, 3] += rng.normal(0, 0.001, 3).astype(np.float32)
            poses.append(m)
            lcp.append(rng.uniform(0.3, 0.9))
    poses = np.stack(poses).astype(np.float32)
    lcp = np.array(lcp, np.float32)
    if tie:
        lcp[rng.choice(len(lcp), 60, replace=False)] = np.float32(0.85)
    valid = rng.random(len(lcp)) < 0.9
    return poses, lcp, valid


@pytest.mark.parametrize("seed,max_count,fraction", [
    (0, 8, 0.5), (1, 3, 0.5), (2, 8, 0.9), (3, 0, 0.5), (4, 8, 0.0)])
def test_greedy_clustering_indices_equal_jax(seed, max_count, fraction):
    """The bounded walk (at most max_count + 1 batched steps) selects what
    the JAX package's walk over all H sorted candidates selects: ties go to
    the lower index, the prune is strictly-greater, the walk stops after
    the cap is exceeded."""
    rng = np.random.default_rng(seed)
    poses, lcp, valid = clustered_pool(rng)
    best = np.float32(lcp[valid].max())
    kw = dict(acceptable_fraction=fraction, maximum_pose_count=max_count,
              min_distance=0.05, min_angle=15.0)
    jidx, jmask = jcl.greedy_clustering(
        jnp.asarray(poses), jnp.asarray(lcp), jnp.asarray(valid),
        best_score=jnp.float32(best), sym_info=jnp.zeros(3), **kw)
    tidx, tmask = tcl.greedy_clustering(
        _t(poses), _t(lcp), _t(valid), best_score=float(best),
        sym_info=torch.zeros(3), **kw)
    assert tidx.dtype == torch.int32 and tidx.shape == (max_count + 1,)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    sel = tidx[tmask].numpy()
    assert len(sel) == min(max_count + 1, 6 if fraction < 0.9 else len(sel))
    assert valid[sel].all() and (np.diff(lcp[sel]) <= 0).all()
    assert lcp[sel[0]] == best


def test_greedy_clustering_small_cases():
    """The JAX package's own unit cases: identical poses collapse to one;
    scores at or below the fraction never enter; an empty pool selects
    nothing."""
    poses = _t(np.stack([np.eye(4, dtype=np.float32)] * 4))
    lcps = _t(np.array([0.9, 0.5, 0.1, 0.05], np.float32))
    kw = dict(acceptable_fraction=0.7, best_score=0.9, maximum_pose_count=5,
              min_distance=1e-6, min_angle=1e-6, sym_info=torch.zeros(3))
    idx, mask = tcl.greedy_clustering(poses, lcps, torch.ones(4, dtype=torch.bool), **kw)
    assert idx[mask].tolist() == [0] and idx[~mask].eq(-1).all()
    # strictly greater: a score equal to fraction * best is pruned
    lcps2 = _t(np.array([0.9, np.float32(0.7) * np.float32(0.9)], np.float32))
    far = poses[:2].clone()
    far[1, 0, 3] = 1.0
    idx, mask = tcl.greedy_clustering(far, lcps2, torch.ones(2, dtype=torch.bool), **kw)
    assert idx[mask].tolist() == [0]
    idx, mask = tcl.greedy_clustering(poses, lcps, torch.zeros(4, dtype=torch.bool), **kw)
    assert not mask.any() and idx.eq(-1).all()


def test_symmetry_merges_clusters():
    """Two poses a half-turn about z apart are two clusters without
    symmetry and one with 180-degree symmetry about z, as in the JAX
    package."""
    a = np.eye(4, dtype=np.float32)
    b = np.eye(4, dtype=np.float32)
    b[:3, :3] = Rotation.from_euler("z", 178.0, degrees=True).as_matrix()
    poses = np.stack([a, b])
    lcp = np.array([0.9, 0.8], np.float32)
    for sym, want in (((0, 0, 0), [0, 1]), ((0, 0, 180), [0])):
        kw = dict(acceptable_fraction=0.5, maximum_pose_count=4, min_distance=0.05,
                  min_angle=15.0)
        jidx, jmask = jcl.greedy_clustering(
            jnp.asarray(poses), jnp.asarray(lcp), jnp.ones(2, bool),
            best_score=jnp.float32(0.9), sym_info=jnp.asarray(np.array(sym, np.float32)), **kw)
        tidx, tmask = tcl.greedy_clustering(
            _t(poses), _t(lcp), torch.ones(2, dtype=torch.bool), best_score=0.9,
            sym_info=_t(np.array(sym, np.float32)), **kw)
        assert tidx[tmask].tolist() == want == np.asarray(jidx)[np.asarray(jmask)].tolist()

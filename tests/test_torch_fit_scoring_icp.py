"""Rigid fit, weighted-LCP scoring and ICP against the JAX package, on the
synthetic scene. Tolerances: fit transforms atol 1e-5 (float32 frame
algebra in another rounding order), LCP scores atol 1e-5 (float32 sums of
~300 weights in another order; a gate flip would move a score by ~3e-3),
the ICP-refined pose atol 1e-4 (6x6 float32 normal equations solved by
each framework's own LU)."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _synthetic_setup
from model_matching_tpu import icp as jicp
from model_matching_tpu import scoring as jsc
from model_matching_tpu.ops import fit as jfit
from model_matching_tpu_torch import convert
from model_matching_tpu_torch import icp as ticp
from model_matching_tpu_torch import scoring as tsc
from model_matching_tpu_torch.ops import fit as tfit


@pytest.fixture(scope="module")
def setup():
    model, scene, cfg = _synthetic_setup()
    tm, ts = convert.model_pack(model), convert.scene_pack(scene)
    # the true centered-frame pose of _synthetic_setup, plus perturbed copies
    th = 0.7
    rot = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                    [0, 0, 1]])
    t = np.array([0.05, -0.1, 0.8])
    gt = np.eye(4)
    gt[:3, :3] = rot
    gt[:3, 3] = rot @ np.asarray(model.centroid) + t - np.asarray(scene.centroid)
    r = np.random.default_rng(11)
    h = 96
    tr = np.tile(gt, (h, 1, 1))
    for i in range(1, h):
        a = r.normal(0, 0.04 if i < 64 else 0.5, 3)
        k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        tr[i, :3, :3] = (np.eye(3) + np.sin(np.linalg.norm(a)) / max(np.linalg.norm(a), 1e-9) * k
                         + (1 - np.cos(np.linalg.norm(a))) / max(np.linalg.norm(a), 1e-9) ** 2 * k @ k) @ rot
        tr[i, :3, 3] += r.normal(0, 0.004 if i < 64 else 0.05, 3)
    valid = np.ones(h, bool)
    valid[5] = False
    return model, scene, cfg, tm, ts, tr.astype(np.float32), valid


def test_fit_equal():
    r = np.random.default_rng(12)
    mq = r.uniform(-0.1, 0.1, (200, 4, 3)).astype(np.float32)
    mq[::17, 2] = mq[::17, 0]  # degenerate triplets
    th = r.uniform(0, 2 * np.pi, 200)
    rot = np.stack([np.cos(th), -np.sin(th), np.zeros(200), np.sin(th),
                    np.cos(th), np.zeros(200), np.zeros(200), np.zeros(200),
                    np.ones(200)], -1).reshape(200, 3, 3)
    sq = (np.einsum("bij,bkj->bki", rot, mq) + r.normal(0, 0.002, (200, 4, 3))
          ).astype(np.float32)
    sc, mc = np.float32([0.1, 0.2, 0.7]), np.float32([0.01, -0.02, 0.03])
    jo = jax.jit(jfit.fit_congruent_pairs)(sq, mq, sc, mc)
    to = tfit.fit_congruent_pairs(*map(torch.from_numpy, (sq, mq, sc, mc)))
    np.testing.assert_array_equal(np.asarray(jo["valid"]), to["valid"].numpy())
    v = np.asarray(jo["valid"])
    assert 0 < v.sum() < 200
    for k in ("transform", "world_transform"):
        np.testing.assert_allclose(np.asarray(jo[k])[v], to[k].numpy()[v],
                                   rtol=0, atol=1e-5)


def _kw(cfg):
    return dict(distance_threshold=cfg.distance_threshold,
                normal_angle_threshold_deg=cfg.lcp_normal_angle_threshold)


@pytest.mark.parametrize("baked", [True, False])
def test_field_and_exact_scores_equal(setup, baked):
    model, scene, cfg, tm, ts, tr, valid = setup
    jprob = None if baked else scene.class_prob
    tprob = None if baked else ts.class_prob
    jf = jax.jit(lambda t, v: jsc.score_transforms_field(
        t, v, model.pos, model.normal, model.valid, scene.field, jprob, **_kw(cfg)))
    tf = tsc.score_transforms_field(
        torch.from_numpy(tr), torch.from_numpy(valid), tm.pos, tm.normal,
        tm.valid, ts.field, tprob, **_kw(cfg))
    jfs = np.asarray(jf(tr, valid))
    np.testing.assert_allclose(jfs, tf.numpy(), rtol=0, atol=1e-5)
    assert (jfs > 0.4).sum() > 10
    for chunk in (0, 32):
        je = jax.jit(lambda t, v: jsc.score_transforms(
            t, v, model.pos, model.normal, model.valid, scene.grid, scene.pos,
            scene.normal, jprob, chunk=chunk, **_kw(cfg)))(tr, valid)
        te = tsc.score_transforms(
            torch.from_numpy(tr), torch.from_numpy(valid), tm.pos, tm.normal,
            tm.valid, ts.grid, ts.pos, ts.normal, tprob, chunk=chunk, **_kw(cfg))
        np.testing.assert_allclose(np.asarray(je), te.numpy(), rtol=0, atol=1e-5)
    ji, jb = jsc.best_pose(je)
    ti, tb = tsc.best_pose(te)
    assert int(ji) == int(ti) and abs(float(jb) - float(tb)) <= 1e-5


@pytest.mark.parametrize("compact", [0, 64])
def test_score_hybrid_equal(setup, compact):
    model, scene, cfg, tm, ts, tr, valid = setup
    fn = jax.jit(functools.partial(
        jsc.score_hybrid, model_pos=model.pos, model_normal=model.normal,
        model_valid=model.valid, field=scene.field, grid=scene.grid,
        scene_pos=scene.pos, scene_normal=scene.normal, scene_class_prob=None,
        refine_count=16, mid_fraction=0.5, compact_cap=compact, **_kw(cfg)))
    js = np.asarray(fn(tr, valid))
    t_out = tsc.score_hybrid(
        torch.from_numpy(tr), torch.from_numpy(valid), tm.pos, tm.normal,
        tm.valid, ts.field, ts.grid, ts.pos, ts.normal, None,
        refine_count=16, mid_fraction=0.5, compact_cap=compact, **_kw(cfg))
    np.testing.assert_array_equal(js >= 0, t_out.numpy() >= 0)
    np.testing.assert_allclose(js, t_out.numpy(), rtol=0, atol=1e-5)
    ji, _b = jsc.best_pose(jnp.asarray(js))
    ti, _b = tsc.best_pose(t_out)
    assert int(ji) == int(ti)


def test_partition_and_chunk_helpers():
    r = np.random.default_rng(13)
    v = r.random(5000) < 0.1
    np.testing.assert_array_equal(
        np.asarray(jsc._stable_partition_sel(jnp.asarray(v), 700)),
        tsc._stable_partition_sel(torch.from_numpy(v), 700).numpy())
    for args in ((0, 512, 40), (4096, 512, 40), (0, 320, 8)):
        assert jsc.exact_score_chunk(*args) == tsc.exact_score_chunk(*args)
    seen = []
    assert tsc.run_bucketed(torch.tensor(300), 4096, lambda w: seen.append(w) or w) == 512
    assert tsc.run_bucketed(torch.tensor(4000), 4096, lambda w: w) == 4096


def test_icp_refine_equal(setup):
    model, scene, cfg, tm, ts, tr, _valid = setup
    jrefine = jax.jit(lambda p: jicp.refine_pose(
        p, model.pos, model.valid, scene.icp_grid, scene.pos, scene.normal,
        max_corr_dist=cfg.icp_max_corr_dist, iterations=cfg.icp_iterations))
    for i in (0, 3, 40):
        jr = jrefine(tr[i])
        trf = ticp.refine_pose(
            torch.from_numpy(tr[i]), tm.pos, tm.valid, ts.icp_grid, ts.pos,
            ts.normal, max_corr_dist=cfg.icp_max_corr_dist,
            iterations=cfg.icp_iterations)
        np.testing.assert_allclose(np.asarray(jr), trf.numpy(), rtol=0, atol=1e-4)


def _three_planes(n, seed):
    """A target of three orthogonal planes (all 6 degrees of freedom
    constrained) and a source moved off it, 15% of it displaced further
    (an occluded region a plain point-to-plane fit would chase)."""
    r = np.random.default_rng(seed)
    k = n // 3
    u = lambda: r.uniform(-0.2, 0.2, k)
    target = np.concatenate([
        np.stack([u(), u(), np.zeros(k)], 1), np.stack([u(), np.zeros(k), u()], 1),
        np.stack([np.zeros(k), u(), u()], 1)]).astype(np.float32)
    nrm = np.concatenate([np.tile([0, 0, 1.0], (k, 1)), np.tile([0, 1.0, 0], (k, 1)),
                          np.tile([1.0, 0, 0], (k, 1))]).astype(np.float32)
    gt = np.eye(4, dtype=np.float32)
    gt[:3, 3] = [0.008, -0.006, 0.01]
    source = target @ gt[:3, :3].T + gt[:3, 3]
    source[:int(0.15 * n)] += np.array([0.03, 0.03, 0.0], np.float32)
    return target, nrm, source, gt


@pytest.mark.parametrize("trim,valid_fraction", [(0.7, 1.0), (0.8, 0.6), (0.33, 1.0)])
def test_trimmed_icp_equal(trim, valid_fraction):
    """trimmed_icp's offset within 1e-5 of the JAX package's on the same
    grid (the kept set is an integer decision: n_keep is a float32 product
    truncated, the threshold the n_keep-th smallest residual), with some
    source points masked out, and it undoes the perturbation."""
    from model_matching_tpu.ops.gridhash import build_neighbor_grid as jgrid

    n = 900
    target, nrm, source, gt = _three_planes(n, seed=21)
    valid = np.arange(n) < int(valid_fraction * n)
    grid = jgrid(target, cell_size=0.035)
    want = np.asarray(jicp.trimmed_icp(
        jnp.asarray(source), jnp.asarray(valid), jnp.asarray(target),
        jnp.asarray(nrm), grid, trim_fraction=trim))
    got = ticp.trimmed_icp(
        torch.from_numpy(source), torch.from_numpy(valid), torch.from_numpy(target),
        torch.from_numpy(nrm), convert.neighbor_grid(grid), trim_fraction=trim).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if trim == 0.7:
        residual = got @ gt
        assert np.linalg.norm(residual[:3, 3]) < 4e-3
        np.testing.assert_allclose(residual[:3, :3], np.eye(3), atol=6e-3)


def test_trimmed_icp_identity_without_correspondences():
    from model_matching_tpu_torch.ops.gridhash import build_neighbor_grid

    r = np.random.default_rng(3)
    target = r.uniform(-0.1, 0.1, (100, 3)).astype(np.float32)
    nrm = np.tile([0, 0, 1.0], (100, 1)).astype(np.float32)
    source = target + np.array([10.0, 0, 0], np.float32)
    grid = build_neighbor_grid(target, cell_size=0.035, cell_cap=64)
    off = ticp.trimmed_icp(torch.from_numpy(source), torch.ones(100, dtype=torch.bool),
                           torch.from_numpy(target), torch.from_numpy(nrm), grid)
    assert torch.equal(off, torch.eye(4))

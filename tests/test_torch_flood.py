"""Flood-fill segmentation of the port against the JAX package and against
the literal queue BFS of tests/test_flood.py, on edge maps made from a
numpy seed. Masks and `converged` flags are booleans: equal, no tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from model_matching_tpu import flood as jflood
from model_matching_tpu_torch import flood as tflood
from tests.test_flood import ref_bfs, ref_bfs_local


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def walls(h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    edge_free = np.ones((h, w), bool)
    edge_free[20, 5:40] = False
    edge_free[5:20, 30] = False
    edge_free[rng.integers(0, h, 40), rng.integers(0, w, 40)] = False
    edge_free[10, 10] = True
    return edge_free


def spiral(h=64, w=64, gap=3):
    edge_free = np.ones((h, w), bool)
    top, bot, left, right = 2, h - 3, 2, w - 3
    while top < bot and left < right:
        edge_free[top, left:right] = False
        edge_free[top:bot, right] = False
        edge_free[bot, left + gap:right] = False
        edge_free[top + gap:bot, left] = False
        top += gap
        bot -= gap
        left += gap
        right -= gap
    edge_free[h // 2, w // 2] = True
    return edge_free


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("max_dist", [8.0, 20.0, 100.0])
def test_while_mode_equals_jax_and_bfs(max_dist):
    edge_free = walls()
    seed = np.array([10, 10], np.int32)
    jm, jc = jflood.flood_fill(jnp.asarray(seed), jnp.asarray(edge_free),
                               max_dist, max_iters=128, return_converged=True)
    tm, tc = tflood.flood_fill(_t(seed), _t(edge_free), max_dist,
                               max_iters=128, return_converged=True)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tm.numpy(), ref_bfs(seed, edge_free, max_dist))
    assert bool(tc) == bool(jc) is True


@pytest.mark.parametrize("sweeps", [1, 2, 8, 64])
def test_fixed_sweeps_and_converged_equal_jax_on_spiral(sweeps):
    """Too few sweeps under-fill the spiral and report it; enough reach
    the BFS fixpoint."""
    edge_free = spiral()
    seed = np.array([32, 32], np.int32)
    jm, jc = jflood.flood_fill(jnp.asarray(seed), jnp.asarray(edge_free),
                               1000.0, fixed_sweeps=sweeps, return_converged=True)
    tm, tc = tflood.flood_fill(_t(seed), _t(edge_free), 1000.0,
                               fixed_sweeps=sweeps, return_converged=True)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert bool(tc) == bool(jc)
    want = ref_bfs(seed, edge_free, 1000.0)
    assert bool(tc) == bool((tm.numpy() == want).all())
    if sweeps == 64:
        assert bool(tc) and want.sum() > 100


def test_max_iters_cut_reports_unconverged():
    """The loop cut at max_iters: the mask and the flag equal the JAX
    package's (converged only if the last sweep changed nothing)."""
    edge_free = spiral()
    seed = np.array([32, 32], np.int32)
    for iters in (1, 3, 512):
        jm, jc = jflood.flood_fill(jnp.asarray(seed), jnp.asarray(edge_free),
                                   1000.0, max_iters=iters, return_converged=True)
        tm, tc = tflood.flood_fill(_t(seed), _t(edge_free), 1000.0,
                                   max_iters=iters, return_converged=True)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        assert bool(tc) == bool(jc), iters


def test_blocked_seed():
    edge_free = np.zeros((16, 16), bool)
    seed = np.array([8, 8], np.int32)
    got = tflood.flood_fill(_t(seed), _t(edge_free), 100.0, max_iters=32).numpy()
    want = np.asarray(jflood.flood_fill(jnp.asarray(seed), jnp.asarray(edge_free),
                                        100.0, max_iters=32))
    np.testing.assert_array_equal(got, want)
    assert got[8, 8] and got.sum() == 1
    # a blocked seed next to free space lifts onto its neighbours
    edge_free[:, 9:] = True
    got = tflood.flood_fill(_t(seed), _t(edge_free), 100.0, fixed_sweeps=4).numpy()
    np.testing.assert_array_equal(got, ref_bfs(seed, edge_free, 100.0))
    assert got.sum() == 1 + 16 * 7


@pytest.mark.parametrize("mode", ["while", "fixed"])
def test_batch_of_seeds_equals_one_by_one(mode):
    """[K, 2] seeds with [K] radii in one call: each mask and flag equals
    the single-seed call, the JAX package's and the BFS."""
    edge_free = walls(seed=3)
    rng = np.random.default_rng(7)
    free = np.argwhere(edge_free)
    seeds = free[rng.choice(len(free), 5, replace=False)].astype(np.int32)
    seeds[4] = np.argwhere(~edge_free)[0]            # one blocked seed
    radii = np.array([6.0, 15.5, 40.0, 200.0, 9.0], np.float32)
    kw = dict(max_iters=64) if mode == "while" else dict(fixed_sweeps=2)
    bm, bc = tflood.flood_fill(_t(seeds), _t(edge_free), _t(radii),
                               return_converged=True, **kw)
    assert bm.shape == (5, 48, 64) and bc.shape == (5,)
    for k in range(5):
        jm, jc = jflood.flood_fill(jnp.asarray(seeds[k]), jnp.asarray(edge_free),
                                   radii[k], return_converged=True, **kw)
        np.testing.assert_array_equal(bm[k].numpy(), np.asarray(jm), err_msg=str(k))
        assert bool(bc[k]) == bool(jc), k
        if bool(jc):
            np.testing.assert_array_equal(
                bm[k].numpy(), ref_bfs(seeds[k], edge_free, radii[k]))


@pytest.mark.parametrize("depth", [5, 12, 200])
def test_local_flood_fill(depth):
    edge_free = walls(seed=5)
    seed = np.array([10, 10], np.int32)
    got = tflood.local_flood_fill(_t(seed), _t(edge_free), 100.0, depth_limit=depth)
    want = jflood.local_flood_fill(jnp.asarray(seed), jnp.asarray(edge_free),
                                   100.0, depth_limit=depth)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), ref_bfs_local(seed, edge_free, 100.0, depth_limit=depth))


def test_dilate_and_axis_reach_equal_jax():
    rng = np.random.default_rng(2)
    mask = rng.random((20, 28)) < 0.05
    allowed = rng.random((20, 28)) < 0.8
    np.testing.assert_array_equal(
        tflood._dilate8(_t(mask)).numpy(), np.asarray(jflood._dilate8(jnp.asarray(mask))))
    for axis in (0, 1):
        want = jflood._axis_reach(jnp.asarray(mask), jnp.asarray(allowed), axis)
        got = tflood._axis_reach(_t(mask), _t(allowed), axis)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prune_and_segment_edge_probability():
    probs = np.array([0.5, 0.3, 0.2], np.float32)
    edge = np.array([0.0, 1.0, 0.5], np.float32)
    np.testing.assert_array_equal(
        tflood.prune_edge_points(_t(probs), _t(edge)).numpy(),
        np.asarray(jflood.prune_edge_points(jnp.asarray(probs), jnp.asarray(edge))))
    img = np.random.default_rng(1).random((24, 32)).astype(np.float32)
    a, b = np.array([2, 3], np.int32), np.array([20, 30], np.int32)
    want = jflood.segment_edge_max_probability(None, jnp.asarray(img),
                                               jnp.asarray(a), jnp.asarray(b))
    got = tflood.segment_edge_max_probability(None, _t(img), _t(a), _t(b))
    assert float(got) == float(want)

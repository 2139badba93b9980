"""Instance-path sampling of the port against the JAX package, on the
small scenes of tests/test_instance.py (N = 64 points on a 24x32 image, an
edge wall, made from a numpy seed), with equal keys.

Sequential sampler: base indices, `valid`, `fill_converged` and `seg_masks`
equal, `class_prob` bit-equal (one float32 multiply per decayed base), the
invariants within 1e-6. Blocked sampler: the same integers, `class_prob`
within 1e-6 relative (`dispersion ** counts`: XLA's and torch's float32
pow may differ in the last bit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from model_matching_tpu import instance as jinst
from model_matching_tpu import sampling as jsamp
from model_matching_tpu_torch import convert, rng
from model_matching_tpu_torch import instance as tinst
from model_matching_tpu_torch import sampling as tsamp
from model_matching_tpu_torch.ops import base_rounds
from model_matching_tpu_torch.utils import trace
from tests.test_instance import build_easy_scene, build_scene

KW = dict(tr_disc=5, rot_disc=5, plane_threshold=0.15, min_distance_base=0.01,
          internal_angle_threshold=30.0, flood_max_iters=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _envs(make_scene, seed):
    env = make_scene(np.random.default_rng(seed))
    tenv = (convert.ppf_table(env[0]),) + tuple(
        torch.from_numpy(np.array(a)) for a in env[1:])
    return env, tenv


@pytest.fixture(scope="module")
def wall():
    return _envs(build_scene, 12345)


@pytest.fixture(scope="module")
def easy():
    return _envs(build_easy_scene, 12345)


def _same(j, t, prob_rtol=None):
    np.testing.assert_array_equal(np.asarray(j.valid), t.valid.numpy())
    np.testing.assert_array_equal(np.asarray(j.indices), t.indices.numpy())
    np.testing.assert_array_equal(np.asarray(j.fill_converged), t.fill_converged.numpy())
    np.testing.assert_array_equal(np.asarray(j.seg_masks), t.seg_masks.numpy())
    if prob_rtol is None:
        np.testing.assert_array_equal(np.asarray(j.class_prob), t.class_prob.numpy())
    else:
        np.testing.assert_allclose(t.class_prob.numpy(), np.asarray(j.class_prob),
                                   rtol=prob_rtol, atol=0)
    ok = np.asarray(j.valid)
    for a, b in ((j.invariant1, t.invariant1), (j.invariant2, t.invariant2)):
        np.testing.assert_allclose(b.numpy()[ok], np.asarray(a)[ok], rtol=0, atol=1e-6)


def _jax_seq(env, key, num_bases, dispersion=0.9, sweeps=None, bits=None):
    table, pos, nrm, prob, edge_prob, pixel, valid, edge_free = env
    return jinst.sample_instance_bases_stepwise(
        key, table, pos, nrm, jnp.array(prob), edge_prob, pixel, valid, edge_free,
        num_bases=num_bases, dispersion=dispersion, block=4, exists_bits=bits,
        flood_sweeps=sweeps, **KW)


def _torch_seq(tenv, key, num_bases, dispersion=0.9, sweeps=None, bits=None,
               fn=tinst.sample_instance_bases_stepwise, **kw):
    table, pos, nrm, prob, edge_prob, pixel, valid, edge_free = tenv
    return fn(key, table, pos, nrm, prob, edge_prob, pixel, valid, edge_free,
              num_bases=num_bases, dispersion=dispersion, exists_bits=bits,
              flood_sweeps=sweeps, **KW, **kw)


@pytest.mark.parametrize("scene,seed,sweeps", [
    ("wall", 11, None), ("wall", 5, 8), ("easy", 9, 8), ("easy", 3, 1)])
def test_sequential_sampler_equals_jax(wall, easy, scene, seed, sweeps):
    env, tenv = wall if scene == "wall" else easy
    j = _jax_seq(env, jax.random.PRNGKey(seed), 10, sweeps=sweeps)
    t = _torch_seq(tenv, rng.PRNGKey(seed), 10, sweeps=sweeps, block=4)
    _same(j, t)
    assert t.seg_masks.shape == (11, 24, 32)
    if scene == "easy":
        assert t.valid.any()
        # some point decayed, none grew
        assert (t.class_prob < tenv[3]).any() and not (t.class_prob > tenv[3]).any()


def test_one_loop_under_three_names(easy):
    """The whole-scan name and the stepper at any block size give the same
    outputs; the input prior is not written to."""
    _env, tenv = easy
    prior = tenv[3].clone()
    key = rng.PRNGKey(9)
    ref = _torch_seq(tenv, key, 10, sweeps=8, block=3)
    assert torch.equal(tenv[3], prior)
    for other in (
        _torch_seq(tenv, key, 10, sweeps=8, block=64),
        _torch_seq(tenv, key, 10, sweeps=8, fn=tinst.sample_instance_bases),
        _torch_seq(tenv, key, 10, sweeps=8, block=4),
    ):
        for a, b in zip(ref, other):
            assert torch.equal(a, b)
    # the cache was hit: a later base carries an earlier base's mask
    m = ref.seg_masks
    assert any(torch.equal(m[i], m[j]) and bool(m[i].any())
               for i in range(1, 11) for j in range(1, i))


def test_cached_id_flat_read_equals_indexing():
    """The claim read as a gather at row * W + col equals indexing the
    buffer by the seed's row and column, on random buffers and seeds,
    corners included."""
    g = np.random.default_rng(21)
    for h, w in ((24, 32), (7, 5), (120, 160)):
        buf = torch.from_numpy(g.integers(0, 100, (h, w)).astype(np.int32))
        rc = np.stack([g.integers(0, h, 40), g.integers(0, w, 40)], axis=1)
        rc = np.concatenate([rc, [[0, 0], [h - 1, w - 1], [0, w - 1], [h - 1, 0]]])
        seeds = torch.from_numpy(rc.astype(np.int32))
        got = base_rounds.cached_id(buf, seeds)
        assert got.dtype == torch.int32 and got.shape == (seeds.shape[0],)
        want = torch.stack([buf[r, c] for r, c in seeds.long()])
        assert torch.equal(got, want)
        assert torch.equal(base_rounds.cached_id(buf, seeds[:1]), buf[seeds[0, 0], seeds[0, 1]][None])


def test_cpu_sampler_captures_no_graph(easy):
    """On the CPU the sequential sampler runs every base eagerly: it
    captures and replays no CUDA graph, and counts one flood fill for each
    base whose seed was unclaimed."""
    _env, tenv = easy
    names = ("instance.graph_captures", "instance.graph_replays", "instance.flood_fills")
    before = [trace.total(k) for k in names]
    out = _torch_seq(tenv, rng.PRNGKey(9), 10, sweeps=8, block=3)
    captures, replays, fills = (trace.total(k) - b for k, b in zip(names, before))
    assert captures == 0 and replays == 0
    m = out.seg_masks
    fresh = sum(not any(torch.equal(m[i], m[j]) for j in range(1, i))
                for i in range(1, 11))
    assert fills == fresh
    assert fresh < 10          # the cache was hit: fewer fills than bases


@pytest.mark.parametrize("seed", [9, 3])
@pytest.mark.parametrize("parts", ["plain", "wrapper"])
def test_base_parts_step_by_step_equal_the_sampler(easy, seed, parts):
    """ops/base_rounds' parts, driven base by base with the flood fill or
    the cached mask between them as the sampler drives them, reproduce
    sample_instance_bases_stepwise's outputs: the plain versions, and the
    wrapper, which takes them for CPU tensors (no kernel launch counted)."""
    from model_matching_tpu_torch import flood

    _env, tenv = easy
    table, pos, nrm, prob, edge_prob, pixel, valid, edge_free = tenv
    bases, block, n = 10, 4, pos.shape[0]
    want = _torch_seq(tenv, rng.PRNGKey(seed), bases, sweeps=8, block=block)
    s = base_rounds.Rounds(
        table, pos, nrm, prob, edge_prob, pixel, valid, edge_free.shape, bases, block,
        0.9, KW["tr_disc"], KW["rot_disc"], KW["plane_threshold"],
        KW["min_distance_base"], KW["internal_angle_threshold"])
    pre, post = ((base_rounds.base_pre_reference, base_rounds.base_post_reference)
                 if parts == "plain" else (base_rounds.base_pre, base_rounds.base_post))
    keys = tinst._base_keys(rng.PRNGKey(seed), bases)
    launches = trace.total("base_rounds.launches")
    for b in range(bases):
        if b % block == 0:
            noise = rng.gumbel_rows(keys[b:b + block].reshape(-1, 2), n)
            s.noise[:noise.shape[0] // 4].copy_(noise.reshape(-1, 4, 1, n))
        pre(s)
        hit = int(s.cached_id)
        if hit:
            s.seg.copy_(s.masks[hit])
            s.fill_ok.fill_(True)
        else:
            m, conv = flood.flood_fill(s.seed_rc, edge_free, s.max_pix_dist,
                                       max_iters=KW["flood_max_iters"], fixed_sweeps=8,
                                       return_converged=True)
            s.seg.copy_(m[0])
            s.fill_ok.copy_(conv)
            s.seg_buffer.copy_(torch.where(m[0], (s.row + 1).to(torch.int32), s.seg_buffer))
        post(s)
    got = tinst._finish(pos, s.raws, s.oks, s.class_prob, s.masks, s.fills)
    for f in tinst.InstanceSamples._fields:
        assert torch.equal(getattr(want, f), getattr(got, f)), f
    assert bool(want.valid.any()) and int(s.row) == bases
    assert trace.total("base_rounds.launches") == launches


def test_exists_bits_words_and_draws(wall):
    """The bit matrix holds the JAX package's uint32 words (as int32 bit
    patterns); the masks read from it equal the hashed ones; the sampler
    draws the same bases with and without it."""
    env, tenv = wall
    jbits = jsamp.build_exists_bits(env[0], env[1], env[2], 5, 5, chunk=32)
    tbits = tsamp.build_exists_bits(tenv[0], tenv[1], tenv[2], 5, 5, chunk=32)
    assert tbits.dtype == torch.int32 and tbits.shape == (64, 2)
    np.testing.assert_array_equal(tbits.numpy().view(np.uint32), np.asarray(jbits))
    assert torch.equal(convert.exists_bits(jbits), tbits)
    assert (tbits < 0).any()          # bit 31 is in use
    anchors = torch.arange(64, dtype=torch.int32)
    hashed = tsamp._pairwise_exists(tenv[0], tenv[1], tenv[2], anchors, 5, 5)
    packed = tsamp._pairwise_exists(tenv[0], tenv[1], tenv[2], anchors, 5, 5, tbits)
    assert torch.equal(hashed, packed) and bool(hashed.any())
    a = _torch_seq(tenv, rng.PRNGKey(11), 8, block=4)
    b = _torch_seq(tenv, rng.PRNGKey(11), 8, block=4, bits=tbits)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    _same(_jax_seq(env, jax.random.PRNGKey(11), 8, bits=jbits), b)


def _blocked(env, tenv, key_seed, dispersion, num_bases, block_size, sweeps=None):
    table, pos, nrm, prob, edge_prob, pixel, valid, edge_free = env
    j = jinst.sample_instance_bases_blocked(
        jax.random.PRNGKey(key_seed), table, pos, nrm, jnp.array(prob), edge_prob,
        pixel, valid, edge_free, num_bases=num_bases, dispersion=dispersion,
        block_size=block_size, flood_sweeps=sweeps, **KW)
    table, pos, nrm, prob, edge_prob, pixel, valid, edge_free = tenv
    t = tinst.sample_instance_bases_blocked(
        rng.PRNGKey(key_seed), table, pos, nrm, prob, edge_prob, pixel, valid,
        edge_free, num_bases=num_bases, dispersion=dispersion,
        block_size=block_size, flood_sweeps=sweeps, **KW)
    return j, t


@pytest.mark.parametrize("scene,seed,bases,block,sweeps", [
    ("easy", 9, 8, 4, None), ("easy", 7, 10, 4, 8), ("wall", 7, 12, 5, None)])
def test_blocked_sampler_equals_jax(wall, easy, scene, seed, bases, block, sweeps):
    """Aligned and padded block sizes. class_prob within 1e-6 relative; the
    draws (which read log(prior) under a Gumbel argmax) equal at these
    seeds."""
    env, tenv = wall if scene == "wall" else easy
    j, t = _blocked(env, tenv, seed, 0.9, bases, block, sweeps)
    _same(j, t, prob_rtol=1e-6)
    if scene == "easy":
        assert t.valid.any()


def test_blocked_equals_sequential_without_decay(easy):
    """dispersion == 1: the blocked sampler draws the sequential sampler's
    bases (per-base keys are derived identically)."""
    _env, tenv = easy
    table, pos, nrm, prob, edge_prob, pixel, valid, edge_free = tenv
    seq = _torch_seq(tenv, rng.PRNGKey(3), 10, dispersion=1.0, block=4)
    blk = tinst.sample_instance_bases_blocked(
        rng.PRNGKey(3), table, pos, nrm, prob, edge_prob, pixel, valid, edge_free,
        num_bases=10, dispersion=1.0, block_size=4, **KW)
    assert torch.equal(seq.indices, blk.indices)
    assert torch.equal(seq.valid, blk.valid)
    assert torch.equal(seq.class_prob, blk.class_prob)

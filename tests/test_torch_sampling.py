"""Class-path base sampling and the base invariants: with equal keys the
port draws the JAX package's bases — equal indices, valid mask and round
masks — on the synthetic scene."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _synthetic_setup
from model_matching_tpu import sampling as jsamp
from model_matching_tpu.ops import invariants as jinv
from model_matching_tpu_torch import convert, rng
from model_matching_tpu_torch import sampling as tsamp
from model_matching_tpu_torch.ops import invariants as tinv


@pytest.fixture(scope="module")
def packs():
    model, scene, cfg = _synthetic_setup(num_model=200, num_scene=768)
    return model, scene, cfg, convert.model_pack(model), convert.scene_pack(scene)


def _kw(cfg):
    return dict(
        tr_disc=cfg.ppf_tr_discretization, rot_disc=cfg.ppf_rot_discretization,
        plane_threshold=cfg.plane_threshold,
        min_distance_base=cfg.min_distance_base,
        internal_angle_threshold=cfg.internal_angle_threshold,
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_class_bases_equal(packs, seed):
    model, scene, cfg, tm, ts = packs
    b = 48
    jfn = jax.jit(functools.partial(jsamp.sample_class_bases, num_bases=b, **_kw(cfg)))
    jb = jfn(jax.random.PRNGKey(seed), model.table, scene.pos, scene.normal,
             scene.class_prob, scene.valid)
    tb = tsamp.sample_class_bases(
        rng.PRNGKey(seed), tm.table, ts.pos, ts.normal, ts.class_prob,
        ts.valid, num_bases=b, **_kw(cfg))
    np.testing.assert_array_equal(np.asarray(jb.valid), tb.valid.numpy())
    assert tb.valid.sum() > b // 2
    np.testing.assert_array_equal(np.asarray(jb.indices), tb.indices.numpy())
    # invariants: same base, float32 segment solve (atol 1e-6 of a [0, 1]
    # parameter, far below any sampling or gate decision)
    np.testing.assert_allclose(np.asarray(jb.invariant1), tb.invariant1.numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(jb.invariant2), tb.invariant2.numpy(),
                               rtol=0, atol=1e-6)


def test_round_masks_equal(packs):
    """The round-2 and round-3 keep masks on given draws."""
    model, scene, cfg, tm, ts = packs
    r = np.random.default_rng(4)
    i1, i2, i3 = (r.integers(0, 768, 32).astype(np.int32) for _ in range(3))
    tr, rot = cfg.ppf_tr_discretization, cfg.ppf_rot_discretization
    j2 = jax.jit(lambda a, b: jsamp.round2_keep_mask(
        model.table, scene.pos, scene.normal, a, b, tr, rot,
        cfg.internal_angle_threshold))(i1, i2)
    t2 = tsamp.round2_keep_mask(tm.table, ts.pos, ts.normal, torch.from_numpy(i1),
                                torch.from_numpy(i2), tr, rot,
                                cfg.internal_angle_threshold)
    np.testing.assert_array_equal(np.asarray(j2), t2.numpy())
    j3 = jax.jit(lambda a, b, c: jsamp.round3_keep_mask(
        model.table, scene.pos, scene.normal, a, b, c, tr, rot,
        cfg.plane_threshold, cfg.min_distance_base))(i1, i2, i3)
    t3 = tsamp.round3_keep_mask(tm.table, ts.pos, ts.normal, torch.from_numpy(i1),
                                torch.from_numpy(i2), torch.from_numpy(i3), tr,
                                rot, cfg.plane_threshold, cfg.min_distance_base)
    np.testing.assert_array_equal(np.asarray(j3), t3.numpy())
    assert np.asarray(j2).any() and np.asarray(j3).any()


def test_reorder_base_equal():
    r = np.random.default_rng(5)
    base = r.uniform(-0.1, 0.1, (500, 4, 3)).astype(np.float32)
    base[::10, 3] = base[::10, 2]  # degenerate segments
    jp, j1, j2, jd = jax.jit(jinv.reorder_base)(jnp.asarray(base))
    tp, t1, t2, td = tinv.reorder_base(torch.from_numpy(base))
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    for a, b in ((j1, t1), (j2, t2), (jd, td)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 3])
def test_sample_class_bases_through_exists_bits(packs, seed):
    """With the bit-packed existence matrix (768 lanes = 3 row blocks of
    256) the sampler draws what it draws by hashing, and what the JAX
    package draws through its matrix; the words are equal."""
    model, scene, cfg, tm, ts = packs
    tr, rot = cfg.ppf_tr_discretization, cfg.ppf_rot_discretization
    jbits = jax.jit(lambda p, n: jsamp.build_exists_bits(model.table, p, n, tr, rot))(
        scene.pos, scene.normal)
    tbits = tsamp.build_exists_bits(tm.table, ts.pos, ts.normal, tr, rot)
    assert tbits.shape == (768, 24) and tbits.dtype == torch.int32
    np.testing.assert_array_equal(tbits.numpy().view(np.uint32), np.asarray(jbits))
    assert torch.equal(convert.exists_bits(jbits), tbits)
    b = 48
    args = (tm.table, ts.pos, ts.normal, ts.class_prob, ts.valid)
    hashed = tsamp.sample_class_bases(rng.PRNGKey(seed), *args, num_bases=b, **_kw(cfg))
    packed = tsamp.sample_class_bases(rng.PRNGKey(seed), *args, num_bases=b,
                                      exists_bits=tbits, **_kw(cfg))
    for x, y in zip(hashed, packed):
        assert torch.equal(x, y)
    jfn = jax.jit(functools.partial(jsamp.sample_class_bases, num_bases=b, **_kw(cfg)))
    jb = jfn(jax.random.PRNGKey(seed), model.table, scene.pos, scene.normal,
             scene.class_prob, scene.valid, exists_bits=jbits)
    np.testing.assert_array_equal(np.asarray(jb.indices), packed.indices.numpy())
    np.testing.assert_array_equal(np.asarray(jb.valid), packed.valid.numpy())


def test_estimator_builds_the_bits_from_512_bases(packs, monkeypatch):
    """StocsEstimator.run hands the sampler the bit matrix from 512 bases
    up and nothing below; the matrix is built once, at first use."""
    import dataclasses

    from model_matching_tpu_torch import estimator as port

    _model, _scene, cfg, tm, ts = packs
    seen = []

    class Stop(Exception):
        pass

    def spy(*args, exists_bits=None, **kw):
        seen.append(exists_bits)
        raise Stop

    monkeypatch.setattr(port.sampling, "sample_class_bases", spy)
    for bases in (511, 512):
        est = port.StocsEstimator(tm, ts, dataclasses.replace(cfg, number_of_bases=bases))
        with pytest.raises(Stop):
            est.run(verbose=False)
    assert seen[0] is None and seen[1] is est._exists_bits is est.exists_bits()
    assert seen[1].shape == (768, 24)

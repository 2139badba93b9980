"""Scene ingest of the port against the JAX package, on the CPU.

Inputs: the synthetic RGB-D scene of model_matching_tpu_torch.synthetic at
160x120 (the ycb camera scaled by 1/4), made from a seed with numpy, fed to
both packages: ops/geometry, ops/voxel and ops/normals one by one (the JAX
functions jitted, as its scene program runs them, or op by op, as its
model preprocessing runs them), then the whole `load_scene` on the same
PNG files.

Tolerances: integer outputs (voxel partition, masks, pixels, outlier
keep-mask) equal; voxel centroids, back-projected points, class
probabilities, normals (PCA and depth-image), the scene centroid and the
centred positions bit-equal (the port follows the JAX package's rounding:
ops/fp.py, the float32 eigen-solve with ops/fmath.py's acos and cos, and
XLA's reduction order for the centroid, fp.xla_sum0). Pixels at reprojection knife-edges
may differ; the test counts them and bounds them at 0.5% of the points
(0 measured)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from model_matching_tpu import scene as jscene
from model_matching_tpu.config import CameraIntrinsics as JCam
from model_matching_tpu.config import get_preset as jpreset
from model_matching_tpu.ops import geometry as jgeo, normals as jnrm, voxel as jvox
from model_matching_tpu_torch import convert, scene as tscene
from model_matching_tpu_torch.ops import geometry as tgeo, normals as tnrm, voxel as tvox
from model_matching_tpu_torch.ops.densefield import build_dense_field
from model_matching_tpu_torch.ops.gridhash import build_neighbor_grid
from model_matching_tpu_torch.synthetic import synthetic_rgbd, write_synthetic_scene

SCALE = 0.25


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: under several test workers
    on one machine, torch's worker threads contend for the cores and the
    many small ops of these tests ran 10-100x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frame():
    from model_matching_tpu_torch.config import get_preset

    cam = tuple(v * SCALE for v in get_preset("ycb").match.camera.as_tuple())
    rgb, depth, prob, _gt = synthetic_rgbd(cam, 160, 120, seed=4)
    jcfg = dataclasses.replace(jpreset("ycb").match, camera=JCam(*cam))
    return cam, rgb, depth, prob, jcfg


@pytest.fixture(scope="module")
def cloud(frame):
    """Back-projected points and the voxel step, from the JAX package."""
    cam, _rgb, depth, _prob, jcfg = frame
    d = depth.astype(np.float32) * np.float32(jcfg.depth_scale)
    pts = np.asarray(jax.jit(lambda z: jgeo.backproject_depth(z, *cam))(jnp.asarray(d)))
    pos = pts.reshape(-1, 3)
    valid = (d > 0).reshape(-1)
    return d, pts, pos, valid


def _t(a):
    return torch.from_numpy(np.array(a))


def test_backproject_and_project_bit_equal(frame, cloud):
    cam, *_ = frame
    d, pts, _pos, _valid = cloud
    np.testing.assert_array_equal(tgeo.backproject_depth(_t(d), *cam).numpy(), pts)
    p = pts.reshape(-1, 3)
    jp = np.asarray(jax.jit(lambda q: jgeo.project_points(q, *cam))(jnp.asarray(p)))
    np.testing.assert_array_equal(tgeo.project_points(_t(p), *cam).numpy(), jp)


def test_voxel_centroid_partition_and_attrs(frame, cloud):
    _cam, _rgb, _depth, _prob, jcfg = frame
    _d, _pts, pos, valid = cloud
    rng = np.random.default_rng(2)
    attr = rng.normal(size=(pos.shape[0], 3)).astype(np.float32)
    attr[::97] = np.nan                       # NaN poisons its voxel's mean
    jp, jv, ja = jax.jit(lambda p, v, a: jvox.voxel_downsample_centroid(
        p, v, jcfg.voxel_size, attrs={"a": a}))(jnp.asarray(pos), jnp.asarray(valid),
                                                jnp.asarray(attr))
    tp, tv, ta = tvox.voxel_downsample_centroid(_t(pos), _t(valid), jcfg.voxel_size,
                                                attrs={"a": _t(attr)})
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert int(tv.sum()) > 5000
    # centroids: within 1e-6 m asked, bit-equal delivered
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ta["a"].numpy()[tv.numpy()], np.asarray(ja["a"])[tv.numpy()])
    jf = np.asarray(jvox.voxel_downsample_first(jnp.asarray(pos), jnp.asarray(valid),
                                                jcfg.voxel_size))
    np.testing.assert_array_equal(
        tvox.voxel_downsample_first(_t(pos), _t(valid), jcfg.voxel_size).numpy(), jf)


@pytest.fixture(scope="module")
def voxels(frame, cloud):
    _cam, _rgb, _depth, _prob, jcfg = frame
    _d, _pts, pos, valid = cloud
    vp, vv, _ = jax.jit(lambda p, v: jvox.voxel_downsample_centroid(
        p, v, jcfg.voxel_size))(jnp.asarray(pos), jnp.asarray(valid))
    return np.asarray(vp), np.asarray(vv)


def test_outlier_mask_equal(frame, voxels):
    jcfg = frame[4]
    vp, vv = voxels
    radius = 2.0 * jcfg.voxel_size + jcfg.outlier_radius_bias
    want = np.asarray(jax.jit(lambda p, v: jvox.radius_outlier_mask(
        p, v, radius, jcfg.outlier_min_neighbors))(jnp.asarray(vp), jnp.asarray(vv)))
    got = tvox.radius_outlier_mask(_t(vp), _t(vv), radius, jcfg.outlier_min_neighbors)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < int((vv & ~want).sum()) or want.sum() > 0


@pytest.mark.parametrize("fused", [True, False])
def test_grid_pca_normals(frame, voxels, fused):
    """fused=True against the jitted JAX function (its scene program),
    fused=False against the op-by-op call (its model preprocessing)."""
    jcfg = frame[4]
    vp, vv = voxels
    radius = jcfg.scene_normal_radius_factor * jcfg.voxel_size
    fn = lambda p, v: jnrm.grid_pca_normals(p, v, radius)  # noqa: E731
    jn, jok = (jax.jit(fn) if fused else fn)(jnp.asarray(vp), jnp.asarray(vv))
    tn, tok = tnrm.grid_pca_normals(_t(vp), _t(vv), radius, fused=fused)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert int(tok.sum()) > 5000
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_depth_normals(frame):
    cam, _rgb, depth, _prob, _jcfg = frame
    z = depth.astype(np.float32)
    jn, jok = jax.jit(lambda d: jnrm.depth_normals(d, *cam))(jnp.asarray(z))
    tn, tok = tnrm.depth_normals(_t(z), *cam)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert int(tok.sum()) > 10000
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_eigenvector_and_neighbor_normals(voxels):
    vp, vv = voxels
    pts = vp[vv][:600].astype(np.float32)
    idx, cnt = tnrm.radius_neighbor_indices(pts, 0.012, 16)
    jidx, jcnt = jnrm.radius_neighbor_indices(pts, 0.012, 16)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(cnt, jcnt)
    for outward in (True, False):
        want = np.asarray(jax.jit(jnrm.pca_normals_from_neighbors, static_argnums=3)(
            jnp.asarray(pts), jnp.asarray(idx), jnp.asarray(cnt), outward))
        got = tnrm.pca_normals_from_neighbors(_t(pts), _t(idx), _t(cnt), outward).numpy()
        # the port sums the moments in the compiled program's order with its
        # fused multiply-adds, so every normal is the JAX package's bits
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert (~np.isnan(want)).all(1).sum() > 500
        np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(9)
    a = rng.normal(size=(200, 3, 3))
    cov = (a @ np.swapaxes(a, 1, 2)).astype(np.float32)
    want = np.asarray(jax.jit(jnrm.smallest_eigenvector_3x3)(jnp.asarray(cov)))
    got = tnrm.smallest_eigenvector_3x3(_t(cov)).numpy()
    # the port repeats the JAX package's float32 solve with its rounding
    np.testing.assert_array_equal(got, want)
    # and so is as far from LAPACK's float64 eigenvector as the JAX package
    # (1e-4 on the worst-conditioned of these random matrices)
    _w, vecs = np.linalg.eigh(cov.astype(np.float64))
    exact = vecs[:, :, 0]
    sign = np.sign((got * exact).sum(1, keepdims=True))
    np.testing.assert_allclose(got * sign, exact, rtol=0, atol=1e-3)


def test_prefix_shortcut_changes_no_output(frame):
    """The steps after the voxel downsample run on its valid prefix: the
    outputs equal those of the run over all H*W lanes, bit for bit."""
    cam, rgb, depth, prob, _jcfg = frame
    from model_matching_tpu_torch.config import CameraIntrinsics, get_preset

    for mode in ("cloud_pca", "depth"):
        cfg = dataclasses.replace(get_preset("ycb").match,
                                  camera=CameraIntrinsics(*cam), scene_normal_mode=mode)
        args = (_t(rgb), _t(depth.astype(np.int32)), _t(prob[None].astype(np.int32)),
                _t(np.zeros(depth.shape, np.uint8)), cfg)
        short = tscene._scene_pipeline(*args, prefix=True)
        full = tscene._scene_pipeline(*args, prefix=False)
        for k in full:
            assert torch.equal(short[k], full[k]), (mode, k)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Both packages' load_scene on the same PNG files."""
    root = str(tmp_path_factory.mktemp("ingest"))
    scene_dir, tcfg, _gt = write_synthetic_scene(root, scale=SCALE, seed=4)
    jcfg = dataclasses.replace(jpreset("ycb").match,
                               camera=JCam(*tcfg.camera.as_tuple()))
    paths = (os.path.join(scene_dir, "rgb.png"), os.path.join(scene_dir, "depth.png"),
             os.path.join(scene_dir, "probability_maps", "synthetic_shell.png"))
    js = jscene.load_scene(*paths, None, jcfg)
    ts = tscene.load_scene(*paths, None, tcfg, device="cpu")
    return js, ts, tcfg, paths


def test_load_scene_against_jax(scenes):
    js, ts, _cfg, _paths = scenes
    jv = np.asarray(js.valid)
    tv = ts.valid.numpy()
    assert int(ts.count()) == int(js.count()) > 3000
    np.testing.assert_array_equal(tv, jv)
    jpix, tpix = np.asarray(js.pixel)[jv], ts.pixel.numpy()[tv]
    flips = int((jpix != tpix).any(1).sum())
    assert flips <= 0.005 * jv.sum(), f"{flips} knife-edge pixels"
    np.testing.assert_array_equal(ts.class_prob.numpy(), np.asarray(js.class_prob))
    np.testing.assert_array_equal(ts.edge_prob.numpy(), np.asarray(js.edge_prob))
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    np.testing.assert_array_equal(ts.centroid.numpy(), np.asarray(js.centroid))
    np.testing.assert_array_equal(ts.normal.numpy(), np.asarray(js.normal))
    ok = (jpix == tpix).all(1)
    np.testing.assert_array_equal(ts.rgb.numpy()[tv][ok], np.asarray(js.rgb)[jv][ok])
    assert not ts.has_edge and not bool(js.has_edge)
    np.testing.assert_array_equal(ts.edge_free.numpy(), np.asarray(js.edge_free))


def test_scene_structures_equal_on_equal_inputs(scenes):
    """The port's host builders on the JAX package's ingested arrays give
    the JAX package's grid, field and ICP grid; on the port's own arrays
    the same integer layout with rows within 1e-6."""
    js, ts, cfg, _paths = scenes
    jv = np.asarray(js.valid)
    pos = np.asarray(js.pos)[jv]
    nrm = np.asarray(js.normal)[jv]
    prob = np.asarray(js.class_prob)[jv]
    ref = convert.scene_pack(js)
    built = dict(
        grid=build_neighbor_grid(pos, cfg.distance_threshold, normal=nrm, prob=prob),
        field=build_dense_field(pos, nrm, cfg.distance_threshold, prob=prob),
        icp_grid=build_neighbor_grid(pos, cfg.icp_max_corr_dist))
    for name, got in built.items():
        want = getattr(ref, name)
        own = getattr(ts, name)
        for f in dataclasses.fields(want):
            a, b, c = getattr(got, f.name), getattr(want, f.name), getattr(own, f.name)
            if isinstance(b, torch.Tensor):
                assert torch.equal(a, b), (name, f.name)
                if b.dtype.is_floating_point:
                    assert torch.allclose(c, b, rtol=0, atol=1e-6), (name, f.name)
                else:
                    assert torch.equal(c, b), (name, f.name)
            else:
                assert a == b == c, (name, f.name)


def test_scene_build_reads_only_sizes(scenes):
    """load_scene builds the grids and the field where the ingested lanes
    are: the scene is not read back, only sizes (at most 8 values a read),
    every read counted with its bytes, and `scene.build_copy_bytes` counts
    what the build's reads moved (a few hundred bytes; the read-back of
    the lanes was ~0.5 MB at this size)."""
    from model_matching_tpu_torch.utils import trace

    _js, ts, cfg, paths = scenes
    mark = trace.mark()
    sc = tscene.load_scene(*paths, None, cfg, device="cpu")
    entries = trace.snapshot(mark).entries
    spans = {e.name: e for e in entries if e.kind == "span"}
    build = spans["scene.build"].seq

    def counts(name, parent=None):
        return [e.n for e in entries if e.kind == "count" and e.name == name
                and parent in (None, e.parent)]

    sizes = counts("host_read_bytes")
    assert max(sizes) <= 8 * 8
    assert 1 <= len(counts("host_reads", build)) == len(counts("host_read_bytes", build)) <= 16
    assert counts("scene.build_copy_bytes") == [sum(counts("host_read_bytes", build))]
    assert 0 < sum(counts("host_read_bytes", build)) < 2048
    for name in ("grid", "field", "icp_grid"):
        a, b = getattr(sc, name), getattr(ts, name)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y


def test_edge_map_marks_the_instance_path(scenes, tmp_path):
    """A scene with an edge map loads as has_edge, and the estimator takes
    the instance path on it (flood-fill segments, the prior decayed),
    not the class path. An all-free map bounds the fills by the pixel
    radius only; edge pixels carry edge probability 1."""
    from model_matching_tpu_torch.estimator import StocsEstimator
    from model_matching_tpu_torch.io import image
    from model_matching_tpu_torch.synthetic import synthetic_setup

    _js, ts, cfg, paths = scenes
    edge = str(tmp_path / "edge.png")
    image.write_u8(edge, np.full((120, 160), 255, np.uint8))
    sc = tscene.load_scene(*paths, edge, cfg, device="cpu")
    assert sc.has_edge and bool(sc.edge_free.all())
    assert not ts.has_edge and bool((sc.edge_prob == 0).all())
    model, _scene, _cfg = synthetic_setup(device="cpu")
    small = dataclasses.replace(cfg, number_of_bases=3, max_pairs_per_bin=256,
                                maximum_congruent_sets=16)
    est = StocsEstimator(model, sc, small)
    res = est.run(verbose=False)
    assert est.seg_masks.shape == (4, 120, 160) and bool(est.seg_masks[1].any())
    assert est.class_prob is not sc.class_prob
    assert bool((est.class_prob < sc.class_prob).any())
    assert res.stats["unconverged_fills"] == 0 and "sample_bases" in res.timings
    # a map with an edge line: the points on it are pruned from sampling
    lined = np.full((120, 160), 255, np.uint8)
    lined[60, :] = 0
    image.write_u8(edge, lined)
    sc = tscene.load_scene(*paths, edge, cfg, device="cpu")
    on_line = sc.valid & (sc.pixel[:, 0] == 60)
    assert int(on_line.sum()) > 0 and bool((sc.edge_prob[on_line] == 1.0).all())
    assert not bool(sc.edge_free[60].any()) and bool(sc.edge_free[59].all())


def test_cuda_default_needs_a_card(scenes):
    _js, _ts, cfg, paths = scenes
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tscene.load_scene(*paths, None, cfg)

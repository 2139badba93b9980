"""Multi-object matching of the port against the JAX package, on the CPU.

Inputs: the two-object world of tests/test_multi.py (two half-ellipsoid
shells of 280 and 260 points posed over 600 clutter points, 64 sets, 2,048
pairs per bin, made from a seed with numpy; 16 bases here instead of its 48,
to keep the CPU time down) and its edge-mapped variant, handed to both
packages as the same packs (convert.py), and the three-object 160x120 RGB-D
scene of synthetic.write_synthetic_multi_scene.

Required: `align_models` gives the JAX package's arrays exactly, and packs
that already share one shape their own arrays;
`match_all_objects` gives its hypothesis counts, best LCP within 1e-5 and
poses within 1e-4 on the class and the edge path; an object alone equals
its row of a two-object call bit for bit, and zeroing the other object's
prior leaves a row unchanged; `load_scene_multi` gives the JAX package's
valid mask and probabilities exactly, positions within 1e-6 m and normals
within 1e-5 (the tolerances of tests/test_torch_ingest.py)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from model_matching_tpu import multi as jmulti
from model_matching_tpu import scene as jscene
from model_matching_tpu.config import CameraIntrinsics as JCam
from model_matching_tpu.config import get_preset as jpreset
from model_matching_tpu_torch import convert
from model_matching_tpu_torch import multi as tmulti
from model_matching_tpu_torch import scene as tscene
from model_matching_tpu_torch.config import MatchConfig as TConfig
from model_matching_tpu_torch.synthetic import MULTI_SHELLS, write_synthetic_multi_scene
from tests.test_multi import build_two_object_world


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs (several test workers share
    the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcfg(jcfg):
    return TConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
                      if f.name != "camera"})


def _edge_variant(w):
    """tests/test_multi.py::two_object_edge_world: a pixel layout with an
    edge wall down the middle column."""
    import jax.numpy as jnp

    w = dict(w)
    rng = np.random.default_rng(31)
    h, wd = 24, 32
    cap = w["scene"].pos.shape[0]
    pix = np.stack([rng.integers(0, h, cap), rng.integers(0, wd, cap)], axis=-1).astype(np.int32)
    edge_free = np.ones((h, wd), bool)
    edge_free[:, wd // 2] = False
    w["scene"] = dataclasses.replace(
        w["scene"], pixel=jnp.asarray(pix),
        edge_prob=jnp.asarray((pix[:, 1] == wd // 2).astype(np.float32)),
        edge_free=jnp.asarray(edge_free), has_edge=True)
    return w


@pytest.fixture(scope="module")
def worlds():
    """Per path: the JAX world, the port's packs, and both packages'
    match_all_objects on it."""
    out = {}
    base = build_two_object_world()
    base["cfg"] = dataclasses.replace(base["cfg"], number_of_bases=16)
    for path, w in (("class", base), ("edge", _edge_variant(base))):
        packs = [convert.model_pack(p) for p in w["packs"]]
        scene = convert.scene_pack(w["scene"])
        cfg = _tcfg(w["cfg"])
        jres = [np.asarray(a) for a in jmulti.match_all_objects(
            w["packs"], w["scene"], w["probs"], w["cfg"], seed=0)]
        tres = tmulti.match_all_objects(packs, scene, w["probs"], cfg, seed=0)
        out[path] = dict(w=w, packs=packs, scene=scene, cfg=cfg, jax=jres, torch=tres)
    return out


def test_align_models_equals_jax(worlds):
    w = worlds["class"]
    jal = jmulti.align_models(w["w"]["packs"])
    tal = tmulti.align_models(w["packs"])
    assert len(tal) == len(jal) == 2
    for j, t in zip(jal, tal):
        for f in ("pos", "normal", "rgb", "valid", "centroid", "pair_ep"):
            np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                          err_msg=f)
        for f in ("exist_keys", "bin_keys", "bin_offset", "bin_count", "pairs",
                  "bin_direct"):
            np.testing.assert_array_equal(getattr(t.table, f).numpy(),
                                          np.asarray(getattr(j.table, f)), err_msg=f)
        np.testing.assert_array_equal(t.table.exist_direct.numpy(),
                                      np.asarray(j.table.exist_direct).astype(np.int64))
        for f in ("exist_max_probes", "bin_max_probes", "tr_disc", "rot_disc"):
            assert getattr(t.table, f) == getattr(j.table, f), f
    # one shape for every object
    assert tal[0].table.pairs.shape == tal[1].table.pairs.shape
    assert tal[0].pos.shape == tal[1].pos.shape


def test_align_models_same_shapes_equals_rebuild():
    """Three packs that already share one shape (tables rebuilt at common
    sizes, probe bounds bucketed up as standardize=True leaves them) come
    back with their own arrays and the rebuilt, tighter probe bounds."""
    from model_matching_tpu_torch.model import ModelPack, build_pair_ep
    from model_matching_tpu_torch.ppf_table import build_ppf_table, resize_table
    from model_matching_tpu_torch.synthetic import synthetic_arrays

    tables, clouds = [], []
    for seed in (6, 7, 8):
        mpos, mnrm, *_ = synthetic_arrays(200, 300, seed=seed)
        tables.append(build_ppf_table(mpos, mnrm, 5, 5)[0])
        clouds.append(torch.from_numpy(np.concatenate([mpos, np.zeros((56, 3), np.float32)])))
    sizes = [max(getattr(t, f).shape[0] for t in tables)
             for f in ("exist_keys", "bin_keys", "pairs", "bin_direct")]
    rebuilt = [resize_table(t, *sizes[:3], direct_size=sizes[3]) for t in tables]
    packs = [ModelPack(pos=pos, normal=pos, rgb=pos, valid=torch.arange(256) < 200,
                       centroid=torch.zeros(3), pair_ep=build_pair_ep(pos, t.pairs),
                       table=dataclasses.replace(t, exist_max_probes=16, bin_max_probes=16))
             for pos, t in zip(clouds, rebuilt)]
    aligned = tmulti.align_models(packs)
    for a, p in zip(aligned, packs):
        for f in ("pos", "normal", "rgb", "valid", "centroid", "pair_ep"):
            assert torch.equal(getattr(a, f), getattr(p, f)), f
        for f in ("exist_keys", "bin_keys", "bin_offset", "bin_count", "pairs",
                  "bin_direct", "exist_direct"):
            assert torch.equal(getattr(a.table, f), getattr(p.table, f)), f
        assert a.table.exist_max_probes == max(r.exist_max_probes for r in rebuilt) < 16
        assert a.table.bin_max_probes == max(r.bin_max_probes for r in rebuilt) < 16


@pytest.mark.parametrize("path", ["class", "edge"])
def test_match_all_objects_equals_jax(worlds, path):
    w = worlds[path]
    (jb, jp, jn), (tb, tp, tn) = w["jax"], w["torch"]
    assert tb.shape == (2,) and tp.shape == (2, 4, 4) and tn.dtype == np.int32
    np.testing.assert_array_equal(tn, jn)
    assert (tn > 5).all()
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-5)
    assert (tb > (0.35 if path == "class" else 0.05)).all(), tb
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-4)
    # and the poses are right: each model lands on its ground truth
    for o, (m, g) in enumerate(zip(w["w"]["models"], w["w"]["gts"])):
        moved = m @ tp[o, :3, :3].T + tp[o, :3, 3]
        gt_pts = m @ g[:3, :3].T + g[:3, 3]
        d = np.linalg.norm(moved[:, None] - gt_pts[None], axis=-1).min(1)
        assert np.median(d) < 1.5 * w["cfg"].distance_threshold, (o, np.median(d))


@pytest.mark.parametrize("path", ["class", "edge"])
def test_object_results_do_not_depend_on_the_batch(worlds, path):
    """Object 0 alone equals row 0 of the two-object call, and each row is
    unchanged when the other object's prior is zeroed (that object then
    finds no valid base), bit for bit."""
    w = worlds[path]
    tb, tp, tn = w["torch"]
    probs = np.asarray(w["w"]["probs"])
    b0, p0, n0 = tmulti.match_all_objects(w["packs"][:1], w["scene"], probs[:1],
                                          w["cfg"], seed=0)
    assert b0[0] == tb[0] and n0[0] == tn[0]
    np.testing.assert_array_equal(p0[0], tp[0])
    solo = np.zeros_like(probs)
    solo[1] = probs[1]
    bs, ps, ns = tmulti.match_all_objects(w["packs"], w["scene"], solo, w["cfg"], seed=0)
    assert bs[1] == tb[1] and ns[1] == tn[1] and ns[0] == 0 and bs[0] == 0
    np.testing.assert_array_equal(ps[1], tp[1])


@pytest.fixture(scope="module")
def three_object_scenes(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("multi_scene"))
    scene_dir, tcfg, gts = write_synthetic_multi_scene(root, scale=0.25, edge=True)
    jcfg = dataclasses.replace(jpreset("ycb").match, camera=JCam(*tcfg.camera.as_tuple()))
    maps = os.path.join(scene_dir, "probability_maps")
    args = (os.path.join(scene_dir, "rgb.png"), os.path.join(scene_dir, "depth.png"),
            [os.path.join(maps, f"{name}.png") for name, *_ in MULTI_SHELLS],
            os.path.join(maps, "edge.png"))
    return jscene.load_scene_multi(*args, jcfg), tscene.load_scene_multi(*args, tcfg,
                                                                         device="cpu")


def test_load_scene_multi_equals_jax(three_object_scenes):
    (js, jprobs), (ts, tprobs) = three_object_scenes
    jv, tv = np.asarray(js.valid), ts.valid.numpy()
    np.testing.assert_array_equal(tv, jv)
    assert tprobs.shape == (3, tv.shape[0])
    np.testing.assert_array_equal(tprobs.numpy(), np.asarray(jprobs))
    # every object owns some points: 0.9 on its own pixels
    assert all(int((tprobs[o] > 0.5).sum()) > 50 for o in range(3))
    np.testing.assert_array_equal(ts.class_prob.numpy(), np.asarray(js.class_prob))
    np.testing.assert_array_equal(ts.edge_prob.numpy(), np.asarray(js.edge_prob))
    np.testing.assert_array_equal(ts.edge_free.numpy(), np.asarray(js.edge_free))
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.normal.numpy(), np.asarray(js.normal), rtol=0, atol=1e-5)
    assert ts.has_edge and bool(js.has_edge)
    # several maps: no probabilities baked into the scoring structures
    assert not ts.field.has_probs and not ts.grid.has_probs


@pytest.fixture(scope="module")
def three_objects(worlds):
    """Per path: three objects (the first shell's pack and prior again as
    object 2), 8 bases an object, and the call without a mesh."""
    out = {}
    for path, w in worlds.items():
        probs = np.asarray(w["w"]["probs"])
        packs = w["packs"] + w["packs"][:1]
        probs = np.concatenate([probs, probs[:1]])
        cfg = dataclasses.replace(w["cfg"], number_of_bases=8)
        out[path] = (packs, probs, cfg,
                     tmulti.match_all_objects(packs, w["scene"], probs, cfg, seed=0))
    return out


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("path", ["class", "edge"])
def test_mesh_equals_no_mesh(worlds, three_objects, path, ranks):
    """match_all_objects over a mesh of 2 or 4 ranks on the CPU (three
    objects padded to 4 with a zero-probability replica of the last, in
    blocks of 2 or 1 a rank) equals the call without a mesh bit for bit."""
    from model_matching_tpu_torch.parallel.sharding import make_mesh

    packs, probs, cfg, ref = three_objects[path]
    got = tmulti.match_all_objects(packs, worlds[path]["scene"], probs, cfg, seed=0,
                                   mesh=make_mesh(["cpu"] * ranks))
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert (ref[2] > 0).all() and ref[0].shape == (3,)

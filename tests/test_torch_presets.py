"""The `packed` and `linemod` presets end to end on the CPU, the port
against the JAX package: both packages' `model-preprocess --preset <p>` and
`stocs-single --preset <p>` on the same synthetic files.

Packed: the bin-of-boxes scene of synthetic.write_synthetic_packed_scene
(eight copies of one flat-faced box with an edge map along their
boundaries: the instance path) at 160x120 (`scale=0.25`, the preset's
camera scaled with it). The preset's caps are cut in both packages as
tests/test_torch_cli.py cuts the ycb preset, so that the CPU runs take
seconds: max_pairs_per_bin 8,192 with congruent_band_min_cap 8,192 keeps
the top tier banded, at P = Q = 8,704 lanes in two Q chunks of 4,352 (the
full preset's top tier is 24,576 pairs, 26,112 lanes, six chunks); 16
bases. The box's coplanar PPF bins hold up to ~19,000 pairs, so bases on a
face fill that tier and saturate it (pair lists truncated at the cap and a
nonzero `selection_shortfall`, as on the packed fixture). Block size 1
(the sequential sampler) and 8 (the block sampler, the default dispersion
0.9, so that a point's decay exponent reaches 2 inside a block and the
decay goes through fmath.pow).

Required: the port's dense gate ran the top tier with a `live` mask that
has dead tiles, and the densest bin union of a base held more than the
full preset's 16,384-pair tier; the JAX command's best index; its instance bases, segment
masks and decayed prior bit for bit; its congruent totals per base and
`selection_shortfall`; its pose and LCP within 1e-4 (the tolerance of
test_torch_cli.py's instance-path test: ICP's solve); the pose on one of
the boxes.

Linemod: the shell of synthetic.write_synthetic_scene written in
millimetres (the source PLY) at the linemod preset's depth scale (1/1000),
160x120, the class path, with the small configuration of
tests/test_torch_cli.py (1 cm scene voxel, 4,096 points, 2,048 pairs per
bin, 64 sets, 16 bases). Required: `model-preprocess --preset linemod`
(10 mm voxels, 5 mm normal radius, model_scale 1/1000) gives the JAX
package's points, normals and PPF keys bit for bit, in metres; stocs-single
picks the JAX command's best index with a pose within 1e-4 on the ground
truth."""

import contextlib
import dataclasses
import io
import os
import re

import numpy as np
import pytest
import torch

from model_matching_tpu import cli as jcli
from model_matching_tpu import config as jconfig
from model_matching_tpu import estimator as jest
from model_matching_tpu_torch import cli as tcli
from model_matching_tpu_torch import config as tconfig
from model_matching_tpu_torch import congruent as tcong
from model_matching_tpu_torch import estimator as test_mod
from model_matching_tpu_torch.ops import fmath
from model_matching_tpu_torch.synthetic import write_synthetic_packed_scene, write_synthetic_scene

BOX = "packed_box"
SHELL = "lm_shell"
BASES = "16"
PACKED_CAPS = dict(max_pairs_per_bin=8192, congruent_band_min_cap=8192)
LINEMOD_SMALL = dict(voxel_size=0.01, max_scene_points=4096, max_pairs_per_bin=2048,
                     maximum_congruent_sets=64)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads while this module runs (several test workers share
    the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _captured(cli, argv):
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = cli.main(argv)
    print(text.getvalue())
    assert rc == 0, argv
    return text.getvalue()


def _patched_presets(mp, cfg, **match):
    """Both packages' get_preset at the scaled camera of `cfg` with `match`
    replaced in every preset's MatchConfig."""
    for mod in (jconfig, tconfig):
        real = mod.get_preset

        def get(name, real=real, mod=mod):
            p = real(name)
            return dataclasses.replace(p, match=dataclasses.replace(
                p.match, camera=mod.CameraIntrinsics(*cfg.camera.as_tuple()),
                image_width=cfg.image_width, image_height=cfg.image_height, **match))

        mp.setattr(mod, "get_preset", get)


def _recorders(mp, out):
    """Record what each package's estimator sampled and extracted, and the
    port's dense-gate launches and decay exponents."""
    for name, mod in (("jax", jest), ("torch", test_mod)):
        rec = out.setdefault(name, {"inst": [], "sets": []})
        real_s, real_c = mod._phase_sample_instance, mod._run_congruent

        def sample(*a, real=real_s, rec=rec, **kw):
            res = real(*a, **kw)
            rec["inst"].append(res)
            return res

        def congruent(*a, real=real_c, rec=rec, **kw):
            res = real(*a, **kw)
            rec["sets"].append(res)
            return res

        mp.setattr(mod, "_phase_sample_instance", sample)
        mp.setattr(mod, "_run_congruent", congruent)
    real_gate, real_pow = tcong.dense_gate, fmath.pow

    def gate(*a, **kw):
        live = kw.get("live")
        out["gates"].append((tuple(a[0].shape), None if live is None else live.clone()))
        return real_gate(*a, **kw)

    def power(x, y):
        out["exponents"].append(float(torch.as_tensor(y).max()))
        return real_pow(x, y)

    mp.setattr(tcong, "dense_gate", gate)
    mp.setattr(fmath, "pow", power)


def _pose(path):
    vals = np.loadtxt(path)
    assert vals.shape == (12,)
    return vals.reshape(3, 4)


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """Both packages' model-preprocess and stocs-single --preset packed on
    the 160x120 bin of boxes, at block size 1 and 8."""
    root = str(tmp_path_factory.mktemp("packed"))
    scene_dir, cfg, boxes = write_synthetic_packed_scene(root, BOX, scale=0.25)
    runs = {}
    for blk in (1, 8):
        out = {"gates": [], "exponents": []}
        with pytest.MonkeyPatch.context() as mp:
            _patched_presets(mp, cfg, instance_block_size=blk, **PACKED_CAPS)
            _recorders(mp, out)
            for name, cli, extra in (("jax", jcli, []), ("torch", tcli, ["--device", "cpu"])):
                dst = os.path.join(root, f"out_{name}")
                common = ["--repo-path", root, "--preset", "packed", "--output-root", dst]
                if blk == 1:
                    _captured(cli, ["model-preprocess", BOX, *common, *extra])
                text = _captured(cli, ["stocs-single", scene_dir, BOX, *common,
                                       "--number-of-bases", BASES, *extra])
                pose = _pose(os.path.join(dst, "scene", f"best_pose_candidate_{BOX}.txt"))
                out[name].update(text=text, pose=pose)
        runs[blk] = out
    return root, cfg, boxes, runs


def _printed(text):
    index = int(re.search(r"best index: (-?\d+)", text).group(1))
    lcp = float(re.findall(r"(?:maximum|icp refined) score: ([0-9.]+)", text)[-1])
    return index, lcp


def test_packed_top_tier_is_banded(packed):
    """The dense tier at the cut cap ran with the live mask of the sorted
    cell ranges, [bases, 34 P tiles, 2 Q chunks], some tiles dead, and a
    base's PPF bin union held more pairs than the full preset's
    16,384-pair tier (so at 24,576 it runs the top tier too)."""
    _root, _cfg, _boxes, runs = packed
    for blk, out in runs.items():
        top = [(shape, live) for shape, live in out["gates"] if shape[2] == 8704]
        assert top, [shape for shape, _live in out["gates"]]
        for shape, live in top:
            assert live is not None and live.shape == (shape[0], 34, 2)
            assert 0 < float(live.float().mean()) < 1, blk
        held = int(out["torch"]["sets"][0].pair_counts.max())
        assert held > 16384, held


@pytest.mark.parametrize("blk", [1, 8])
def test_packed_matches_jax_command(packed, blk):
    """Same best index; instance bases, segment masks and decayed prior bit
    for bit; congruent totals per base and selection_shortfall equal;
    pose and LCP within 1e-4."""
    _root, cfg, _boxes, runs = packed
    out = runs[blk]
    j, t = out["jax"], out["torch"]
    (ji, jl), (ti, tl) = _printed(j["text"]), _printed(t["text"])
    assert ti == ji >= 0
    assert abs(tl - jl) < 1e-4 and tl > 0.1
    np.testing.assert_allclose(t["pose"], j["pose"], rtol=0, atol=1e-4)
    (jinst,), (tinst,) = j["inst"], t["inst"]
    for f in ("indices", "valid", "seg_masks", "class_prob", "fill_converged"):
        np.testing.assert_array_equal(getattr(tinst, f).numpy(),
                                      np.asarray(getattr(jinst, f)), err_msg=f)
    assert int(tinst.valid.sum()) >= 12
    (jsets,), (tsets,) = j["sets"], t["sets"]
    np.testing.assert_array_equal(tsets.total_found.numpy(), np.asarray(jsets.total_found))
    np.testing.assert_array_equal(tsets.pair_counts.numpy(), np.asarray(jsets.pair_counts))
    np.testing.assert_array_equal(tsets.quad_valid.numpy(), np.asarray(jsets.quad_valid))
    tcfg = dataclasses.replace(tconfig.get_preset("packed").match, **PACKED_CAPS)
    jcfg = dataclasses.replace(jconfig.get_preset("packed").match, **PACKED_CAPS)
    from model_matching_tpu import congruent as jcong

    short = int(tcong.selection_shortfall(tsets, tcfg))
    assert short == int(jcong.selection_shortfall(jsets, jcfg)) > 0
    if blk == 8:
        # the block sampler decayed through fmath.pow, a point covered by
        # two segments of one block at once
        assert out["exponents"] and max(out["exponents"]) >= 2
    else:
        assert not out["exponents"]


def test_packed_pose_lands_on_a_box(packed):
    """The port's pose file is a rigid 3x4 on one of the eight boxes: its
    centre within 1 cm of the box's, its axes along the box's up to the
    box's own symmetries (|R_gt^T R| near the identity)."""
    _root, _cfg, boxes, runs = packed
    assert len(boxes) == 8
    for out in runs.values():
        t = out["torch"]["pose"]
        r = t[:, :3]
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-4)
        assert np.linalg.det(r) == pytest.approx(1.0, abs=1e-4)
        dist = [np.linalg.norm(g[:3, 3] - t[:, 3]) for g in boxes]
        g = boxes[int(np.argmin(dist))]
        assert min(dist) < 0.01, dist
        assert np.abs(np.abs(g[:3, :3].T @ r) - np.eye(3)).max() < 0.2


def _preprocessed(root, name, obj):
    from model_matching_tpu_torch.io import ply
    from model_matching_tpu_torch.ppf_table import load_ppf_table

    mdir = os.path.join(root, f"out_{name}", "models", obj)
    cloud = ply.read_ply_cloud(os.path.join(mdir, "model_search.ply"))
    table, meta = load_ppf_table(os.path.join(mdir, "ppf_table.npz"))
    occ = table.bin_keys >= 0
    key_of_pair = np.zeros(table.num_pairs, np.int64)
    for k, o, c in zip(table.bin_keys[occ].tolist(), table.bin_offset[occ].tolist(),
                       table.bin_count[occ].tolist()):
        key_of_pair[o:o + c] = k
    pairs = table.pairs.numpy().astype(np.int64)
    keys = dict(zip((pairs[:, 0] * 100000 + pairs[:, 1]).tolist(), key_of_pair.tolist()))
    assert meta["num_points"] == cloud[0].shape[0]
    return cloud, keys, meta


def _preprocess_equal(root, obj):
    (jpos, jnrm, jrgb), jk, _jm = _preprocessed(root, "jax", obj)
    (tpos, tnrm, trgb), tk, meta = _preprocessed(root, "torch", obj)
    assert tpos.shape == jpos.shape and tpos.shape[0] > 200
    np.testing.assert_array_equal(tpos, jpos)
    np.testing.assert_array_equal(tnrm, jnrm)
    np.testing.assert_array_equal(trgb, jrgb)
    assert set(jk) == set(tk)
    differ = sum(jk[p] != tk[p] for p in jk)
    assert differ == 0, f"{differ} of {len(jk)} pair keys differ"
    return tpos, meta


def test_packed_preprocess_matches_jax(packed):
    root = packed[0]
    pos, meta = _preprocess_equal(root, BOX)
    # 5 mm voxels over the box's faces
    assert meta["voxel_size"] == 0.005 and 800 < pos.shape[0] < 1100


@pytest.fixture(scope="module")
def linemod(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("linemod"))
    scene_dir, cfg, gt = write_synthetic_scene(root, SHELL, preset="linemod", scale=0.25)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _patched_presets(mp, cfg, **LINEMOD_SMALL)
        for name, cli, extra in (("jax", jcli, []), ("torch", tcli, ["--device", "cpu"])):
            dst = os.path.join(root, f"out_{name}")
            common = ["--repo-path", root, "--preset", "linemod", "--output-root", dst]
            _captured(cli, ["model-preprocess", SHELL, *common, *extra])
            text = _captured(cli, ["stocs-single", scene_dir, SHELL, *common,
                                   "--number-of-bases", BASES, *extra])
            out[name] = (text, _pose(os.path.join(dst, "scene",
                                                  f"best_pose_candidate_{SHELL}.txt")))
    return root, scene_dir, cfg, gt, out


def test_linemod_files_are_in_millimetres(linemod):
    """The source cloud is written in millimetres and the depth at the
    preset's 1/1000 scale."""
    from model_matching_tpu_torch.io import image, ply

    root, scene_dir, cfg, _gt, _out = linemod
    assert cfg.depth_scale == 1.0 / 1000.0
    src = ply.read_ply_cloud(os.path.join(root, "models", SHELL, "textured_vertices.ply"))[0]
    assert 70.0 < np.abs(src).max() < 90.0           # the shell's 80 mm semi-axis
    depth = image.read_u16(os.path.join(scene_dir, "depth.png"))
    assert 740 <= depth[depth > 0].min() and depth.max() <= 910


def test_linemod_preprocess_matches_jax(linemod):
    """model-preprocess --preset linemod: the JAX package's points, normals
    and colours bit for bit and every PPF pair key equal; the model is in
    metres (model_scale 1/1000 applied in float32)."""
    pos, meta = _preprocess_equal(linemod[0], SHELL)
    assert meta["voxel_size"] == 10.0 and meta["model_scale"] == 1.0 / 1000.0
    assert 0.07 < np.abs(pos).max() < 0.09


def test_linemod_stocs_single_matches_jax(linemod):
    """stocs-single --preset linemod: the JAX command's best index, its pose
    within 1e-4, and a pose on the ground truth up to the shell's half-turn
    symmetry."""
    _root, _scene, _cfg, gt, out = linemod
    (jt, jpose), (tt, tpose) = out["jax"], out["torch"]
    (ji, jl), (ti, tl) = _printed(jt), _printed(tt)
    assert ti == ji >= 0
    assert abs(tl - jl) < 1e-4 and tl > 0.3
    np.testing.assert_allclose(tpose, jpose, rtol=0, atol=1e-4)
    half_turn = np.diag([-1.0, -1.0, 1.0])
    err = min(np.abs(tpose[:, :3] - gt[:3, :3] @ s).max() for s in (np.eye(3), half_turn))
    assert err < 0.15
    np.testing.assert_allclose(tpose[:, 3], gt[:3, 3], rtol=0, atol=0.01)


def _chip_smoke():
    """chip_smoke.py at the repo's root, as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("which", ["in_memory_seed3", "packed_box"])
def test_densest_bin_union_is_the_largest_lookup(which, tmp_path):
    """chip_smoke.densest_bin_union: lookup_pair_range at the bins it names
    gathers exactly the count it gives, and no query made from the model's
    own pairs gathers more. The in-memory main path's model (seed 3) stays
    at or under the 16,384-pair tier below its 20,480 top tier; the packed
    box goes over it."""
    from model_matching_tpu_torch.model import load_model_pack
    from model_matching_tpu_torch.ops.ppf import ppf_bins
    from model_matching_tpu_torch.ppf_table import lookup_pair_range
    from model_matching_tpu_torch.preprocess import preprocess_model
    from model_matching_tpu_torch.synthetic import synthetic_setup

    if which == "in_memory_seed3":
        model = synthetic_setup(480, 16384, num_bases=100, max_pairs=20480, seed=3,
                                device="cpu")[0]
    else:
        write_synthetic_packed_scene(str(tmp_path), BOX, scale=0.125, num_source_points=20000)
        mdir = tmp_path / "models" / BOX
        pre = tconfig.get_preset("packed").preprocess
        preprocess_model(str(mdir / "textured_vertices.ply"), str(mdir / "m.ply"),
                         str(mdir / "t.npz"), pre, verbose=False, device="cpu")
        model = load_model_pack(str(mdir / "m.ply"), str(mdir / "t.npz"), 4096, device="cpu")
    most, bins = _chip_smoke().densest_bin_union(model.table)
    _off, cnt = lookup_pair_range(model.table, torch.from_numpy(bins))
    assert int(cnt.sum()) == most
    pos, nrm = model.pos, model.normal
    i, j = torch.randint(0, pos.shape[0], (2, 40_000), generator=torch.Generator().manual_seed(1))
    keep = i != j
    q = ppf_bins(pos[i[keep]], nrm[i[keep]], pos[j[keep]], nrm[j[keep]],
                 model.table.tr_disc, model.table.rot_disc)
    seen = int(lookup_pair_range(model.table, q)[1].sum(-1).max())
    assert seen <= most and seen > 0.8 * most
    if which == "in_memory_seed3":
        assert most <= 16384
    else:
        assert 16384 < most <= 24576

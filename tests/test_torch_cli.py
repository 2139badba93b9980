"""The slice end to end on the CPU: both packages' `model-preprocess` and
`stocs-single` on the same synthetic RGB-D scene, written as the tools
read it (640x480 with the ycb preset: the shell of synthetic.py at its
ground-truth pose over a plane, and a dense source textured_vertices.ply).

Required: the port's pose file is a rigid 3x4 within 1e-4 of the JAX
package's, its debug PLYs exist, and it lands on the ground truth; the
port's estimator, fed the JAX package's ingested packs (convert.py), picks
the JAX package's best index; bad calls of the six commands and a missing
card exit nonzero with a message.

The instance path and the sweep flags run on a smaller scene (160x120 with
probability_maps/edge.png, the ycb preset at a 1 cm voxel, a 4,096-point
cap, 2,048 pairs per bin and 64 sets per base, so that the CPU runs take
seconds): the artifacts of `--cluster` and `--heatmap` written, the pose on
the ground truth; under `--sweep` the files the JAX command writes (the
pose file and the scene cloud, whatever `--cluster` and `--heatmap` ask),
a sweep stopped and resumed through the command equal to the uninterrupted
one to the byte, and with several ranks in sight the sweep sharded over
them (parallel/sharding.py), its chunk rounded up to their count. Each
command ingests the scene itself; the two ingests are bit-equal
(tests/test_torch_ingest.py) and the port's transcendentals and Gumbel
draws round as XLA's (ops/fmath.py), so on the instance path the two
commands pick the same best index, with poses and LCPs within 1e-4 (the
ICP solve's last bits); the port's estimator is also held to the JAX
command exactly (best index, sweep LCP, pose file within 1e-3) on the
packs the JAX package ingested."""

import contextlib
import dataclasses
import io
import os
import re
import shutil

import numpy as np
import pytest
import torch

from model_matching_tpu import cli as jcli
from model_matching_tpu_torch import cli as tcli
from model_matching_tpu_torch.synthetic import write_synthetic_scene

OBJ = "synthetic_shell"
BASES = "16"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads while this module runs: under several test workers
    on one machine, torch's worker threads contend for the cores and these
    tests ran 5x slower than alone; one thread makes them slow alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli"))
    scene_dir, cfg, gt = write_synthetic_scene(root, OBJ)
    out, best = {}, {}
    for name, cli, extra in (("jax", jcli, []), ("torch", tcli, ["--device", "cpu"])):
        dst = os.path.join(root, f"out_{name}")
        assert cli.main(["model-preprocess", OBJ, "--repo-path", root,
                         "--output-root", dst, *extra]) == 0
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = cli.main(["stocs-single", scene_dir, OBJ, "--repo-path", root,
                           "--output-root", dst, "--number-of-bases", BASES, *extra])
        print(text.getvalue())
        assert rc == 0
        best[name] = int(re.search(r"best index: (-?\d+)", text.getvalue()).group(1))
        out[name] = os.path.join(dst, os.path.basename(scene_dir))
    return root, scene_dir, cfg, gt, out, best


def _pose(scene_out):
    vals = np.loadtxt(os.path.join(scene_out, f"best_pose_candidate_{OBJ}.txt"))
    assert vals.shape == (12,)
    return vals.reshape(3, 4)


def test_pose_file_matches_jax(runs):
    _root, _scene, _cfg, gt, out, _best = runs
    t, j = _pose(out["torch"]), _pose(out["jax"])
    r = t[:, :3]
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-4)
    assert np.linalg.det(r) == pytest.approx(1.0, abs=1e-4)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-4)
    # and it is the right pose: the shell lands where it was rendered
    np.testing.assert_allclose(t[:, 3], gt[:3, 3], atol=0.01)
    for name in ("sampled_scene.ply", "best_pose.ply", "scene.ply"):
        assert os.path.exists(os.path.join(out["torch"], "dbg", name)), name


def test_preprocess_outputs_match_jax(runs):
    """model-preprocess: the same point count, positions and normals bit for
    bit (the port's float32 eigen-solve rounds as the JAX package's), and
    PPF tables whose pair keys are equal for every pair."""
    from model_matching_tpu_torch.io import ply
    from model_matching_tpu_torch.ppf_table import load_ppf_table

    root, _scene, _cfg, _gt, _out, _best = runs
    clouds, keys = [], []
    for src in ("jax", "torch"):
        mdir = os.path.join(root, f"out_{src}", "models", OBJ)
        clouds.append(ply.read_ply_cloud(os.path.join(mdir, "model_search.ply")))
        table, meta = load_ppf_table(os.path.join(mdir, "ppf_table.npz"))
        occ = table.bin_keys >= 0
        key_of_pair = np.zeros(table.num_pairs, np.int64)
        for k, o, c in zip(table.bin_keys[occ].tolist(), table.bin_offset[occ].tolist(),
                           table.bin_count[occ].tolist()):
            key_of_pair[o:o + c] = k
        pairs = table.pairs.numpy().astype(np.int64)
        keys.append(dict(zip((pairs[:, 0] * 100000 + pairs[:, 1]).tolist(),
                             key_of_pair.tolist())))
        assert meta["num_points"] == clouds[-1][0].shape[0]
    (jpos, jnrm, jrgb), (tpos, tnrm, trgb) = clouds
    assert tpos.shape == jpos.shape and tpos.shape[0] > 200
    np.testing.assert_array_equal(tpos, jpos)
    np.testing.assert_array_equal(trgb, jrgb)
    np.testing.assert_array_equal(tnrm, jnrm)
    jk, tk = keys
    assert set(jk) == set(tk)
    differ = sum(jk[p] != tk[p] for p in jk)
    assert differ == 0, f"{differ} of {len(jk)} pair keys differ"


def test_artifacts_cross_load(runs):
    """Each package loads the other's model_search.ply + ppf_table.npz."""
    from model_matching_tpu.model import load_model_pack as jload
    from model_matching_tpu_torch.model import load_model_pack as tload

    root, _scene, cfg, _gt, _out, _best = runs
    for src in ("jax", "torch"):
        mdir = os.path.join(root, f"out_{src}", "models", OBJ)
        args = (os.path.join(mdir, "model_search.ply"),
                os.path.join(mdir, "ppf_table.npz"), cfg.max_model_points)
        jm = jload(*args)
        tm = tload(*args, device="cpu")
        for f in ("pos", "normal", "valid", "centroid", "pair_ep"):
            np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)))
        for f in ("pairs", "bin_keys", "bin_offset", "bin_count", "exist_keys",
                  "bin_direct"):
            np.testing.assert_array_equal(getattr(tm.table, f).numpy(),
                                          np.asarray(getattr(jm.table, f)), err_msg=f)
        np.testing.assert_array_equal(tm.table.exist_direct.numpy(),
                                      np.asarray(jm.table.exist_direct).astype(np.int64))


def test_estimator_on_jax_packs_picks_jax_best_index(runs):
    """The JAX package's best index is the one its stocs-single printed;
    the port's estimator runs on the packs the JAX package loads from the
    same files."""
    import dataclasses

    from model_matching_tpu.config import get_preset as jpreset
    from model_matching_tpu.model import load_model_pack as jload
    from model_matching_tpu.scene import load_scene as jload_scene
    from model_matching_tpu_torch import convert
    from model_matching_tpu_torch.config import get_preset
    from model_matching_tpu_torch.estimator import StocsEstimator

    root, scene_dir, _cfg, _gt, _out, best = runs
    mdir = os.path.join(root, "out_jax", "models", OBJ)
    jcfg = dataclasses.replace(jpreset("ycb").match, number_of_bases=int(BASES))
    tcfg = dataclasses.replace(get_preset("ycb").match, number_of_bases=int(BASES))
    jm = jload(os.path.join(mdir, "model_search.ply"), os.path.join(mdir, "ppf_table.npz"),
               jcfg.max_model_points)
    js = jload_scene(os.path.join(scene_dir, "rgb.png"), os.path.join(scene_dir, "depth.png"),
                     os.path.join(scene_dir, "probability_maps", f"{OBJ}.png"), None, jcfg)
    got = StocsEstimator(convert.model_pack(jm), convert.scene_pack(js), tcfg).run(verbose=False)
    assert got.best_index == best["jax"] >= 0
    # the port's own command picked it too, from its own ingest
    assert best["torch"] == best["jax"]


def test_unported_flags_and_commands_exit_nonzero(runs, capsys):
    """Every command is ported: each of the six dispatches and answers a bad
    call with its own error and a nonzero exit (--profile is accepted by
    stocs-single, on a missing object here); an unknown command exits 2
    listing the six; --sweep-stop-after without a checkpoint is refused."""
    root, scene_dir, _cfg, _gt, _out, _best = runs
    out_root = os.path.join(root, "out_flags")
    base = ["--repo-path", root, "--device", "cpu", "--output-root", out_root]
    for argv, rc, said in (
            (["model-preprocess", "no_such_object"], 1, "not found"),
            (["stocs-single", scene_dir, "no_such_object", "--profile", "p"], 1,
             "model-preprocess"),
            (["stocs-batch", scene_dir, "no_such_object"], 1, "model-preprocess"),
            (["stocs-multi", scene_dir, f"{OBJ},no_such_object"], 1,
             "missing scene inputs"),
            (["eval", "est.txt", "gt.txt", "--model", "no_such.ply", "--device", "cpu"],
             1, "model no_such.ply not found")):
        assert tcli.main(argv + (base if argv[0] != "eval" else [])) == rc, argv
        assert said in capsys.readouterr().out, argv
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("sys.stdin", io.StringIO("one two three\nquit\n"))
        assert tcli.main(["serve", *base]) == 0
    assert capsys.readouterr().out.splitlines()[:2] == [
        "READY", "ERR usage: <scene_path> <object>"]
    assert tcli.main(["no-such-command"]) == 2
    assert "stocs-batch, stocs-multi, serve or eval" in capsys.readouterr().out
    assert tcli.main(["stocs-single", scene_dir, OBJ, *base, "--sweep-stop-after", "1"]) == 1
    assert "--sweep-checkpoint" in capsys.readouterr().out


SMALL = dict(voxel_size=0.01, max_scene_points=4096, max_pairs_per_bin=2048,
             maximum_congruent_sets=64)


def _captured(cli, argv):
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = cli.main(argv)
    print(text.getvalue())
    return rc, text.getvalue()


def _keep(scene_out, tag):
    """Set a run's artifacts aside (the next run clears dbg/)."""
    dst = f"{scene_out}_{tag}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(scene_out, dst)
    return dst


@pytest.fixture(scope="module")
def small_runs(runs):
    """Both commands on the small edge-mapped scene: the instance run, then
    (edge map moved away, the output directory emptied before each run) the
    class sweep with --cluster --heatmap. The JAX command shards its sweep
    over the eight devices it sees (tests/conftest.py), its chunk rounded up
    to 16; the port's runs it on one device, stopped after a chunk and
    resumed, then with eight and with two ranks in sight (_sweep_devices
    patched), which sends it to run_sweep_sharded (each call recorded).
    Models come from `runs`."""
    import dataclasses

    from model_matching_tpu import config as jconfig
    from model_matching_tpu_torch import config as tconfig
    from model_matching_tpu_torch.parallel import sharding

    root = runs[0]
    scene_dir, cfg, _gt = write_synthetic_scene(
        os.path.join(root, "small"), OBJ, scale=0.25, edge=True)
    cam = cfg.camera.as_tuple()
    size = dict(image_width=cfg.image_width, image_height=cfg.image_height, **SMALL)
    real = {jconfig: jconfig.get_preset, tconfig: tconfig.get_preset}

    def patched(mod):
        def get(name):
            p = real[mod](name)
            return dataclasses.replace(p, match=dataclasses.replace(
                p.match, camera=mod.CameraIntrinsics(*cam), **size))
        return get

    edge = os.path.join(scene_dir, "probability_maps", "edge.png")
    out = {"gt": _gt, "sharded_calls": [], "inputs": (root, scene_dir) + tuple(
        dataclasses.replace(patched(mod)("ycb").match, number_of_bases=int(BASES))
        for mod in real)}
    real_sharded = sharding.run_sweep_sharded

    def recorded(mesh, *a, **kw):
        res = real_sharded(mesh, *a, **kw)
        out["sharded_calls"].append((mesh.size, kw["chunk"], res))
        return res

    with pytest.MonkeyPatch.context() as mp:
        for mod in real:
            mp.setattr(mod, "get_preset", patched(mod))
        mp.setattr(sharding, "run_sweep_sharded", recorded)
        for name, cli, extra in (("jax", jcli, []), ("torch", tcli, ["--device", "cpu"])):
            dst = os.path.join(root, f"out_{name}")
            base = ["stocs-single", scene_dir, OBJ, "--repo-path", root,
                    "--output-root", dst, *extra]
            scene_out = os.path.join(dst, os.path.basename(scene_dir))
            rc, text = _captured(cli, base + ["--number-of-bases", BASES,
                                              "--cluster", "--heatmap"])
            assert rc == 0
            res = {"instance": (_keep(scene_out, "instance"), text)}
            out[name] = res

            def sweep(tag, argv):
                shutil.rmtree(scene_out)
                rc, text = _captured(cli, argv)
                assert rc == 0
                res[tag] = (_keep(scene_out, tag), text)

            flags = ["--sweep", "32", "--cluster", "--heatmap"]
            os.rename(edge, edge + ".off")
            try:
                if name == "jax":
                    sweep("sweep", base + flags + ["--sweep-chunk", "15"])
                    continue
                sweep("sweep", base + flags + ["--sweep-chunk", BASES])
                ckpt = os.path.join(dst, "sweep.ckpt.npz")
                slices = base + flags + ["--sweep-chunk", BASES, "--sweep-checkpoint",
                                         ckpt, "--sweep-stop-after", "1"]
                rc, text = _captured(cli, slices)
                assert rc == 0 and os.path.exists(ckpt)
                res["stopped"] = (None, text)
                rc, text = _captured(cli, slices)
                assert rc == 0 and not os.path.exists(ckpt)
                res["resumed"] = (_keep(scene_out, "resumed"), text)
                for ranks in (8, 2):
                    mp.setattr(tcli, "_sweep_devices", lambda dev, n=ranks: [dev] * n)
                    sweep(f"sharded{ranks}", base + flags + ["--sweep-chunk", "15"])
            finally:
                os.rename(edge + ".off", edge)
    return out


def _clusters(scene_out):
    rows = np.loadtxt(os.path.join(scene_out, f"clustered_poses_{OBJ}.txt"), ndmin=2)
    assert rows.shape[1] == 13 and rows.shape[0] >= 1
    return rows


def _rigid_close(t, ref, rot_tol, tr_tol):
    """Pose t [3, 4] on pose ref [4, 4], up to the shell's own symmetry: a
    half-turn about its z axis maps the half-ellipsoid onto itself, and
    both poses score alike."""
    half_turn = np.diag([-1.0, -1.0, 1.0])
    err = min(np.abs(t[:, :3] - ref[:3, :3] @ s).max() for s in (np.eye(3), half_turn))
    assert err < rot_tol, (t, ref)
    np.testing.assert_allclose(t[:, 3], ref[:3, 3], rtol=0, atol=tr_tol)


def test_edge_mapped_scene_takes_the_instance_path(small_runs):
    """stocs-single on a scene with probability_maps/edge.png: exit 0, a
    pose on the ground truth (rotation entries within 0.15, translation
    within 1 cm); the JAX command's best index, its pose within 1e-4 and
    its LCP within 1e-4 (both commands ingest the files themselves, and the
    port rounds ingest, sampling and its Gumbel draws as the JAX package
    does); the same segment-mask files, and the artifacts of --cluster and
    --heatmap."""
    (tdir, ttext), (jdir, jtext) = small_runs["torch"]["instance"], small_runs["jax"]["instance"]
    assert "no pose found" not in ttext
    lcp = [float(re.findall(r"(?:maximum|icp refined) score: ([0-9.]+)", t)[-1])
           for t in (ttext, jtext)]
    assert abs(lcp[0] - lcp[1]) < 1e-4 and lcp[0] > 0.3
    index = [int(re.search(r"best index: (-?\d+)", t).group(1)) for t in (ttext, jtext)]
    assert index[0] == index[1] >= 0
    _rigid_close(_pose(tdir), small_runs["gt"], 0.15, 0.01)
    np.testing.assert_allclose(_pose(tdir), _pose(jdir), rtol=0, atol=1e-4)
    masks = lambda d: sorted(f for f in os.listdir(os.path.join(d, "dbg"))
                             if f.startswith("seg_mask_"))
    assert masks(tdir) == masks(jdir) and len(masks(tdir)) >= 1
    for f in ("probability_heatmap.png", f"overlay_{OBJ}.png", "best_pose.ply",
              "sampled_scene.ply", "scene.ply"):
        assert os.path.exists(os.path.join(tdir, "dbg", f)), f
    from model_matching_tpu_torch.io import image

    heat = image.read_rgb(os.path.join(tdir, "dbg", "probability_heatmap.png"))
    assert heat.shape == (120, 160, 3) and heat.any()
    rows = _clusters(tdir)
    assert (np.diff(rows[:, 12]) <= 0).all()


def _written(scene_out):
    """Every file under a command's scene output directory."""
    return sorted(os.path.relpath(os.path.join(d, f), scene_out)
                  for d, _dirs, files in os.walk(scene_out) for f in files)


def test_sweep_cluster_heatmap_flags_run(small_runs):
    """--sweep 32 --cluster --heatmap writes what the JAX command writes:
    the pose file and dbg/sampled_scene.ply, no clusters, heatmap or
    overlay (both commands drop those flags under --sweep), on one device
    and over a mesh; the pose lies on the ground truth (bounds as above)."""
    jdir, _jtext = small_runs["jax"]["sweep"]
    want = [f"best_pose_candidate_{OBJ}.txt", os.path.join("dbg", "sampled_scene.ply")]
    assert _written(jdir) == want
    for tag in ("sweep", "sharded8", "sharded2"):
        tdir, ttext = small_runs["torch"][tag]
        assert _written(tdir) == want, tag
        assert float(re.search(r"sweep best lcp ([0-9.]+)", ttext).group(1)) > 0.3
        _rigid_close(_pose(tdir), small_runs["gt"], 0.15, 0.01)
    assert re.search(r"sweep: 32 bases -> \d+ hypotheses", small_runs["torch"]["sweep"][1])


def test_sweep_shards_over_the_visible_ranks(small_runs):
    """With several ranks in sight --sweep runs run_sweep_sharded over them,
    its chunk (15) rounded up to a multiple of their count: 16 over 8 ranks
    and over 2. The 2-rank pose file is the one that run_sweep_sharded
    gives over two CPU ranks on the packs the command loads; the 8-rank run
    is held to the JAX command, which shards over its eight devices (its
    own ingest: LCP within 0.02, pose within the bounds above)."""
    from model_matching_tpu_torch.model import load_model_pack
    from model_matching_tpu_torch.parallel.sharding import make_mesh, run_sweep_sharded
    from model_matching_tpu_torch.scene import load_scene

    calls = small_runs["sharded_calls"]
    assert [(n, chunk) for n, chunk, _res in calls] == [(8, 16), (2, 16)]
    assert [res[4]["devices"] for _n, _c, res in calls] == [8, 2]
    assert "sharded sweep" not in small_runs["torch"]["sweep"][1]
    root, scene_dir, _jcfg, tcfg = small_runs["inputs"]
    tcfg = dataclasses.replace(tcfg, seed=0)
    mdir = os.path.join(root, "out_torch", "models", OBJ)
    model = load_model_pack(os.path.join(mdir, "model_search.ply"),
                            os.path.join(mdir, "ppf_table.npz"), tcfg.max_model_points,
                            device="cpu")
    scene = load_scene(*[os.path.join(scene_dir, n) for n in
                         ("rgb.png", "depth.png", f"probability_maps/{OBJ}.png")],
                       None, tcfg, device="cpu")
    lcp, world, *_rest = run_sweep_sharded(make_mesh(["cpu"] * 2), model, scene, tcfg,
                                           32, chunk=16, verbose=False)
    assert lcp == calls[1][2][0]
    np.testing.assert_array_equal(world, calls[1][2][1])
    with open(os.path.join(small_runs["torch"]["sharded2"][0],
                           f"best_pose_candidate_{OBJ}.txt")) as f:
        assert f.read().strip() == tcli._pose_row(world)
    (tdir, ttext), (jdir, jtext) = small_runs["torch"]["sharded8"], small_runs["jax"]["sweep"]
    lcps = [float(re.search(r"sweep best lcp ([0-9.]+)", t).group(1)) for t in (ttext, jtext)]
    assert abs(lcps[0] - lcps[1]) < 0.02, lcps
    _rigid_close(_pose(tdir), np.vstack([_pose(jdir), [0, 0, 0, 1]]), 0.15, 0.01)


def test_estimator_on_jax_packs_matches_the_jax_commands(small_runs):
    """On the packs the JAX package loads from the same files the port's
    estimator gives what the JAX package gives: the best index its command
    printed for the instance run and its pose file within 1e-3 (six
    digits); for the class sweep, its one-device run_sweep's LCP within
    1e-5, pose within 1e-4 and cluster count, and the port's own command
    (its own ingest) within 0.02 of that LCP."""
    from model_matching_tpu.estimator import StocsEstimator as JEstimator
    from model_matching_tpu.model import load_model_pack as jload
    from model_matching_tpu.scene import load_scene as jload_scene
    from model_matching_tpu_torch import convert
    from model_matching_tpu_torch.estimator import StocsEstimator

    root, scene_dir, jcfg, tcfg = small_runs["inputs"]
    mdir = os.path.join(root, "out_jax", "models", OBJ)
    jm = jload(os.path.join(mdir, "model_search.ply"),
               os.path.join(mdir, "ppf_table.npz"), jcfg.max_model_points)
    tm = convert.model_pack(jm)
    paths = [os.path.join(scene_dir, n) for n in
             ("rgb.png", "depth.png", f"probability_maps/{OBJ}.png")]
    edge = os.path.join(scene_dir, "probability_maps", "edge.png")
    jdir, jtext = small_runs["jax"]["instance"]
    got = StocsEstimator(tm, convert.scene_pack(jload_scene(*paths, edge, jcfg)),
                         tcfg).run(verbose=False)
    assert got.best_index == int(re.search(r"best index: (-?\d+)", jtext).group(1)) >= 0
    np.testing.assert_allclose(got.best_world_transform[:3], _pose(jdir), rtol=0, atol=1e-3)
    js = jload_scene(*paths, None, jcfg)
    jl, jw, _jt, jcs, jst = JEstimator(jm, js, jcfg).run_sweep(
        32, chunk=int(BASES), verbose=False)
    lcp, world, _ct, cs, st = StocsEstimator(tm, convert.scene_pack(js), tcfg).run_sweep(
        32, chunk=int(BASES), verbose=False)
    assert abs(lcp - jl) <= 1e-5 and st["hypotheses"] == jst["hypotheses"]
    np.testing.assert_allclose(world, jw, rtol=0, atol=1e-4)
    assert len(cs) == len(jcs)
    _tdir, ttext = small_runs["torch"]["sweep"]
    assert abs(float(re.search(r"sweep best lcp ([0-9.]+)", ttext).group(1)) - jl) < 0.02


def test_sweep_stopped_and_resumed_through_the_command(small_runs):
    res = small_runs["torch"]
    assert "stopped after chunk 1" in res["stopped"][1]
    assert "re-run the same command to resume" in res["stopped"][1]
    assert "resumed from" in res["resumed"][1] and "at chunk 1/2" in res["resumed"][1]
    assert _written(res["resumed"][0]) == _written(res["sweep"][0])
    f = f"best_pose_candidate_{OBJ}.txt"
    with open(os.path.join(res["sweep"][0], f)) as a, \
            open(os.path.join(res["resumed"][0], f)) as b:
        assert a.read() == b.read()


def test_friendly_errors(runs, capsys, monkeypatch):
    root, scene_dir, _cfg, _gt, _out, _best = runs
    out_root = os.path.join(root, "out_torch")
    assert tcli.main(["stocs-single", scene_dir, "no_such_object", "--repo-path", root,
                      "--output-root", out_root, "--device", "cpu"]) == 1
    assert "model-preprocess" in capsys.readouterr().out
    assert tcli.main(["model-preprocess", "no_such_object", "--repo-path", root,
                      "--output-root", out_root, "--device", "cpu"]) == 1
    assert "not found" in capsys.readouterr().out
    os.makedirs(os.path.join(root, "empty_scene"), exist_ok=True)
    assert tcli.main(["stocs-single", os.path.join(root, "empty_scene"), OBJ,
                      "--repo-path", root, "--output-root", out_root,
                      "--device", "cpu"]) == 1
    assert "missing scene inputs" in capsys.readouterr().out
    # a tree this process may not write: refused with the flag that fixes it
    monkeypatch.setattr(tcli.os, "access", lambda path, mode: False)
    with pytest.raises(SystemExit, match="--output-root"):
        tcli.main(["model-preprocess", OBJ, "--repo-path", root, "--device", "cpu"])


def test_default_device_is_the_card(runs):
    """Without a card the commands stop unless given --device cpu."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    root, _scene, _cfg, _gt, _out, _best = runs
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main(["model-preprocess", OBJ, "--repo-path", root,
                   "--output-root", os.path.join(root, "out_card")])

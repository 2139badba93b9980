"""The multi-object and long-running commands end to end on the CPU, the
port's against the JAX package's, on the same files.

Inputs: the three-object scene of synthetic.write_synthetic_multi_scene at
160x120 (three distinct half-ellipsoid shells over a plane, made from a
seed with numpy), once without and once with probability_maps/edge.png,
the three objects preprocessed by each package, and the ycb preset cut to
a 1 cm voxel, 4,096 scene points, 2,048 pairs per bin and 64 sets per
base, with 16 bases for the one-object commands and 32 for `stocs-multi`
(whose per-object keys find too few good bases for one of the shells at
16), so that the CPU runs take seconds.

Each command ingests the scene itself; the two packages' ingests are
bit-equal (tests/test_torch_ingest.py) and the port's transcendentals and
Gumbel draws round as XLA's (ops/fmath.py), so the two `stocs-multi`
commands are held to each other within 1e-4 in every pose and LCP (their
estimators are held exactly on shared packs in tests/test_torch_multi.py),
and every pose to its ground truth. At this size (2,500 scene points) the
multi-object path, which has no ICP polish, lands within 0.23 of the
ground truth's rotation entries and 1.3 cm of its translation (measured);
the bound is 0.3 and 2 cm. The one-object commands are held to 0.15 and
1 cm. Required besides: `stocs-batch` writes
what `stocs-single` writes, byte for byte; `serve` answers in the JAX
package's protocol, caching each model and loading it once, standardized
as the JAX package's serve loads it: each OK line is the port's estimator
on the standardized pack byte for byte and within 1e-4 of the
`stocs-single` pose, and the JAX serve's line is the port's estimator on
the JAX package's packs within 1e-4 (pose) and 1e-5 (LCP); `eval` gives
the JAX package's JSON document within 1e-5 on the pose-file and BOP
routes; `--profile` writes a trace, except under `--sweep`."""

import contextlib
import dataclasses
import io
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from model_matching_tpu import cli as jcli
from model_matching_tpu_torch import cli as tcli
from model_matching_tpu_torch.synthetic import MULTI_SHELLS, write_synthetic_multi_scene

OBJS = [name for name, *_ in MULTI_SHELLS]
SMALL = dict(voxel_size=0.01, max_scene_points=4096, max_pairs_per_bin=2048,
             maximum_congruent_sets=64)
BASES = "16"
MULTI_BASES = "32"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads while this module runs (several test workers share
    the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _captured(cli, argv, stdin=None):
    text = io.StringIO()
    with contextlib.ExitStack() as stack:
        stack.enter_context(contextlib.redirect_stdout(text))
        if stdin is not None:
            stack.enter_context(pytest.MonkeyPatch.context()).setattr(
                sys, "stdin", io.StringIO(stdin))
        rc = cli.main(argv)
    print(text.getvalue())
    return rc, text.getvalue()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Both scenes written, the small preset patched into both packages,
    and each package's model-preprocess of the three objects."""
    from model_matching_tpu import config as jconfig
    from model_matching_tpu_torch import config as tconfig

    root = str(tmp_path_factory.mktemp("cli_multi"))
    scene_dir, cfg, gts = write_synthetic_multi_scene(os.path.join(root, "c"), scale=0.25)
    edge_dir, _cfg, _gts = write_synthetic_multi_scene(os.path.join(root, "e"), scale=0.25,
                                                       edge=True)
    size = dict(image_width=cfg.image_width, image_height=cfg.image_height, **SMALL)
    cam = cfg.camera.as_tuple()
    real = {jconfig: jconfig.get_preset, tconfig: tconfig.get_preset}

    def patched(mod):
        def get(name):
            p = real[mod](name)
            return dataclasses.replace(p, match=dataclasses.replace(
                p.match, camera=mod.CameraIntrinsics(*cam), **size))
        return get

    mp = pytest.MonkeyPatch()
    for mod in real:
        mp.setattr(mod, "get_preset", patched(mod))
    out = {"root": root, "scene": scene_dir, "edge": edge_dir, "gts": gts,
           "src": os.path.join(root, "c"), "cfg": patched(tconfig)("ycb").match,
           "jax_cfg": patched(jconfig)("ycb").match}
    for name, cli, extra in (("jax", jcli, []), ("torch", tcli, ["--device", "cpu"])):
        dst = os.path.join(root, f"out_{name}")
        for obj in OBJS:
            assert cli.main(["model-preprocess", obj, "--repo-path", out["src"],
                             "--output-root", dst, *extra]) == 0
        out[name] = (cli, dst, extra)
    yield out
    mp.undo()


def _pose(path):
    vals = np.loadtxt(path)
    assert vals.shape == (12,)
    return vals.reshape(3, 4)


def _on_gt(t, g, rot_tol=0.15, tr_tol=0.01):
    """Pose t [3, 4] on ground truth g [4, 4], up to the half-turn about z
    that maps a half-ellipsoid shell onto itself."""
    half_turn = np.diag([-1.0, -1.0, 1.0])
    err = min(np.abs(t[:, :3] - g[:3, :3] @ s).max() for s in (np.eye(3), half_turn))
    assert err < rot_tol, (t, g)
    np.testing.assert_allclose(t[:, 3], g[:3, 3], rtol=0, atol=tr_tol)


@pytest.fixture(scope="module")
def multi_runs(files):
    """stocs-multi of both packages on the class and the edge scene."""
    runs = {}
    for name in ("jax", "torch"):
        cli, dst, extra = files[name]
        for path in ("scene", "edge"):
            rc, text = _captured(cli, ["stocs-multi", files[path], ",".join(OBJS),
                                       "--repo-path", files["src"], "--output-root", dst,
                                       "--number-of-bases", MULTI_BASES, *extra])
            assert rc == 0
            out_dir = os.path.join(dst, os.path.basename(files[path]))
            kept = f"{out_dir}_{path}_multi"
            shutil.copytree(out_dir, kept, dirs_exist_ok=True)
            runs[name, path] = (kept, text)
    return runs


@pytest.mark.parametrize("path", ["scene", "edge"])
def test_stocs_multi_matches_jax_command(files, multi_runs, path):
    """Every object's pose file on its ground truth (rotation entries
    within 0.3, translation within 2 cm) and within 1e-4 of the JAX
    command's, each printed LCP above 0.2 and within 1e-4 of the JAX
    command's (the two ingests, samplers and Gumbel draws round alike, so
    the same winners); the edge scene prints the instance-path note."""
    (tdir, ttext), (jdir, jtext) = multi_runs["torch", path], multi_runs["jax", path]
    assert ("instance path" in ttext) == (path == "edge") == ("instance path" in jtext)
    for obj in OBJS:
        f = f"best_pose_candidate_{obj}.txt"
        t, j = _pose(os.path.join(tdir, f)), _pose(os.path.join(jdir, f))
        _on_gt(t, files["gts"][obj], 0.3, 0.02)
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-4, err_msg=obj)
        lcp = [float(next(l for l in txt.splitlines() if l.startswith(f"{obj}: lcp="))
                     .split("lcp=")[1].split()[0]) for txt in (ttext, jtext)]
        assert abs(lcp[0] - lcp[1]) < 1e-4 and lcp[0] > 0.2, (obj, lcp)


def test_stocs_multi_friendly_errors(files, capsys):
    _cli, dst, extra = files["torch"]
    assert tcli.main(["stocs-multi", files["scene"], "shell_a,no_such_object",
                      "--repo-path", files["src"], "--output-root", dst, *extra]) == 1
    assert "no_such_object.png" in capsys.readouterr().out
    os.makedirs(os.path.join(files["root"], "bare"), exist_ok=True)
    shutil.copytree(files["scene"], os.path.join(files["root"], "bare", "scene"),
                    dirs_exist_ok=True)
    assert tcli.main(["stocs-multi", os.path.join(files["root"], "bare", "scene"),
                      "shell_a", "--repo-path", files["src"],
                      "--output-root", os.path.join(files["root"], "bare"), *extra]) == 1
    assert "model-preprocess shell_a" in capsys.readouterr().out


@pytest.fixture(scope="module")
def single_and_batch(files):
    """The port's stocs-single for each object (the last with --profile),
    a --sweep with --profile, then its stocs-batch of all three; each
    run's pose files set aside."""
    _cli, dst, extra = files["torch"]
    argv = ["--repo-path", dst, "--output-root", dst, "--number-of-bases", BASES, *extra]
    out_dir = os.path.join(dst, os.path.basename(files["scene"]))
    kept = {k: os.path.join(files["root"], k) for k in ("single", "batch")}
    texts = {}

    def keep(what):
        os.makedirs(kept[what], exist_ok=True)
        for f in os.listdir(out_dir):
            if f.startswith("best_pose_candidate_"):
                shutil.move(os.path.join(out_dir, f), os.path.join(kept[what], f))

    for obj in OBJS:
        prof = ["--profile", os.path.join(files["root"], "prof")] if obj == OBJS[-1] else []
        rc, texts[obj] = _captured(tcli, ["stocs-single", files["scene"], obj, *argv, *prof])
        assert rc == 0
        keep("single")
    rc, texts["sweep"] = _captured(tcli, ["stocs-single", files["scene"], OBJS[-1], *argv,
                                          "--sweep", BASES, "--sweep-chunk", BASES,
                                          "--profile", os.path.join(files["root"], "prof_sweep")])
    assert rc == 0
    rc, texts["batch"] = _captured(tcli, ["stocs-batch", files["scene"], ",".join(OBJS),
                                          *argv])
    assert rc == 0
    keep("batch")
    return kept["single"], kept["batch"], texts


def test_stocs_batch_writes_what_stocs_single_writes(files, single_and_batch):
    single, batch, texts = single_and_batch
    for obj in OBJS:
        f = f"best_pose_candidate_{obj}.txt"
        with open(os.path.join(single, f)) as a, open(os.path.join(batch, f)) as b:
            assert a.read() == b.read(), obj
        _on_gt(_pose(os.path.join(batch, f)), files["gts"][obj])
        assert f"[batch] {obj}: " in texts["batch"]


@pytest.mark.parametrize("run", ["single", "sweep"])
def test_profile_writes_a_trace(files, single_and_batch, run):
    """stocs-single --profile DIR writes one Chrome trace of its run; under
    --sweep the flag does not apply, as in the JAX command: the sweep
    writes its pose file and no trace."""
    _single, _batch, texts = single_and_batch
    prof_dir = os.path.join(files["root"], "prof" if run == "single" else "prof_sweep")
    if run == "sweep":
        assert "sweep best lcp" in texts["sweep"]
        assert "profiler trace" not in texts["sweep"] and not os.path.exists(prof_dir)
        return
    assert f"profiler trace written to {prof_dir}" in texts[OBJS[-1]]
    traces = [f for f in os.listdir(prof_dir) if f.endswith(".json")]
    assert len(traces) == 1
    with open(os.path.join(prof_dir, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    # CPU activity on the CPU: the estimator's torch ops are in it
    assert any(e.get("name") == "aten::sort" for e in events)


def _estimator_row(model, scene, cfg):
    """What a serve OK line carries for one request, from the estimator."""
    from model_matching_tpu_torch.estimator import StocsEstimator

    res = StocsEstimator(model, scene, cfg).run(verbose=False)
    return f"OK {tcli._pose_row(res.best_world_transform)} {res.best_lcp:g}"


def test_serve_answers_like_stocs_single(files, single_and_batch, monkeypatch):
    """Five requests (three objects, the edge scene, a bad line) and an
    unknown object: each model loads once, standardized as the JAX
    package's serve loads it (a repeated object loads nothing), and a
    failing request does not end the loop. Every OK line is, byte for
    byte, what the port's estimator gives on the standardized pack, its
    pose within 1e-4 of the stocs-single file and on the ground truth. The
    JAX package's serve, given the first object, the bad line and the
    unknown object (its compiles cost tens of seconds a path here), answers
    with the same protocol lines; its OK line equals the port's estimator on
    the JAX package's own standardized pack and ingest (convert.py), pose
    within 1e-4 and LCP within 1e-5."""
    from model_matching_tpu import model as jmodel
    from model_matching_tpu import scene as jscene
    from model_matching_tpu_torch import convert
    from model_matching_tpu_torch import model as tmodel
    from model_matching_tpu_torch import scene as tscene

    single, _batch, _texts = single_and_batch
    loads = []
    real = tmodel.load_model_pack
    monkeypatch.setattr(tmodel, "load_model_pack",
                        lambda *a, **k: loads.append((a[0], k.get("standardize")))
                        or real(*a, **k))
    bad = ["bad-request", f"{files['scene']} no_such_object", "quit"]
    reqs = {"torch": [f"{files['scene']} {o}" for o in OBJS]
            + [f"{files['edge']} {OBJS[0]}"] + bad,
            "jax": [f"{files['scene']} {OBJS[0]}"] + bad}
    out = {}
    for name in ("torch", "jax"):
        cli, dst, extra = files[name]
        rc, text = _captured(cli, ["serve", "--repo-path", dst, "--number-of-bases",
                                   BASES, *extra], stdin="\n".join(reqs[name]) + "\n")
        assert rc == 0
        out[name] = [l for l in text.splitlines()
                     if l == "READY" or l.startswith(("OK ", "ERR "))]
    monkeypatch.undo()
    tl, jl = out["torch"], out["jax"]
    assert [l.split()[0] for l in tl] == ["READY", "OK", "OK", "OK", "OK", "ERR", "ERR"]
    assert [l.split()[0] for l in jl] == ["READY", "OK", "ERR", "ERR"]
    assert tl[5] == jl[2] == "ERR usage: <scene_path> <object>"
    assert "no_such_object" in tl[6] and "no_such_object" in jl[3]
    # the port's serve: three models loaded once each (shell_a twice asked)
    # plus the failed attempt at the unknown object, all standardized
    assert sorted(os.path.basename(os.path.dirname(p)) for p, _s in loads) == \
        sorted(OBJS + ["no_such_object"])
    assert all(std for _p, std in loads)

    cfg = dataclasses.replace(files["cfg"], number_of_bases=int(BASES), seed=0)
    _cli, dst, _extra = files["torch"]
    packs = {}
    for i, (obj, sdir) in enumerate([(o, files["scene"]) for o in OBJS]
                                    + [(OBJS[0], files["edge"])]):
        mdir = os.path.join(dst, "models", obj)
        packs.setdefault(obj, real(os.path.join(mdir, "model_search.ply"),
                                   os.path.join(mdir, "ppf_table.npz"),
                                   cfg.max_model_points, standardize=True, device="cpu"))
        maps = os.path.join(sdir, "probability_maps")
        edge = os.path.join(maps, "edge.png")
        scene = tscene.load_scene(os.path.join(sdir, "rgb.png"),
                                  os.path.join(sdir, "depth.png"),
                                  os.path.join(maps, f"{obj}.png"),
                                  edge if os.path.exists(edge) else None, cfg, device="cpu")
        assert tl[1 + i] == _estimator_row(packs[obj], scene, cfg), (obj, sdir)
        pose = np.array(tl[1 + i].split()[1:13], float).reshape(3, 4)
        _on_gt(pose, files["gts"][obj])
        if sdir == files["scene"]:
            np.testing.assert_allclose(
                pose, _pose(os.path.join(single, f"best_pose_candidate_{obj}.txt")),
                rtol=0, atol=1e-4)

    # the JAX package's serve on its own packs, and the port's estimator on them
    _jcli, jdst, _jextra = files["jax"]
    jcfg = dataclasses.replace(files["jax_cfg"], number_of_bases=int(BASES), seed=0)
    mdir = os.path.join(jdst, "models", OBJS[0])
    jm = jmodel.load_model_pack(os.path.join(mdir, "model_search.ply"),
                                os.path.join(mdir, "ppf_table.npz"), jcfg.max_model_points,
                                standardize=True)
    maps = os.path.join(files["scene"], "probability_maps")
    js = jscene.load_scene(os.path.join(files["scene"], "rgb.png"),
                           os.path.join(files["scene"], "depth.png"),
                           os.path.join(maps, f"{OBJS[0]}.png"), None, jcfg)
    row = _estimator_row(convert.model_pack(jm), convert.scene_pack(js), cfg).split()
    j = jl[1].split()
    assert len(j) == len(row) == 14
    np.testing.assert_allclose(np.array(row[1:13], float), np.array(j[1:13], float),
                               rtol=0, atol=1e-4)
    assert abs(float(row[13]) - float(j[13])) <= 1e-5


def _eval_json(cli, argv):
    rc, text = _captured(cli, ["eval", *argv])
    assert rc == 0
    return json.loads(text[text.index("{"):])


def _assert_reports_close(t, j):
    assert t.keys() == j.keys()
    for k, v in j.items():
        if isinstance(v, dict):
            _assert_reports_close(t[k], v)
        elif isinstance(v, list):
            np.testing.assert_allclose(t[k], v, rtol=0, atol=1e-5, err_msg=k)
        elif isinstance(v, float):
            assert abs(t[k] - v) <= 1e-5, (k, t[k], v)
        else:
            assert t[k] == v, k


def test_eval_matches_jax_command(files, multi_runs):
    """eval of the port's stocs-multi poses against the written ground
    truth, by pose file and by BOP scene_gt.json (ADD-S passes for every
    object), and of a directory: the JAX package's JSON within 1e-5. The
    model is the preprocessed model_search.ply (a few hundred points; the
    8,000-point source would make an [8000, 8000] distance matrix a pose
    pair)."""
    tdir, _text = multi_runs["torch", "scene"]
    gt_dir = os.path.join(files["src"], "gt")
    _cli, dst, _extra = files["torch"]
    for i, obj in enumerate(OBJS):
        model = os.path.join(dst, "models", obj, "model_search.ply")
        est = os.path.join(tdir, f"best_pose_candidate_{obj}.txt")
        for gt in ([os.path.join(gt_dir, f"best_pose_candidate_{obj}.txt")],
                   [os.path.join(gt_dir, "scene_gt.json"), "--im-id", "0",
                    "--obj-id", str(i + 1)]):
            argv = [est, *gt, "--model", model]
            t = _eval_json(tcli, argv + ["--device", "cpu"])
            _assert_reports_close(t, _eval_json(jcli, argv))
            assert t["adds_pass_rate"] == 1.0 and t["num_poses"] == 1, (obj, t)
    # a directory of estimates against a directory of ground truth
    model = os.path.join(dst, "models", OBJS[0], "model_search.ply")
    argv = [tdir, gt_dir, "--model", model]
    t = _eval_json(tcli, argv + ["--device", "cpu"])
    _assert_reports_close(t, _eval_json(jcli, argv))
    assert t["num_poses"] == 3 and sorted(t["files"]) == sorted(
        f"best_pose_candidate_{o}.txt" for o in OBJS)

"""ADD / ADD-S evaluation and the BOP loaders of the port against the JAX
package, on the CPU.

Inputs: seeded model clouds (numpy, 300 points; 5,000 for the reduced
diameter) and seeded poses near each other. Tolerances: ADD within 1e-6
(the same products, another summation order), ADD-S within 1e-5 (the
matmul identity subtracts squared norms of order 1e-1 m^2, cancelling
most float32 bits of a millimetre-scale distance; the order of the sums
differs between the packages), the diameter and pose files exact, the BOP
parses exact."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from model_matching_tpu import eval as jev
from model_matching_tpu.io import bop as jbop
from model_matching_tpu_torch import eval as tev
from model_matching_tpu_torch.io import bop as tbop


def _poses(rng, n, near=None):
    out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        if near is None:
            out[i, :3, :3] = Rotation.random(rng=rng).as_matrix()
            out[i, :3, 3] = rng.normal(0, 0.1, 3) + [0, 0, 0.8]
        else:
            d = Rotation.from_rotvec(rng.normal(0, 0.05, 3)).as_matrix()
            out[i, :3, :3] = d @ near[i % len(near), :3, :3]
            out[i, :3, 3] = near[i % len(near), :3, 3] + rng.normal(0, 0.005, 3)
    return out


@pytest.fixture
def data(rng):
    pts = rng.normal(0, 0.04, (300, 3)).astype(np.float32)
    gt = _poses(rng, 3)
    est = _poses(rng, 3, near=gt)
    valid = np.arange(300) < 250
    return pts, gt, est, valid


@pytest.mark.parametrize("masked", [False, True])
def test_metrics_equal_jax(data, masked):
    pts, gt, est, valid = data
    jv = jnp.asarray(valid) if masked else None
    tv = torch.from_numpy(valid) if masked else None
    t = lambda a: torch.from_numpy(a)
    for jf, tf, tol in ((jev.add_metric, tev.add_metric, 1e-6),
                        (jev.adds_metric, tev.adds_metric, 1e-5)):
        want = np.asarray(jf(jnp.asarray(est), jnp.asarray(gt), jnp.asarray(pts), jv))
        got = tf(t(est), t(gt), t(pts), tv).numpy()
        assert got.shape == (3,)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    # near the truth ADD-S passes the 10%-of-diameter test
    dia = tev.model_diameter(pts)
    assert bool(tev.adds_accuracy(t(est), t(gt), t(pts), dia, model_valid=tv).all())
    np.testing.assert_array_equal(
        tev.adds_accuracy(t(est), t(gt), t(pts), 0.02, model_valid=tv).numpy(),
        np.asarray(jev.adds_accuracy(jnp.asarray(est), jnp.asarray(gt),
                                     jnp.asarray(pts), 0.02, model_valid=jv)))


@pytest.mark.parametrize("case", ["equal_counts", "one_gt", "instances"])
def test_evaluate_poses_equal_jax(data, case):
    """Equal counts pair by index (as the JAX package does, swapped
    estimates included); one ground truth broadcasts; several instances
    score each estimate against its best one."""
    pts, gt, est, _valid = data
    if case == "equal_counts":
        est = est[[1, 0, 2]]            # two swapped estimates fail by index
    elif case == "one_gt":
        gt = gt[:1]
    else:
        est = est[:2]
    want = jev.evaluate_poses(est, gt, pts)
    got = tev.evaluate_poses(est, gt, pts, device="cpu")
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, list):
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5, err_msg=k)
        else:
            assert got[k] == pytest.approx(v, abs=1e-5), k
    if case == "equal_counts":
        assert got["add_pass_rate"] == pytest.approx(1 / 3)
    if case == "instances":
        assert got["num_gt"] == 3 and got["adds_pass_rate"] == 1.0


def test_model_diameter_equal_jax(rng):
    pts = np.array([[0, 0, 0], [0.1, 0, 0], [0.05, 0.02, 0]], np.float32)
    assert tev.model_diameter(pts) == jev.model_diameter(pts)
    # above 4,096 points: the seeded 512-direction reduction, same result
    n = 5000
    u = rng.uniform(0, 2 * np.pi, n)
    v = np.arccos(rng.uniform(-1, 1, n))
    big = np.stack([0.08 * np.sin(v) * np.cos(u), 0.05 * np.sin(v) * np.sin(u),
                    0.03 * np.cos(v)], axis=1).astype(np.float32)
    assert tev.model_diameter(big) == jev.model_diameter(big)
    exact = float(np.sqrt(((big[:, None] - big[None]) ** 2).sum(-1).max()))
    assert tev.model_diameter(big) == pytest.approx(exact, rel=1e-3)


def test_read_pose_file_equal_jax(tmp_path, data):
    _pts, gt, _est, _valid = data
    rows12 = [" ".join(f"{v:.7g}" for v in g[:3].reshape(-1)) for g in gt]
    rows16 = [" ".join(f"{v:.7g}" for v in g.reshape(-1)) for g in gt]
    files = {
        "best.txt": rows12[0] + "\n",
        "clustered.txt": "".join(f"{r} 0.{i + 5}\n" for i, r in enumerate(rows12)),
        "full.txt": "\n".join(rows16) + "\n\n",
        "full_scored.txt": "".join(f"{r} 0.25\n" for r in rows16),
    }
    for name, text in files.items():
        p = tmp_path / name
        p.write_text(text)
        got, want = tev.read_pose_file(str(p)), jev.read_pose_file(str(p))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(tev.read_pose_file(str(tmp_path / "clustered.txt")), gt,
                               atol=1e-6)
    for bad in ("1 2 3\n", ""):
        p = tmp_path / "bad.txt"
        p.write_text(bad)
        with pytest.raises(ValueError):
            tev.read_pose_file(str(p))


def test_evaluate_pose_files_routes(tmp_path, data):
    pts, gt, est, _valid = data
    write = lambda p, ps: p.write_text("".join(
        " ".join(f"{v:.9g}" for v in q[:3].reshape(-1)) + "\n" for q in ps))
    e, g, g2 = tmp_path / "est.txt", tmp_path / "gt.txt", tmp_path / "gt2.txt"
    write(e, est)
    write(g, gt[:1])
    write(g2, gt[:2])
    for kw in ({}, {"gt_poses": gt}):
        got = tev.evaluate_pose_files(str(e), str(g), pts, device="cpu", **kw)
        want = jev.evaluate_pose_files(str(e), str(g), pts, **kw)
        np.testing.assert_allclose(got["adds"], want["adds"], rtol=0, atol=1e-5)
        assert got["num_gt"] == want["num_gt"]
    with pytest.raises(ValueError, match="pose count mismatch"):
        tev.evaluate_pose_files(str(e), str(g2), pts, device="cpu")


def test_bop_loaders_equal_jax(tmp_path, rng):
    gt = _poses(rng, 3)
    entries = [{"cam_R_m2c": g[:3, :3].reshape(-1).tolist(),
                "cam_t_m2c": (g[:3, 3] * 1000).tolist(), "obj_id": oid}
               for g, oid in zip(gt, (1, 2, 1))]
    (tmp_path / "scene_gt.json").write_text(json.dumps({"0": entries, "7": entries[:1]}))
    (tmp_path / "scene_camera.json").write_text(json.dumps({
        "0": {"cam_K": [572.4114, 0, 325.2611, 0, 573.57043, 242.04899, 0, 0, 1],
              "depth_scale": 0.1}, "7": {"cam_K": [1, 0, 2, 0, 3, 4, 0, 0, 1]}}))
    sg = str(tmp_path / "scene_gt.json")
    tg, jg = tbop.load_scene_gt(sg), jbop.load_scene_gt(sg)
    assert tg.keys() == jg.keys() == {0, 7}
    for im in tg:
        for a, b in zip(tg[im], jg[im]):
            assert a["obj_id"] == b["obj_id"]
            np.testing.assert_array_equal(a["pose"], b["pose"])
    two = tbop.gt_poses(tg, 0, 1)
    assert two.shape == (2, 4, 4)
    np.testing.assert_array_equal(two, jbop.gt_poses(jg, 0, 1))
    np.testing.assert_allclose(two[1, :3, 3], gt[2, :3, 3], atol=1e-6)
    with pytest.raises(KeyError, match="obj_id=5"):
        tbop.gt_poses(tg, 0, 5)
    sc = str(tmp_path / "scene_camera.json")
    tc, jc = tbop.load_scene_camera(sc), jbop.load_scene_camera(sc)
    for im in (0, 7):
        np.testing.assert_array_equal(tc[im]["K"], jc[im]["K"])
        assert tc[im]["depth_to_m"] == jc[im]["depth_to_m"]
        assert tc[im]["depth_scale"] == jc[im]["depth_scale"]
        from dataclasses import asdict

        assert asdict(tbop.camera_intrinsics(tc, im)) == asdict(jbop.camera_intrinsics(jc, im))

"""The instance run, the chunked sweep with its checkpoints and pose
clustering of the port against the JAX package, on
__graft_entry__._synthetic_setup's default shapes (320 model points, 1,024
scene points, 16 bases), class mode and instance mode (the same scene laid
on a 64x64 image with an edge wall, synthetic.synthetic_edge_arrays), state
handed over through convert.py.

Tolerances: integers (bases, best index, counts) equal; the decayed prior
bit-equal; LCPs within 1e-5 (float32 sums over ~320 model points in
another order) and world poses within 1e-4 (ICP's 6x6 solves round
differently in the two frameworks), as tests/test_torch_pipeline.py. A
resumed sweep equals the uninterrupted one bit for bit."""

import dataclasses
import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_setup
from model_matching_tpu import estimator as jest
from model_matching_tpu.config import MatchConfig as JConfig
from model_matching_tpu_torch import convert
from model_matching_tpu_torch import estimator as port
from model_matching_tpu_torch.config import MatchConfig as TConfig
from model_matching_tpu_torch.synthetic import synthetic_edge_arrays, synthetic_setup
from sweep_prior import CASES, check_sweep_names_its_prior

CHUNK = 16


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def packs():
    """mode -> (JAX model, JAX scene, cfg, port model, port scene)."""
    model, scene, cfg = _synthetic_setup()
    # the sequential sampler's step block: 8 keeps the JAX scan short
    cfg = dataclasses.replace(cfg, instance_scan_block=8)
    pixel, edge_prob, edge_free = synthetic_edge_arrays(320, 1024, seed=0)
    escene = dataclasses.replace(
        scene, pixel=jnp.asarray(pixel), edge_prob=jnp.asarray(edge_prob),
        edge_free=jnp.asarray(edge_free), has_edge=True)
    tm = convert.model_pack(model)
    return {"class": (model, scene, cfg, tm, convert.scene_pack(scene)),
            "instance": (model, escene, cfg, tm, convert.scene_pack(escene))}


def test_edge_setup_equals_the_converted_scene(packs):
    """synthetic_setup(edge=True) is the scene the tests hand to the JAX
    package."""
    _m, _s, _cfg, _tm, ts = packs["instance"]
    _model, own, _c = synthetic_setup(device="cpu", edge=True)
    assert own.has_edge and ts.has_edge
    for f in ("pixel", "edge_prob", "edge_free", "pos", "class_prob"):
        assert torch.equal(getattr(own, f), getattr(ts, f)), f
    # four points sit on the wall and carry edge probability 1
    on_wall = ~own.edge_free[own.pixel[:, 0].long(), own.pixel[:, 1].long()]
    assert int(on_wall.sum()) == 4 and torch.equal(on_wall, own.edge_prob == 1.0)


@pytest.mark.parametrize("seed", [0, 4])
def test_instance_run_matches_jax(packs, seed):
    model, scene, cfg, tm, ts = packs["instance"]
    je = jest.StocsEstimator(model, scene, cfg)
    jr = je.run(seed=seed, verbose=False)
    te = port.StocsEstimator(tm, ts, cfg)
    tr = te.run(seed=seed, verbose=False)
    assert jr.num_bases == tr.num_bases > 0
    assert jr.num_hypotheses == tr.num_hypotheses
    assert jr.stats["congruent_total"] == tr.stats["congruent_total"]
    assert jr.best_index == tr.best_index >= 0
    assert abs(jr.best_lcp - tr.best_lcp) <= 1e-5
    np.testing.assert_allclose(tr.best_world_transform, jr.best_world_transform,
                               rtol=0, atol=1e-4)
    # the decayed prior stays on the estimator, bit-equal, and scoring
    # read it (not the weights baked into the scene structures)
    np.testing.assert_array_equal(te.class_prob.numpy(), np.asarray(je.class_prob))
    assert te.class_prob is not ts.class_prob and te._score_prob() is te.class_prob
    assert bool((te.class_prob < ts.class_prob).any())
    assert not bool((te.class_prob > ts.class_prob).any())
    np.testing.assert_array_equal(te.seg_masks.numpy(), np.asarray(je.seg_masks))
    np.testing.assert_array_equal(tr.poses.valid.numpy(), np.asarray(jr.poses.valid))
    np.testing.assert_allclose(tr.poses.lcp.numpy(), np.asarray(jr.poses.lcp),
                               rtol=0, atol=1e-5)
    assert tr.stats["unconverged_fills"] == 0
    # a second run on the same estimator starts from the decayed prior
    first = te.class_prob
    te.run(seed=seed, verbose=False)
    assert bool((te.class_prob <= first).all()) and bool((te.class_prob < first).any())


def test_blocked_instance_run_dispatch(packs):
    """cfg.instance_block_size > 1 takes the block-parallel sampler."""
    model, scene, cfg, tm, ts = packs["instance"]
    cfg4 = dataclasses.replace(cfg, instance_block_size=4, number_of_bases=8)
    jr = jest.StocsEstimator(model, scene, cfg4).run(seed=1, verbose=False)
    tr = port.StocsEstimator(tm, ts, cfg4).run(seed=1, verbose=False)
    assert jr.num_bases == tr.num_bases
    assert jr.best_index == tr.best_index
    assert abs(jr.best_lcp - tr.best_lcp) <= 1e-5


@pytest.mark.parametrize("coarse_to_fine", [True, False])
def test_cluster_poses_matches_jax(packs, coarse_to_fine):
    """The ladder's -1 entries are backfilled with dense-field scores, then
    clustered: the same number of clusters, LCPs within 1e-5, poses within
    1e-4; the first cluster is the pool's raw best. This pool (82
    hypotheses) is smaller than the ladder's 256 leaders, so to have
    entries to backfill the coarse-to-fine case drops the exact LCP of
    every second hypothesis but the best, in both packages alike."""
    model, scene, cfg, tm, ts = packs["class"]
    je = jest.StocsEstimator(model, scene, cfg)
    jr = je.run(seed=0, verbose=False, coarse_to_fine=coarse_to_fine)
    te = port.StocsEstimator(tm, ts, cfg)
    tr = te.run(seed=0, verbose=False, coarse_to_fine=coarse_to_fine)
    if coarse_to_fine:
        drop = np.arange(tr.poses.lcp.shape[0]) % 2 == 1
        drop[tr.best_index] = False
        jr = dataclasses.replace(jr, poses=dataclasses.replace(
            jr.poses, lcp=jnp.where(jnp.asarray(drop), -1.0, jr.poses.lcp)))
        tr = dataclasses.replace(tr, poses=dataclasses.replace(
            tr.poses, lcp=torch.where(torch.from_numpy(drop), -1.0, tr.poses.lcp)))
    jt, js = je.cluster_poses(jr)
    tt, tsc = te.cluster_poses(tr)
    assert len(tsc) == len(js) >= 1
    assert tt.dtype == np.float32 and tt.shape == (len(tsc), 4, 4)
    np.testing.assert_allclose(tsc, np.asarray(js), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tt, np.asarray(jt), rtol=0, atol=1e-4)
    assert (tsc >= 0).all() and tsc[0] == tsc.max()
    if coarse_to_fine:
        assert int((tr.poses.lcp >= 0).sum()) < int(tr.poses.valid.sum())


def _sweep(est, **kw):
    return est.run_sweep(64, chunk=CHUNK, keep_per_chunk=16, verbose=False, **kw)


@pytest.fixture(scope="module")
def full_sweeps(packs):
    """mode -> (the JAX package's uninterrupted sweep, the port's, the
    port's estimator afterwards)."""
    out = {}
    for mode, (model, scene, cfg, tm, ts) in packs.items():
        je = jest.StocsEstimator(model, scene, cfg)
        te = port.StocsEstimator(tm, ts, cfg)
        out[mode] = (_sweep(je), _sweep(te), je, te)
    return out


@pytest.mark.parametrize("mode", ["class", "instance"])
def test_sweep_matches_jax(full_sweeps, mode):
    (jl, jw, jct, jcs, jst), (tl, tw, tct, tcs, tst), je, te = full_sweeps[mode]
    assert tst["total_bases"] == jst["total_bases"] == 64
    assert tst["hypotheses"] == jst["hypotheses"] > 50
    assert tst["pair_count_max"] == jst["pair_count_max"]
    assert tst["completed"] is True
    # (instance mode scores under the decayed prior: a lower LCP)
    assert abs(tl - jl) <= 1e-5 and tl > (0.3 if mode == "class" else 0.1)
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-4)
    assert len(tcs) == len(jcs) >= 1
    np.testing.assert_allclose(tcs, np.asarray(jcs), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tct, np.asarray(jct), rtol=0, atol=1e-4)
    # the first cluster is the pool's own best (before the ICP polish)
    assert tcs[0] == np.float32(tst["pool_best_lcp"]) == tcs.max()
    if mode == "instance":
        # the decay was threaded across the four chunks, bit-equal
        np.testing.assert_array_equal(te.class_prob.numpy(), np.asarray(je.class_prob))
        assert bool((te.class_prob < te.scene.class_prob).any())
    else:
        assert te.class_prob is te.scene.class_prob
        # the class sweep sampled through the bit matrix
        assert te._exists_bits is not None
        np.testing.assert_array_equal(te._exists_bits.numpy().view(np.uint32),
                                      np.asarray(je._exists_bits))


def _equal_results(a, b):
    assert a[0] == b[0]
    for x, y in zip(a[1:4], b[1:4]):
        assert np.array_equal(x, y)
    assert a[4]["hypotheses"] == b[4]["hypotheses"]
    assert a[4]["pair_count_max"] == b[4]["pair_count_max"]


@pytest.mark.parametrize("mode", ["class", "instance"])
def test_resumed_sweep_is_bit_identical(packs, full_sweeps, mode, tmp_path):
    """Stopped after one chunk, again after two more, then finished, each
    time by a fresh estimator: equal to the uninterrupted sweep bit for bit
    (pool best, best pose, clusters, the decayed prior)."""
    _m, _s, cfg, tm, ts = packs[mode]
    ref, ref_est = full_sweeps[mode][1], full_sweeps[mode][3]
    ckpt = str(tmp_path / "sweep.ckpt.npz")
    part = _sweep(port.StocsEstimator(tm, ts, cfg), checkpoint_path=ckpt,
                  stop_after_chunks=1)
    assert part[4]["completed"] is False and part[4]["next_chunk"] == 1
    assert part[4]["total_bases"] == CHUNK
    with np.load(ckpt) as z:
        assert int(z["version"]) == 3 and int(z["next_chunk"]) == 1
        assert z["pool_s"].shape == (1, 16) and z["pool_t"].shape == (1, 16, 4, 4)
        assert z["pool_s"].dtype == np.float32 and z["chunk_valid"].dtype == np.int32
        assert bool(z["prob_decayed"]) == (mode == "instance")
        assert ("class_prob" in z.files) == (mode == "instance")
    part = _sweep(port.StocsEstimator(tm, ts, cfg), checkpoint_path=ckpt,
                  checkpoint_every=1, stop_after_chunks=2)
    assert part[4]["next_chunk"] == 3
    last = port.StocsEstimator(tm, ts, cfg)
    res = _sweep(last, checkpoint_path=ckpt)
    assert res[4]["completed"] is True
    assert not (tmp_path / "sweep.ckpt.npz").exists()
    _equal_results(res, ref)
    assert torch.equal(last.class_prob, ref_est.class_prob)


def test_mismatched_checkpoint_is_refused(packs, tmp_path):
    _m, _s, cfg, tm, ts = packs["class"]
    ckpt = str(tmp_path / "sweep.ckpt.npz")
    est = port.StocsEstimator(tm, ts, cfg)
    _sweep(est, checkpoint_path=ckpt, stop_after_chunks=1)
    with pytest.raises(ValueError, match="seed"):
        _sweep(est, checkpoint_path=ckpt, seed=123)
    with pytest.raises(ValueError, match="chunk"):
        est.run_sweep(64, chunk=8, keep_per_chunk=16, verbose=False,
                      checkpoint_path=ckpt)
    with pytest.raises(ValueError, match="keep_per_chunk"):
        est.run_sweep(64, chunk=CHUNK, keep_per_chunk=8, verbose=False,
                      checkpoint_path=ckpt)
    other = port.StocsEstimator(
        tm, ts, dataclasses.replace(cfg, cluster_min_angle=10.0))
    with pytest.raises(ValueError, match="fingerprint"):
        _sweep(other, checkpoint_path=ckpt)
    _m, _s, _c, _tm, ets = packs["instance"]
    with pytest.raises(ValueError, match="instance/class"):
        _sweep(port.StocsEstimator(tm, ets, cfg), checkpoint_path=ckpt)
    # a checkpoint that is already past what this call asks for
    two = str(tmp_path / "two.ckpt.npz")
    _sweep(est, checkpoint_path=two, stop_after_chunks=2)
    with pytest.raises(ValueError, match="already"):
        est.run_sweep(CHUNK, chunk=CHUNK, keep_per_chunk=16, verbose=False,
                      checkpoint_path=two)


def test_version_1_checkpoint_loads(packs, full_sweeps, tmp_path):
    """A version-1 file (no chunk_slot_valid, no devices, no pair_max)
    resumes; the missing counts fall back to the fit-valid ones."""
    _m, _s, cfg, tm, ts = packs["class"]
    ckpt = str(tmp_path / "sweep.ckpt.npz")
    _sweep(port.StocsEstimator(tm, ts, cfg), checkpoint_path=ckpt,
           stop_after_chunks=2)
    with np.load(ckpt) as z:
        arrays = {k: z[k] for k in z.files
                  if k not in ("chunk_slot_valid", "devices", "pair_max")}
    arrays["version"] = np.int64(1)
    with open(ckpt, "wb") as f:
        np.savez(f, **arrays)
    res = _sweep(port.StocsEstimator(tm, ts, cfg), checkpoint_path=ckpt)
    ref = full_sweeps["class"][1]
    assert res[4]["completed"] is True
    assert res[0] == ref[0]
    assert np.array_equal(res[1], ref[1]) and np.array_equal(res[2], ref[2])
    arrays["version"] = np.int64(7)
    with open(ckpt, "wb") as f:
        np.savez(f, **arrays)
    with pytest.raises(ValueError, match="unsupported version 7"):
        _sweep(port.StocsEstimator(tm, ts, cfg), checkpoint_path=ckpt)


def test_port_resumes_a_jax_checkpoint(packs, full_sweeps, tmp_path):
    """The file format is shared: a sweep the JAX package stopped after two
    chunks is finished by the port, to the JAX package's result within the
    float tolerances."""
    model, scene, cfg, tm, ts = packs["class"]
    ckpt = str(tmp_path / "sweep.ckpt.npz")
    _sweep(jest.StocsEstimator(model, scene, cfg), checkpoint_path=ckpt,
           stop_after_chunks=2)
    res = _sweep(port.StocsEstimator(tm, ts, cfg), checkpoint_path=ckpt)
    jl, jw, _jct, jcs, jst = full_sweeps["class"][0]
    assert res[4]["completed"] is True and res[4]["hypotheses"] == jst["hypotheses"]
    assert abs(res[0] - jl) <= 1e-5
    np.testing.assert_allclose(res[1], jw, rtol=0, atol=1e-4)
    np.testing.assert_allclose(res[3], np.asarray(jcs), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kw", [
    {}, {"number_of_bases": 2048, "seed": 7},
    {"cluster_symmetry": (0.0, 90.0, 360.0), "refine_best_pose": False}])
def test_config_fingerprint_equals_jax(kw):
    """The same string from both packages' config classes: a checkpoint
    written by one validates in the other."""
    assert (port._sweep_cfg_fingerprint(TConfig(**kw))
            == jest._sweep_cfg_fingerprint(JConfig(**kw)))
    assert (port._sweep_cfg_fingerprint(TConfig(**kw))
            != port._sweep_cfg_fingerprint(TConfig(**{**kw, "voxel_size": 0.123})))


# the four recall warnings of a sweep: a phrase of each text, and its fields
RECALL_WARNINGS = {
    "unconverged": ("flood fills across the", {"n_unconverged", "sweeps"}),
    "overflow": ("congruent-valid hypothesis slots", {"n_valid", "cap"}),
    "pairs": ("a PPF bin held", {"pair_max", "cap"}),
    "shortfall": ("saturated bases kept fewer", {"n_short", "oversample"}),
}


@pytest.fixture(scope="module")
def warned_sweeps():
    """path -> (the recall warnings' fields by kind, stats) of an instance
    sweep on the one-card path and over a mesh of two CPU ranks, under a
    config that costs recall four ways: 256 pairs per bin below the scene's
    largest bin; score_compact_cap 32 below a chunk's congruent-valid
    slots; one flood-fill sweep on a serpentine edge map (walls across
    every fourth row, each open at alternate ends), whose fills need
    several; and congruent_cone_oversample 1. The synthetic bins hold at
    most ~1,400 pairs, below the 4,096-pair tier that takes the dense gate
    and its exact-cone re-check, so the fixture lowers that tier's floor
    to 256 pairs: only there can a base keep fewer sets than it matched."""
    from model_matching_tpu_torch import congruent
    from model_matching_tpu_torch.parallel.dcn_worker import edge_scene
    from model_matching_tpu_torch.parallel.sharding import make_mesh, run_sweep_sharded
    from model_matching_tpu_torch.utils.log import get_logger

    model, scene, cfg = synthetic_setup(num_model=128, num_scene=512, max_pairs=256,
                                        max_congruent=64, device="cpu")
    scene = edge_scene(scene, seed=17)
    h, w = scene.edge_free.shape
    serpentine = torch.ones(h, w, dtype=torch.bool)
    for i, row in enumerate(range(3, h, 4)):
        serpentine[row] = False
        serpentine[row, w - 2 if i % 2 == 0 else 1] = True
    scene = dataclasses.replace(scene, edge_free=serpentine)
    cfg = dataclasses.replace(cfg, score_compact_cap=32, flood_fill_sweeps=1,
                              congruent_cone_oversample=1)
    kw = dict(total_bases=32, chunk=16, keep_per_chunk=16, seed=3, verbose=False)
    runs = {
        "one-card": lambda: port.StocsEstimator(model, scene, cfg).run_sweep(**kw),
        "sharded": lambda: run_sweep_sharded(make_mesh(["cpu"] * 2), model, scene,
                                             cfg, **kw),
    }
    messages = []

    class Keep(logging.Handler):
        def emit(self, record):
            if record.levelno == logging.WARNING:
                messages.append(record.getMessage())

    handler = Keep()
    get_logger().addHandler(handler)
    out = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(congruent, "_PALLAS_MIN_CAP", 256)
            for path, run in runs.items():
                del messages[:]
                stats = run()[4]
                fields = {}
                for msg in messages:
                    text, _, tail = msg.rpartition(" {")
                    for kind, (phrase, _names) in RECALL_WARNINGS.items():
                        if phrase in text:
                            assert kind not in fields, msg
                            fields[kind] = json.loads("{" + tail)
                out[path] = fields, stats
    finally:
        get_logger().removeHandler(handler)
    return out, cfg


@pytest.mark.parametrize("path", ["one-card", "sharded"])
def test_sweep_recall_warnings(warned_sweeps, path):
    """Both sweeps warn of each of the four recall costs once, with the
    same structured fields; the sampled bases are the same on both paths,
    so the pair maximum and the unconverged fills agree, and the stats
    carry the pair maximum the warning names."""
    out, cfg = warned_sweeps
    fields, stats = out[path]
    assert set(fields) == set(RECALL_WARNINGS)
    for kind, (_phrase, names) in RECALL_WARNINGS.items():
        assert set(fields[kind]) == names, kind
    assert fields["unconverged"]["sweeps"] == cfg.flood_fill_sweeps == 1
    assert fields["overflow"]["cap"] == cfg.score_compact_cap
    assert fields["overflow"]["n_valid"] > cfg.score_compact_cap
    assert fields["pairs"]["cap"] == cfg.max_pairs_per_bin
    assert fields["pairs"]["pair_max"] > cfg.max_pairs_per_bin
    assert fields["shortfall"]["oversample"] == 1 and fields["shortfall"]["n_short"] > 0
    assert stats["pair_count_max"] == fields["pairs"]["pair_max"]
    assert stats["completed"] is True and stats["total_bases"] == 32
    other = out["sharded" if path == "one-card" else "one-card"][0]
    for kind, name in (("pairs", "pair_max"), ("unconverged", "n_unconverged")):
        assert fields[kind][name] == other[kind][name] > 0, kind


@pytest.mark.parametrize("path,dispersion,seed", list(CASES))
def test_sweep_names_the_prior_that_scored_it(path, dispersion, seed, tmp_path):
    """The sweep names the chunk of its best entry, whether the ICP polish
    replaced it, and the prior that scored the LCP it returns
    (tests/sweep_prior.py)."""
    check_sweep_names_its_prior("cpu", path, dispersion, seed, tmp_path)


@pytest.mark.parametrize("path", ["one-card", "sharded"])
def test_both_sweeps_name_their_best_chunk(warned_sweeps, path):
    """The sharded sweep's stats name the best chunk and the polish's
    outcome as the one-card sweep's do."""
    stats = warned_sweeps[0][path][1]
    assert stats["best_chunk"] in (0, 1) and stats["best_refined"] in (False, True)

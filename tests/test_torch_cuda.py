"""The port on an NVIDIA card. Every test here is marked `cuda` and skips
without a card. The file imports no jax, so it also runs on a machine that
has the card and no jax (the suite's conftest.py imports jax, hence
--noconftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

It holds the dense-gate and row-gather kernels to their plain versions
bit for bit, the estimator on the card to the estimator on the CPU with
every base in a dense congruent tier, and scene ingest (the grids and
the field built on the card too), model preprocessing and align_models'
table rebuilds on the card to the same on the CPU; and it runs the check
that a sweep names the prior that scored its answer
(tests/sweep_prior.py) on the card."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from model_matching_tpu_torch import congruent
from model_matching_tpu_torch.estimator import StocsEstimator
from model_matching_tpu_torch.ops import dense_gate as tdg
from model_matching_tpu_torch.ops import row_gather as trg
from model_matching_tpu_torch.synthetic import GATE_CELL_CASES, gate_cells, synthetic_setup
from model_matching_tpu_torch.utils import trace
from sweep_prior import CASES, check_sweep_names_its_prior

MASK = 0x7FFFFFFF & ~((1 << 15) - 1)
MARKER = 1 << 14


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("p,q,q_tile,n_sub,check_cos,cells", [
    pytest.param(512, 1024, 512, 16, True, None, id="512-1024-512-16-True"),
    # a partial P tile, 520-column Q tiles, 8 stripes
    pytest.param(600, 1040, 520, 8, True, None, id="600-1040-520-8-True"),
    # the cone test off (a negative cos tolerance)
    pytest.param(600, 1040, 520, 8, False, None, id="600-1040-520-8-False"),
    # cell distributions that could break the kernel's bucketed scan, on Q
    # tiles of 2,600 columns (two slabs; 256 does not divide them), 8 stripes
    *[pytest.param(700, 5200, 2600, 8, True, kind, id=f"cells-{kind}")
      for kind in GATE_CELL_CASES],
])
def test_kernel_matches_plain_on_cuda(p, q, q_tile, n_sub, check_cos, cells):
    dev = _card()
    g = torch.Generator().manual_seed(1)
    b = 2
    pf = torch.randn(b, 8, p, generator=g) * 0.05
    qf = torch.randn(b, 8, q, generator=g) * 0.05
    if cells is None:
        pc = torch.randint(0, 4, (b, p), generator=g, dtype=torch.int32)
        qc = torch.randint(0, 4, (b, q), generator=g, dtype=torch.int32)
    else:
        rng = np.random.default_rng(2)
        pc = torch.from_numpy(np.stack([gate_cells(cells, rng, p) for _ in range(b)]))
        qc = torch.from_numpy(np.stack([gate_cells(cells, rng, q) for _ in range(b)]))
    # the valid Q lanes of the first base end inside a slab of the last tile
    q_valid = q - q_tile // 3
    qc[0, q_valid:] = -2
    rp = torch.randint(-2**31, 2**31 - 1, (b, p), generator=g).to(torch.int32)
    rq = torch.randint(-2**31, 2**31 - 1, (b, q), generator=g).to(torch.int32)
    alpha = torch.rand(b, generator=g)
    live = torch.randint(0, 2, (b, -(-p // 256), q // q_tile), generator=g,
                         dtype=torch.int32)
    args = [t.to(dev) for t in (pf, qf, pc, qc, rp, rq, alpha)]
    for skip in (False, True):
        kw = dict(q_tile=q_tile, skip_dist=skip,
                  p_count=torch.tensor([p, 300], dtype=torch.int32, device=dev),
                  q_count=torch.tensor([q_valid, 1], dtype=torch.int32, device=dev),
                  live=live.to(dev), n_sub=n_sub, check_cos=check_cos)
        before = trace.total("k1.launches")
        got = tdg.dense_gate(*args, 2.0, 0.01, MASK, MARKER, **kw)
        assert trace.total("k1.launches") == before + 1
        ref = tdg.dense_gate_reference(*args, 2.0, 0.01, MASK, MARKER, **kw)
        for a, r in zip(got, ref):
            assert torch.equal(a, r)
        assert int(ref[1].sum()) > 0


@pytest.mark.cuda
def test_gate_rows_is_the_launchers_height():
    """gate_rows: a multiple of 16 in [64, 128], the height at which all of
    a launch's blocks are resident (two an SM), and never below it."""
    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b, p in ((1, 26112), (8, 26112), (680, 8704), (1, 600)):
        rows = tdg.gate_rows(b, p, dev)
        assert rows % 16 == 0 and 64 <= rows <= 128
        assert rows == 128 or -(-p // rows) * b <= 2 * sms or rows == 64


@pytest.mark.cuda
def test_estimator_cuda_matches_cpu(monkeypatch):
    """StocsEstimator.run on the card against the CPU at a small size, with
    every base sent to the top tier and that tier made dense, so the card
    runs the kernel. Required: the same best index, valid hypotheses,
    scored leaders, and the same bits in every fitted transform and LCP
    (the port pins its rounding: ops/fp.py); the refined world pose within
    1e-4 (ICP's 6x6 solve rounds differently on the two devices)."""
    dev = _card()
    monkeypatch.setattr(congruent, "_PALLAS_MIN_CAP", 256)
    top_of = congruent.tier_plan
    monkeypatch.setattr(congruent, "tier_plan",
                        lambda p_cap: ([], top_of(p_cap)[1]))
    model, scene, cfg = synthetic_setup(num_model=320, num_scene=1024,
                                        num_bases=16, max_pairs=512,
                                        max_congruent=32, seed=0, device="cpu")
    cpu = StocsEstimator(model, scene, cfg).run(seed=1, verbose=False)
    before = trace.total("k1.launches")
    gpu = StocsEstimator(model.to(dev), scene.to(dev), cfg).run(seed=1,
                                                                verbose=False)
    assert trace.total("k1.launches") > before
    assert gpu.best_index == cpu.best_index >= 0
    assert abs(gpu.best_lcp - cpu.best_lcp) <= 1e-5
    assert torch.equal(gpu.poses.valid.cpu(), cpu.poses.valid)
    assert torch.equal(gpu.poses.transform.cpu(), cpu.poses.transform)
    assert torch.equal(gpu.poses.lcp.cpu(), cpu.poses.lcp)
    assert abs(gpu.best_world_transform - cpu.best_world_transform).max() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c,n_idx", [
    (8, 128, 8), (4096, 128, 512),   # the TPU probe's smallest and largest
    (200000, 8, 70000),              # dense-field rows
    (3000, 320, 9000),               # payload rows, cell_cap 40
    (5000, 6, 777),                  # C % 4 != 0: the scalar path
])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_row_gather_kernel_matches_plain_on_cuda(rows, c, n_idx, dtype):
    dev = _card()
    g = torch.Generator().manual_seed(rows)
    tab = torch.randn(rows, c, generator=g).to(dev)
    idx = torch.randint(0, rows, (n_idx,), generator=g).to(dtype).to(dev)
    before = trace.total("k2.launches")
    got = trg.row_gather(tab, idx)
    assert trace.total("k2.launches") == before + 1
    assert torch.equal(got, trg.row_gather_reference(tab, idx))
    # a table view 4 bytes off 16-byte alignment takes the scalar path
    flat = torch.randn(rows * c + 1, generator=g).to(dev)
    view = flat[1:].view(rows, c)
    idx2 = idx.view(-1, 1)
    assert torch.equal(trg.row_gather(view, idx2), trg.row_gather_reference(view, idx2))


@pytest.mark.cuda
def test_ingest_and_preprocess_card_equal_cpu(tmp_path):
    """load_scene and preprocess_model give the same bits on the card as
    on the CPU (320x240 synthetic scene)."""
    from model_matching_tpu_torch.io import ply
    from model_matching_tpu_torch.config import PreprocessConfig
    from model_matching_tpu_torch.preprocess import preprocess_model
    from model_matching_tpu_torch.scene import load_scene
    from model_matching_tpu_torch.synthetic import write_synthetic_scene

    dev = _card()
    scene_dir, cfg, _gt = write_synthetic_scene(str(tmp_path), scale=0.5)
    paths = [os.path.join(scene_dir, n) for n in
             ("rgb.png", "depth.png", "probability_maps/synthetic_shell.png")]
    cpu = load_scene(*paths, None, cfg, device="cpu")
    gpu = load_scene(*paths, None, cfg, device=dev)
    assert int(cpu.count()) > 2000
    for f in ("valid", "pos", "normal", "class_prob", "pixel", "rgb", "centroid"):
        assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)), f
    assert torch.equal(gpu.field.rows.cpu(), cpu.field.rows)
    assert torch.equal(gpu.grid.payload.cpu(), cpu.grid.payload)
    src = os.path.join(str(tmp_path), "models", "synthetic_shell", "textured_vertices.ply")
    out = {}
    for name, d in (("cpu", "cpu"), ("gpu", dev)):
        m, t = str(tmp_path / f"{name}.ply"), str(tmp_path / f"{name}.npz")
        preprocess_model(src, m, t, PreprocessConfig(), verbose=False, device=d)
        out[name] = (ply.read_ply(m), dict(np.load(t)))
    for part in (0, 1):
        a, b = out["cpu"][part], out["gpu"][part]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["ycb", "packed"])
def test_scene_build_card_equal_cpu(tmp_path, monkeypatch, config):
    """On one full-size benchmark frame of each preset, load_scene builds
    both grids and the field on the card equal bit for bit to the CPU build
    of the same ingested lanes; its only device syncs are its counted
    reads, which move under 64 KB."""
    import json
    import warnings

    from model_matching_tpu_torch.ops.densefield import build_dense_field
    from model_matching_tpu_torch.ops.gridhash import build_neighbor_grid
    from model_matching_tpu_torch.scene import load_scene

    dev = _card()
    bench = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "benchmark")
    monkeypatch.syspath_prepend(bench)
    import frames
    import loops

    with open(os.path.join(bench, "configs", f"{config}.json")) as f:
        spec = json.load(f)
    cfg = loops.match_config(spec["match"])
    kind = spec["scene"]["kind"]
    fr = frames.write_frame(str(tmp_path), kind, 0, 0, cfg.camera.as_tuple(),
                            cfg.image_width, cfg.image_height, cfg.depth_scale,
                            cfg.probability_scale, spec["scene"]["edge"])
    rgb, depth, probs, edge = fr.paths(frames.object_names(kind))
    load_scene(rgb, depth, probs[0], edge, cfg, device=dev)       # warm
    mark = trace.mark()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            sc = load_scene(rgb, depth, probs[0], edge, cfg, device=dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    builders = ("gridhash.py", "densefield.py")
    assert not [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
                if os.path.basename(w.filename) in builders]
    entries = trace.snapshot(mark).entries
    (build,) = [e.seq for e in entries if e.kind == "span" and e.name == "scene.build"]
    reads = [e.n for e in entries if e.kind == "count" and e.parent == build
             and e.name == "host_reads"]
    (copied,) = [e.n for e in entries if e.kind == "count"
                 and e.name == "scene.build_copy_bytes"]
    assert 1 <= len(reads) <= 16 and 0 < copied < 64 << 10
    n = int(sc.count())
    assert n > 5000
    pos, nrm, prob = (t[:n].cpu() for t in (sc.pos, sc.normal, sc.class_prob))
    cpu = dict(
        grid=build_neighbor_grid(pos, cfg.distance_threshold, normal=nrm, prob=prob),
        field=build_dense_field(pos, nrm, cfg.distance_threshold, prob=prob),
        icp_grid=build_neighbor_grid(pos, cfg.icp_max_corr_dist))
    for name, want in cpu.items():
        got = getattr(sc, name)
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if isinstance(b, torch.Tensor):
                assert a.device.type == "cuda" and torch.equal(a.cpu(), b), (name, f.name)
            else:
                assert a == b, (name, f.name)


@pytest.mark.cuda
def test_align_models_card_equal_cpu(tmp_path, monkeypatch):
    """align_models over the ycb.multi3 cell's three shells, loaded
    standardized, rebuilds every table on the card equal bit for bit to
    the CPU's rebuild (arrays and both probe bounds), reading under 64 KB
    to the host for the call."""
    import json

    from model_matching_tpu_torch.config import PreprocessConfig
    from model_matching_tpu_torch.model import load_model_pack
    from model_matching_tpu_torch.multi import align_models
    from model_matching_tpu_torch.preprocess import preprocess_model

    dev = _card()
    bench = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "benchmark")
    monkeypatch.syspath_prepend(bench)
    import frames

    with open(os.path.join(bench, "configs", "ycb.json")) as f:
        spec = json.load(f)
    frames.write_models(str(tmp_path), "shells3", spec["scene"]["source_points"])
    packs = {"cpu": [], "card": []}
    for name in frames.object_names("shells3"):
        d = os.path.join(str(tmp_path), "models", name)
        paths = (os.path.join(d, "model_search.ply"), os.path.join(d, "ppf_table.npz"))
        preprocess_model(os.path.join(d, "textured_vertices.ply"), *paths,
                         PreprocessConfig(**spec["preprocess"]), verbose=False, device=dev)
        for side, where in (("cpu", "cpu"), ("card", dev)):
            packs[side].append(load_model_pack(*paths, spec["match"]["max_model_points"],
                                               standardize=True, device=where))
    cpu = align_models(packs["cpu"])
    align_models(packs["card"])                                   # warm
    bytes0, resizes0 = trace.total("host_read_bytes"), trace.total("ppf_table.resizes")
    card = align_models(packs["card"])
    assert trace.total("host_read_bytes") - bytes0 < 64 << 10
    assert trace.total("ppf_table.resizes") - resizes0 == 3
    for c, g in zip(cpu, card):
        for f in ("pos", "pair_ep"):
            assert torch.equal(getattr(g, f).cpu(), getattr(c, f)), f
        for f in ("exist_keys", "bin_keys", "bin_offset", "bin_count", "pairs",
                  "bin_direct", "exist_direct"):
            a = getattr(g.table, f)
            assert a.device.type == "cuda" and torch.equal(a.cpu(), getattr(c.table, f)), f
        for f in ("exist_max_probes", "bin_max_probes"):
            assert getattr(g.table, f) == getattr(c.table, f), f


@pytest.mark.cuda
def test_flood_and_instance_sampler_card_equal_cpu():
    """Flood fills (both modes, a batch of seeds) and the sequential
    instance sampler give the same masks, bases and decayed prior on the
    card as on the CPU: every field bit for bit, over bases that cross a
    noise block, with every base after the first replayed from three CUDA
    graphs and as many flood fills as the CPU's eager loop."""
    from model_matching_tpu_torch import flood, instance, rng

    dev = _card()
    g = np.random.default_rng(0)
    edge_free = g.random((120, 160)) > 0.08
    edge_free[60, :] = False
    seeds = torch.from_numpy(np.argwhere(edge_free)[::900][:8].astype(np.int32))
    radii = torch.linspace(5.0, 90.0, seeds.shape[0])
    ef = torch.from_numpy(edge_free)
    for kw in (dict(fixed_sweeps=8), dict(max_iters=64)):
        cm, cc = flood.flood_fill(seeds, ef, radii, return_converged=True, **kw)
        gm, gc = flood.flood_fill(seeds.to(dev), ef.to(dev), radii.to(dev),
                                  return_converged=True, **kw)
        assert torch.equal(gm.cpu(), cm) and torch.equal(gc.cpu(), cc)
        assert int(cm.sum()) > 8

    model, scene, cfg = synthetic_setup(device="cpu", edge=True)
    m_g, s_g = model.to(dev), scene.to(dev)

    def sample(m, s):
        return instance.sample_instance_bases_stepwise(
            rng.PRNGKey(3), m.table, s.pos, s.normal, s.class_prob, s.edge_prob,
            s.pixel, s.valid, s.edge_free, num_bases=12, dispersion=0.9,
            tr_disc=cfg.ppf_tr_discretization, rot_disc=cfg.ppf_rot_discretization,
            plane_threshold=cfg.plane_threshold,
            min_distance_base=cfg.min_distance_base,
            internal_angle_threshold=cfg.internal_angle_threshold,
            flood_sweeps=8, block=5)

    names = ("instance.graph_captures", "instance.graph_replays", "instance.flood_fills")

    def counted(m, s):
        before = [trace.total(k) for k in names]
        out = sample(m, s)
        return out, [trace.total(k) - b for k, b in zip(names, before)]

    cpu, (c_captures, c_replays, c_fills) = counted(model, scene)
    assert bool(cpu.valid.any()) and c_captures == c_replays == 0
    card, (captures, replays, fills) = counted(m_g, s_g)
    assert (captures, replays, fills) == (3, 11, c_fills)
    for f in instance.InstanceSamples._fields:
        assert torch.equal(getattr(cpu, f), getattr(card, f).cpu()), f


@pytest.mark.cuda
def test_instance_run_and_sweep_card_equal_cpu(tmp_path):
    """The instance run and a checkpointed class sweep on the card against
    the CPU: the same bases, best index and decayed prior, LCPs within
    1e-5, poses within 1e-4, the same number of clusters; both kernels
    launched."""
    dev = _card()
    model, scene, cfg = synthetic_setup(device="cpu", edge=True)
    ce = StocsEstimator(model, scene, cfg)
    cpu = ce.run(seed=2, verbose=False)
    ge = StocsEstimator(model.to(dev), scene.to(dev), cfg)
    gates, gathers = trace.total("k1.launches"), trace.total("k2.launches")
    gpu = ge.run(seed=2, verbose=False)
    assert trace.total("k2.launches") > gathers
    assert gpu.best_index == cpu.best_index >= 0
    assert abs(gpu.best_lcp - cpu.best_lcp) <= 1e-5
    assert torch.equal(ge.class_prob.cpu(), ce.class_prob)
    assert torch.equal(ge.seg_masks.cpu(), ce.seg_masks)
    assert torch.equal(gpu.poses.lcp.cpu(), cpu.poses.lcp)
    assert abs(gpu.best_world_transform - cpu.best_world_transform).max() <= 1e-4
    assert len(ge.cluster_poses(gpu)[1]) == len(ce.cluster_poses(cpu)[1]) >= 1

    model, scene, cfg = synthetic_setup(device="cpu")
    kw = dict(chunk=16, keep_per_chunk=16, verbose=False)
    cpu = StocsEstimator(model, scene, cfg).run_sweep(48, **kw)
    ckpt = str(tmp_path / "sweep.npz")
    m_g, s_g = model.to(dev), scene.to(dev)
    part = StocsEstimator(m_g, s_g, cfg).run_sweep(
        48, checkpoint_path=ckpt, stop_after_chunks=2, **kw)
    assert part[4]["next_chunk"] == 2 and os.path.exists(ckpt)
    gpu = StocsEstimator(m_g, s_g, cfg).run_sweep(48, checkpoint_path=ckpt, **kw)
    assert gpu[4]["completed"] and not os.path.exists(ckpt)
    whole = StocsEstimator(m_g, s_g, cfg).run_sweep(48, **kw)
    assert gpu[0] == whole[0] and np.array_equal(gpu[1], whole[1])
    assert np.array_equal(gpu[2], whole[2]) and np.array_equal(gpu[3], whole[3])
    assert abs(gpu[0] - cpu[0]) <= 1e-5 and gpu[4]["hypotheses"] == cpu[4]["hypotheses"]
    assert abs(gpu[1] - cpu[1]).max() <= 1e-4 and len(gpu[3]) == len(cpu[3])
    assert trace.total("k1.launches") >= gates


@pytest.mark.cuda
@pytest.mark.parametrize("path,dispersion,seed", list(CASES))
def test_sweep_names_the_prior_that_scored_it_on_the_card(path, dispersion, seed, tmp_path):
    """tests/sweep_prior.py's check on the card, with its CPU numbers."""
    check_sweep_names_its_prior(_card(), path, dispersion, seed, tmp_path)


@pytest.mark.cuda
def test_spans_on_the_card_profilers_clock():
    """On the card: a profiler capture of a run holds no `mm.*` range unless
    annotate(True) is set; under it, each range starts within 1 ms of its
    span's start mapped by to_profiler_ns, and a span with `sync` waits for
    the device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = _card()
    model, scene, cfg = synthetic_setup(num_model=128, num_scene=512, num_bases=16,
                                        max_pairs=256, max_congruent=16, device=dev)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    StocsEstimator(model, scene, cfg).run(verbose=False)
    with profile(activities=acts) as prof:
        StocsEstimator(model, scene, cfg).run(verbose=False)
        torch.cuda.synchronize()
    assert not [e for e in prof.profiler.kineto_results.events()
                if e.name().startswith("mm.")]
    rec = trace.Recorder()
    rec.annotate(True)
    x = torch.randn(1 << 22, device=dev)
    with profile(activities=acts) as prof:
        for i in range(4):
            with rec.span(f"probe{i}", sync=dev):
                for _ in range(20):
                    x = x * 1.0001
    spans = {s.name: s for s in rec.snapshot().entries}
    host = {e.name()[3:]: e for e in prof.profiler.kineto_results.events()
            if e.name().startswith("mm.") and e.device_type() != DeviceType.CUDA}
    for name in ("probe2", "probe3"):
        assert abs(host[name].start_ns() - trace.to_profiler_ns(spans[name].t0)) < 1_000_000
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and not e.name().startswith("mm.")]
    last = max(kernels, key=lambda e: e.start_ns() + e.duration_ns())
    # the span ended after the device's last kernel of it
    assert trace.to_profiler_ns(spans["probe3"].t1) >= last.start_ns() + last.duration_ns() - 1_000_000


# ------------------------------------------- the instance sampler's kernel

def _sample_kwargs(cfg, bases, dispersion, block):
    return dict(num_bases=bases, dispersion=dispersion, tr_disc=cfg.ppf_tr_discretization,
                rot_disc=cfg.ppf_rot_discretization, plane_threshold=cfg.plane_threshold,
                min_distance_base=cfg.min_distance_base,
                internal_angle_threshold=cfg.internal_angle_threshold, block=block)


@pytest.fixture(scope="module")
def packed_frame(tmp_path_factory):
    """A full-size packed frame of benchmark/frames.py (layout 3) and the
    box's unstandardized pack, on the card, and the preset's config;
    with the same frame at 24,576 lanes (N above 16,384, where the
    kernels' grid stops growing and a thread takes several points)."""
    import json
    import sys

    from model_matching_tpu_torch.config import PreprocessConfig
    from model_matching_tpu_torch.model import load_model_pack
    from model_matching_tpu_torch.preprocess import preprocess_model
    from model_matching_tpu_torch.scene import load_scene

    dev = _card()
    bench = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "benchmark")
    sys.path.insert(0, bench)
    try:
        import frames
        import loops
    finally:
        sys.path.remove(bench)
    root = str(tmp_path_factory.mktemp("packed"))
    with open(os.path.join(bench, "configs", "packed.json")) as f:
        spec = json.load(f)
    cfg = loops.match_config(spec["match"])
    fr = frames.write_frame(root, "bin", 3, 0, cfg.camera.as_tuple(), cfg.image_width,
                            cfg.image_height, cfg.depth_scale, cfg.probability_scale, True)
    frames.write_models(root, "bin", spec["scene"]["source_points"])
    d = os.path.join(root, "models", "box")
    preprocess_model(os.path.join(d, "textured_vertices.ply"),
                     os.path.join(d, "model_search.ply"), os.path.join(d, "ppf_table.npz"),
                     PreprocessConfig(**spec["preprocess"]), verbose=False, device=dev)
    model = load_model_pack(os.path.join(d, "model_search.ply"),
                            os.path.join(d, "ppf_table.npz"), cfg.max_model_points,
                            standardize=False, device=dev)
    rgb, depth, probs, edge = fr.paths(["box"])
    scene = load_scene(rgb, depth, probs[0], edge, cfg, device=dev)
    wide = load_scene(rgb, depth, probs[0], edge,
                      dataclasses.replace(cfg, max_scene_points=24576), device=dev)
    return model, scene, wide, cfg


def _instance_case(name, packed_frame):
    """(model, scene, cfg, table, exists_bits, dispersion) of a named case."""
    from model_matching_tpu_torch import sampling

    if name.startswith("packed"):
        model, scene, wide, cfg = packed_frame
        if name == "packed-wide":
            scene = wide
    else:
        model, scene, cfg = synthetic_setup(device=_card(), edge=True)
    table, bits, disp = model.table, None, 0.9
    if name.endswith("probe"):
        table = dataclasses.replace(table, exist_direct=None, bin_direct=None)
    if name.endswith("bits"):
        bits = sampling.build_exists_bits(table, scene.pos, scene.normal,
                                          cfg.ppf_tr_discretization,
                                          cfg.ppf_rot_discretization)
    if name.endswith("disp1"):
        disp = 1.0
    return model, scene, cfg, table, bits, disp


INSTANCE_CASES = ("synthetic", "synthetic-disp1", "synthetic-bits", "synthetic-probe",
                  "packed", "packed-disp1", "packed-probe", "packed-bits", "packed-wide")


@pytest.mark.cuda
@pytest.mark.parametrize("case", INSTANCE_CASES)
def test_base_rounds_kernel_equals_plain_parts_step_by_step(case, packed_frame):
    """The kernel's `pre` and `post` against the plain torch parts on the
    same card tensors, base by base (a flood fill or a cached mask in
    between, as the sampler does): after every part the whole state, the
    decayed prior, the weights, the draws, `max_pix_dist`, the claim, the
    masks and the output rows, equal bit for bit."""
    from model_matching_tpu_torch import flood, instance, rng
    from model_matching_tpu_torch.ops import base_rounds

    model, scene, cfg, table, bits, disp = _instance_case(case, packed_frame)
    bases, block = 24, 10
    kw = _sample_kwargs(cfg, bases, disp, block)
    n = scene.pos.shape[0]
    if case == "packed-wide":
        assert n > 16384

    def rounds():
        return base_rounds.Rounds(
            table, scene.pos, scene.normal, scene.class_prob, scene.edge_prob, scene.pixel,
            scene.valid, scene.edge_free.shape, bases, block, disp, kw["tr_disc"],
            kw["rot_disc"], kw["plane_threshold"], kw["min_distance_base"],
            kw["internal_angle_threshold"], bits)

    kern, plain = rounds(), rounds()
    state = [k for k, v in vars(plain).items() if isinstance(v, torch.Tensor)]
    keys = instance._base_keys(rng.PRNGKey(7), bases)
    launches = trace.total("base_rounds.launches")
    drawn = 0
    for b in range(bases):
        if b % block == 0:
            noise = rng.gumbel_rows(keys[b:b + block].reshape(-1, 2), n, scene.pos.device)
            for s in (kern, plain):
                s.noise[:noise.shape[0] // 4].copy_(noise.reshape(-1, 4, 1, n))
        base_rounds.base_pre(kern)
        base_rounds.base_pre_reference(plain)
        bad = [k for k in state if not torch.equal(getattr(kern, k), getattr(plain, k))]
        assert not bad, (b, "pre", bad)
        hit = int(plain.cached_id)
        for s in (kern, plain):
            if hit:
                s.seg.copy_(s.masks[hit])
                s.fill_ok.fill_(True)
            else:
                m, conv = flood.flood_fill(s.seed_rc, scene.edge_free, s.max_pix_dist,
                                           fixed_sweeps=8, return_converged=True)
                s.seg.copy_(m[0])
                s.fill_ok.copy_(conv)
                s.seg_buffer.copy_(torch.where(m[0], (s.row + 1).to(torch.int32),
                                               s.seg_buffer))
        base_rounds.base_post(kern)
        base_rounds.base_post_reference(plain)
        bad = [k for k in state if not torch.equal(getattr(kern, k), getattr(plain, k))]
        assert not bad, (b, "post", bad)
        drawn += float(plain.max_pix_dist) > 0
    assert trace.total("base_rounds.launches") - launches == 2 * bases
    assert bool(plain.oks.any()) and drawn > 0 and int(plain.row) == bases


@pytest.mark.cuda
@pytest.mark.parametrize("case", ("synthetic", "synthetic-bits", "packed", "packed-probe"))
def test_instance_sampler_kernel_path_equals_plain_path(case, packed_frame, monkeypatch):
    """sample_instance_bases_stepwise on the card with the kernel against
    the same with the plain torch parts swapped in, both replayed from
    CUDA graphs: every InstanceSamples field bit for bit, three graphs and
    one replay a base after the first either way, and `base_rounds.launches`
    up by 2 a base with the kernel, by none with the plain parts."""
    from model_matching_tpu_torch import instance, rng
    from model_matching_tpu_torch.ops import base_rounds

    model, scene, cfg, table, bits, disp = _instance_case(case, packed_frame)
    bases = 40

    def sample():
        names = ("instance.graph_captures", "instance.graph_replays",
                 "base_rounds.launches")
        before = [trace.total(k) for k in names]
        out = instance.sample_instance_bases_stepwise(
            rng.PRNGKey(5), table, scene.pos, scene.normal, scene.class_prob,
            scene.edge_prob, scene.pixel, scene.valid, scene.edge_free,
            exists_bits=bits, flood_sweeps=8, **_sample_kwargs(cfg, bases, disp, 16))
        return out, [trace.total(k) - b for k, b in zip(names, before)]

    kern, counts = sample()
    assert counts == [3, bases - 1, 2 * bases]
    monkeypatch.setattr(base_rounds, "base_pre", base_rounds.base_pre_reference)
    monkeypatch.setattr(base_rounds, "base_post", base_rounds.base_post_reference)
    plain, counts = sample()
    assert counts == [3, bases - 1, 0]
    for f in instance.InstanceSamples._fields:
        assert torch.equal(getattr(kern, f), getattr(plain, f)), f
    assert bool(plain.valid.any())


@pytest.mark.cuda
def test_base_rounds_log_and_acos_equal_fmath_on_every_float():
    """The kernel's copies of ops/fmath.py's log and acos against fmath on
    the card, on every float32 bit pattern in chunks: the same bits
    wherever fmath's result is a number, and NaN where it is NaN (what a
    NaN's payload holds decides nothing)."""
    from model_matching_tpu_torch.ops import base_rounds, fmath

    dev = _card()
    chunk = 1 << 26
    for start in range(-(1 << 31), 1 << 31, chunk):
        x = torch.arange(start, start + chunk, dtype=torch.int64, device=dev)
        x = x.to(torch.int32).view(torch.float32)
        got_log, got_acos = base_rounds.kernel_fmath(x)
        for got, want in ((got_log, fmath.log(x)), (got_acos, fmath.acos(x))):
            nan = torch.isnan(want)
            assert torch.equal(torch.isnan(got), nan), start
            assert torch.equal(torch.where(nan, 0, got.view(torch.int32)),
                               torch.where(nan, 0, want.view(torch.int32))), start

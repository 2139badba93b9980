"""The port's sharded programs across real processes, on the CPU: two
dcn_worker processes of four ranks each, joined in a torch.distributed group
(gloo, a localhost TCP rendezvous), run the sharded matching step and the
class and instance sweeps over the global eight-rank mesh.

Required, as tests/test_multihost.py requires of the JAX package: both
processes report the group and its eight ranks, their results agree
exactly, and they equal one process's run of the same programs on eight
ranks (make_mesh(["cpu"] * 8)), bit for bit: every rank's random stream is
folded from its global rank, so how the ranks map to processes cannot
change a value. A worker that fails, or a group that outlives the
launcher's time limit, ends every worker and raises.

Under torchrun's environment (one process a card): the binding rule
(`local_card`), `init_distributed` binding the card and `make_mesh()` /
the CLI's sweep ranks giving one rank a process, and raising where no card
is in sight; four workers started with that environment through
`init_distributed()` and the CLI's ranks on the CPU equal one process of
four ranks bit for bit, every rank's valid hypotheses counted by the
reduction as the rank made them, with the class sweep's LCP held to a
plain LCP of its pose; and the sharded sweep's spans and counters."""

import math
import numpy as np
import pytest
import torch

from model_matching_tpu_torch import cli
from model_matching_tpu_torch.parallel import dcn_worker, sharding
from model_matching_tpu_torch.parallel.dcn_worker import edge_scene
from model_matching_tpu_torch.parallel.sharding import make_mesh, run_sweep_sharded
from model_matching_tpu_torch.synthetic import synthetic_setup
from model_matching_tpu_torch.utils import trace

KEYS = ("step_best", "step_valid", "step_pose", "sweep_best", "sweep_pose",
        "sweep_clusters", "instance_best", "instance_pose", "instance_hyp")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return dcn_worker.launch(num_processes=2, local_devices=4, device="cpu",
                             out_dir=str(tmp_path_factory.mktemp("dcn")), timeout=600)


def test_two_processes_agree(results):
    r0, r1 = results
    assert r0["process_id"] == 0 and r1["process_id"] == 1
    assert r0["process_count"] == r1["process_count"] == 2
    assert r0["global_devices"] == r1["global_devices"] == 8
    for k in KEYS:
        assert r0[k] == r1[k], k
    assert r0["step_valid"] > 0 and r0["instance_hyp"] > 0


def test_two_processes_equal_one_process(results):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        one = dcn_worker.run_workload(make_mesh(["cpu"] * 8), torch.device("cpu"))
    finally:
        torch.set_num_threads(n)
    assert one["global_devices"] == 8
    for k in KEYS:
        np.testing.assert_array_equal(np.asarray(results[0][k]), np.asarray(one[k]),
                                      err_msg=k)


@pytest.mark.parametrize("fault", ["worker fails", "time limit"])
def test_launch_ends_every_worker_and_raises(tmp_path, fault):
    """A worker that exits nonzero (refusing an unknown device) raises with
    its output; a group that runs past the time limit is killed and
    raises."""
    if fault == "worker fails":
        with pytest.raises(RuntimeError, match="invalid choice: 'tpu'"):
            dcn_worker.launch(2, 1, out_dir=str(tmp_path), device="tpu", timeout=120)
    else:
        with pytest.raises(RuntimeError, match="did not finish"):
            dcn_worker.launch(2, 1, out_dir=str(tmp_path), device="cpu", timeout=0.5)


# --------------------------------------------------------------- torchrun

@pytest.mark.parametrize("local,card", [("0", 0), ("1", 1), ("2", 2), ("3", 3), ("5", 1),
                                        (None, None)])
def test_local_card(local, card):
    env = {} if local is None else {"LOCAL_RANK": local}
    assert sharding.local_card(env, 4) == card
    assert sharding.local_card(env, 0) is None


def _four_cards(mp, world):
    mp.setattr(torch.cuda, "is_available", lambda: True)
    mp.setattr(torch.cuda, "device_count", lambda: 4)
    mp.setattr(sharding, "process_count", lambda: world)


@pytest.mark.parametrize("local", ["2", None])
def test_init_distributed_binds_the_local_card(monkeypatch, local):
    bound = []
    _four_cards(monkeypatch, 4)
    monkeypatch.setattr(torch.cuda, "set_device", bound.append)
    monkeypatch.setattr(sharding.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(sharding.dist, "init_process_group", lambda *a, **k: None)
    monkeypatch.setattr(sharding.dist, "get_world_size", lambda: 4)
    for k, v in {"MASTER_ADDR": "localhost", "MASTER_PORT": "1", "WORLD_SIZE": "4",
                 "RANK": "2"}.items():
        monkeypatch.setenv(k, v)
    if local is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local)
    assert sharding.init_distributed() == 4
    assert bound == ([] if local is None else [2])


def test_one_rank_a_process_under_torchrun(monkeypatch):
    """Four cards in sight: a torchrun process's sweep ranks and default
    mesh are its own card; a lone process keeps every card; explicit
    devices keep their meaning."""
    _four_cards(monkeypatch, 4)
    monkeypatch.setenv("LOCAL_RANK", "2")
    monkeypatch.setattr(sharding.dist, "get_rank", lambda: 2)
    monkeypatch.setattr(sharding.dist, "all_gather",
                        lambda out, t: [o.copy_(t) for o in out])
    cuda = torch.device("cuda")
    assert cli._sweep_devices(cuda) == [torch.device("cuda", 2)]
    mesh = make_mesh()
    assert mesh.devices == (torch.device("cuda", 2),)
    assert (mesh.size, mesh.process_index, mesh.rank(0)) == (4, 2, 2)
    assert make_mesh(["cpu"] * 2).size == 8
    assert cli._sweep_devices(torch.device("cpu")) == [torch.device("cpu")]
    monkeypatch.setattr(sharding, "process_count", lambda: 1)
    every = [torch.device("cuda", i) for i in range(4)]
    assert cli._sweep_devices(cuda) == every
    assert make_mesh().devices == tuple(every)


def test_no_card_under_torchrun_raises(monkeypatch):
    """A torchrun process that sees no card gets no default ranks: make_mesh()
    and the CLI's card ranks raise, as without a group; the CPU is asked
    for by name."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sharding, "process_count", lambda: 4)
    monkeypatch.setenv("LOCAL_RANK", "1")
    for fn in (sharding.default_devices, make_mesh,
               lambda: cli._sweep_devices(torch.device("cuda"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    assert sharding.process_devices(torch.device("cpu")) == [torch.device("cpu")]


def test_torchrun_env(monkeypatch):
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    env = sharding.torchrun_env(1234, 4, 3)
    assert env == {"MASTER_ADDR": "localhost", "MASTER_PORT": "1234", "WORLD_SIZE": "4",
                   "RANK": "3", "LOCAL_RANK": "3", "LOCAL_WORLD_SIZE": "4",
                   "OMP_NUM_THREADS": "1"}
    monkeypatch.setenv("OMP_NUM_THREADS", "6")
    assert sharding.torchrun_env(1234, 4, 0)["OMP_NUM_THREADS"] == "6"


def _plain_lcp(world, model, scene, cfg):
    """Weighted LCP of a world pose in float64 torch: each posed model
    point takes its nearest scene point and adds its class probability
    when within the distance threshold and the normal angle."""
    w = torch.as_tensor(np.asarray(world), dtype=torch.float64)
    mpos = model.pos[model.valid].double() + model.centroid.double()
    mnrm = model.normal[model.valid].double()
    live = scene.valid
    spos = scene.pos[live].double() + scene.centroid.double()
    snrm, prob = scene.normal[live].double(), scene.class_prob[live].double()
    q = mpos @ w[:3, :3].T + w[:3, 3]
    d2, idx = torch.cdist(q, spos).square().min(1)
    cos = (snrm[idx] * (mnrm @ w[:3, :3].T)).sum(-1)
    hit = (d2 <= cfg.distance_threshold ** 2) & (
        cos > math.cos(math.radians(cfg.lcp_normal_angle_threshold)))
    return float(torch.where(hit, prob[idx], 0.0).sum()) / mpos.shape[0]


@pytest.fixture(scope="module")
def torchrun_results(tmp_path_factory):
    return dcn_worker.launch(num_processes=4, local_devices=None, device="cpu",
                             out_dir=str(tmp_path_factory.mktemp("torchrun")), timeout=120)


def test_four_torchrun_processes_equal_one_process(torchrun_results):
    assert [r["process_id"] for r in torchrun_results] == [0, 1, 2, 3]
    assert all(r["ranks"] == ["cpu"] and r["global_devices"] == 4 for r in torchrun_results)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        one = dcn_worker.run_workload(make_mesh(["cpu"] * 4), torch.device("cpu"))
    finally:
        torch.set_num_threads(n)
    made = [h for r in torchrun_results for h in r["sweep_local_hyp"]]
    assert one["sweep_rank_hyp"] == one["sweep_local_hyp"] == made
    assert sum(made) == one["sweep_hyp"]
    for r in torchrun_results:
        for k in KEYS + ("sweep_hyp", "sweep_rank_hyp"):
            np.testing.assert_array_equal(np.asarray(r[k]), np.asarray(one[k]), err_msg=k)
        assert r["collectives"] > 0 and r["collective_bytes"] > 0
    assert one["collectives"] == one["collective_bytes"] == 0
    model, scene, cfg = synthetic_setup(num_model=128, num_scene=512, num_bases=8,
                                        max_pairs=256, max_congruent=16, device="cpu")
    plain = _plain_lcp(one["sweep_pose"], model, scene, cfg)
    assert one["sweep_best"] > 0 and abs(one["sweep_best"] - plain) < 0.03, (
        one["sweep_best"], plain)


@pytest.mark.parametrize("path", ["class", "instance"])
def test_sharded_sweep_spans(path):
    """sweep.run > sweep.chunk > sweep.gather, one gather a chunk (and one
    broadcast a chunk on the instance path), sweep.finish under
    sweep.run; in one process no collective is counted."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        model, scene, cfg = synthetic_setup(num_model=128, num_scene=512, num_bases=8,
                                            max_pairs=256, max_congruent=16, device="cpu")
        if path == "instance":
            scene = edge_scene(scene)
        mark = trace.mark()
        run_sweep_sharded(make_mesh(["cpu"] * 4), model, scene, cfg, 12, chunk=4,
                          keep_per_chunk=4, verbose=False)
        entries = trace.snapshot(mark).entries
    finally:
        torch.set_num_threads(n)
    spans = {e.seq: e for e in entries if e.kind == "span"}
    by = lambda name: [e for e in spans.values() if e.name == name]
    (top,) = by("sweep.run")
    chunks = by("sweep.chunk")
    assert len(chunks) == 3 and all(c.parent == top.seq for c in chunks)
    for name in ("sweep.gather",) + (("sweep.broadcast",) if path == "instance" else ()):
        inner = by(name)
        assert sorted(e.parent for e in inner) == sorted(c.seq for c in chunks), name
    assert not by("sweep.broadcast") or path == "instance"
    (fin,) = by("sweep.finish")
    assert fin.parent == top.seq
    assert all(top.t0 <= e.t0 and e.t1 <= top.t1 for e in chunks + [fin])
    assert not [e for e in entries if e.kind == "count" and e.name.startswith("sharding.")]

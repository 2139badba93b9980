"""The sweep4 loop on the CPU at a quarter-size frame: four processes (the
harness's and three helpers started with torchrun's environment) reach
`correct`, every process's answer agrees with rank 0's; a reduction that
leaves the last rank's pool out in every process comes out not correct;
and a helper killed mid-window ends the run with an error and its log,
within the group's timeout, not a hang."""

import os
import re
import time

import pytest
import torch

import loops
import run
from test_bench_harness import tiny_spec

SEED = 2**31 + 37


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny4():
    """The cell at tiny_spec's size, with 64-base sweeps in chunks of 32;
    1 cm scene voxels and a 4,096-point cap keep the existence matrix of
    every sweep small (about 8,800 points at 5 mm, whose 16,384-lane
    matrix takes minutes a process on the CPU)."""
    spec = tiny_spec("ycb.sweep4")
    spec["traffic"].update(bases=64, chunk=32)
    spec["config"]["match"].update(voxel_size=0.01, max_scene_points=4096)
    return spec


def test_the_sweep4_loop_is_correct(capsys):
    out = run.execute(tiny4(), SEED, 0.1, 0, device="cpu", scale=0.25)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"bases_per_s", "setup_s"}
    err = capsys.readouterr().err
    assert "sweep4: 4 processes agreed on" in err, err[-2000:]
    assert not torch.distributed.is_initialized()


DROP_LAST_RANK = """
import runpy, sys
sys.path[:0] = [{bench!r}, {root!r}]
from model_matching_tpu_torch.parallel import sharding
reduce = sharding._reduce_pools
sharding._reduce_pools = lambda g, k: reduce(g[:-1], k)
sys.argv = [{helper!r}] + sys.argv[1:]
runpy.run_path({helper!r}, run_name="__main__")
"""


def test_a_rank_left_out_of_every_reduction_is_not_correct(monkeypatch, tmp_path, capsys):
    """Every process's reduction drops the last rank's pool: the answers
    still agree across the processes, and the sweep finds a pose, but the
    reduction took in fewer ranks than made hypotheses, so every request
    fails."""
    from model_matching_tpu_torch.parallel import sharding

    reduce = sharding._reduce_pools
    monkeypatch.setattr(sharding, "_reduce_pools", lambda g, k: reduce(g[:-1], k))
    load = loops.load_loop

    def load_with_the_fault(name, root=loops.ROOT):
        mod = load(name, root)
        script = tmp_path / "helper_dropping_a_rank.py"
        script.write_text(DROP_LAST_RANK.format(
            bench=os.path.join(loops.ROOT, "benchmark"), root=loops.ROOT, helper=mod.HELPER))
        mod.HELPER = str(script)
        return mod

    monkeypatch.setattr(loops, "load_loop", load_with_the_fault)
    out = run.execute(tiny4(), SEED, 0.1, 0, device="cpu", scale=0.25)
    assert out["correct"] is False
    assert out["attempted"] >= 1 and out["failed"] == out["attempted"]
    err = capsys.readouterr().err
    found = re.search(r"agreed on (\d+) of (\d+) requests, .* every rank's work taken in "
                      r"on (\d+)", err)
    assert found, err[-2000:]
    agreed, requests, work = map(int, found.groups())
    assert agreed == requests > 0 and work == 0
    assert not torch.distributed.is_initialized()


def test_a_helper_killed_mid_window_ends_the_run(monkeypatch, capsys):
    spec = tiny4()
    load = loops.load_loop

    def load_with_a_kill(name, root=loops.ROOT):
        mod = load(name, root)
        request = mod.request

        def killing(session, rec, fr):
            if rec.i == spec["cell"]["warmup_requests"]:
                helper = session.sweep4.procs[1]
                helper.kill()
                helper.wait()
            request(session, rec, fr)

        mod.request = killing
        return mod

    monkeypatch.setattr(loops, "load_loop", load_with_a_kill)
    t = time.monotonic()
    with pytest.raises(SystemExit, match="sweep4: request 1 failed"):
        run.execute(spec, SEED, 30.0, 0, device="cpu", scale=0.25)
    assert time.monotonic() - t < spec["config"]["mesh"]["collective_timeout_s"] + 60
    err = capsys.readouterr().err
    assert "--- sweep4 rank 2 (exit code -9)" in err, err[-3000:]
    assert not torch.distributed.is_initialized()

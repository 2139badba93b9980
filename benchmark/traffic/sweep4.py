"""The sweep4 loop: one sweep a request over several processes, one card
each, as `torchrun --nproc-per-node 4 -m model_matching_tpu_torch.cli
stocs-single <scene> <object> --sweep 16384 --sweep-chunk 8192` runs it.
The traffic file gives "bases" and "chunk", the configuration's "mesh"
block the processes and the timeout of the rendezvous and of every
collective.

The harness's process is rank 0. Its set-up starts the other processes
(benchmark/sweep4_helper.py) with torchrun's environment
(`sharding.torchrun_env`: a free localhost port, and OMP_NUM_THREADS 1
where it is unset, as torchrun sets it for several processes a host; rank 0
takes one thread for the run). Every process then does what the command
does: `init_distributed()`, the port's default device, `load_scene` of
every frame, `make_mesh` over the ranks the CLI's --sweep takes
(`sharding.process_devices`: under torchrun the process's own card), and
for each request
`run_sweep_sharded`, on a pack loaded unstandardized as stocs-single loads
it (rank 0's from set-up, the others' from the files rank 0 preprocessed).
Rank 0 broadcasts each request's frame index and, at release, a stop.
After each sweep every process reports to rank 0 its answer (best LCP and
pose), its mesh's size, its rank's card and the card it runs on, and the
valid hypotheses of the sweep by rank: its own rank's, made before the
gather, and every rank's, as its pools' reduction took them in. A request
counts as failed unless every process's answer is within 1e-4 of rank 0's
LCP and 0.1 mm of its translation, every mesh has the configuration's
processes x cards_per_process ranks, each process runs on its rank's card
and the cards are distinct (on the card), and every process's reduction
took in each rank's hypotheses as that rank made them, none of them zero.

A process that fails breaks the group: every other one waits in a
collective it will never finish. So any error inside the group ends the
run (SystemExit, exit code 1) with the helpers' logs on standard error,
and the helpers exit when rank 0's process is gone.
"""

from __future__ import annotations

import atexit
import json
import os
import socket
import subprocess
import sys
import time

import torch

from loops import ROOT, scene_out

STANDARDIZE = False
LCP_TOL = 1e-4          # agreement of the processes' answers
TRANSLATION_TOL = 1e-4  # metres
TORCHRUN_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                 "LOCAL_WORLD_SIZE")
HELPER = os.path.join(ROOT, "benchmark", "sweep4_helper.py")


def mesh_devices(dev):
    """A process's ranks, as the CLI's --sweep takes them on `dev`."""
    from model_matching_tpu_torch.parallel.sharding import process_devices

    return process_devices(dev)


def load_scenes(frames, cfg, device):
    from model_matching_tpu_torch.scene import load_scene

    return [load_scene(rgb, depth, probs[0], edge, cfg, device=device)
            for rgb, depth, probs, edge in frames]


def sweep(mesh, pack, scene, cfg, traffic):
    """One request's sweep: (best LCP, best world pose [4, 4], stats)."""
    from model_matching_tpu_torch.parallel.sharding import run_sweep_sharded

    best, world, _ct, _cs, stats = run_sweep_sharded(
        mesh, pack, scene, cfg, traffic["bases"], chunk=traffic["chunk"], verbose=False)
    return best, world, stats


def report(mesh, best, world, stats):
    """This process's row of the request's report: [best LCP, pose (16),
    mesh size, its rank's card, the card it runs on (-1 on the CPU), its
    ranks' own valid hypotheses (mesh.local), every rank's as its
    reduction took them in (mesh.size, -1 where it has none)]."""
    dev = mesh.devices[0]
    on_card = dev.type == "cuda"
    taken = list(stats.get("rank_hypotheses", []))[:mesh.size]
    taken += [-1] * (mesh.size - len(taken))
    own = list(stats.get("local_hypotheses", []))[:mesh.local]
    own += [-1] * (mesh.local - len(own))
    return torch.cat([
        torch.tensor([best], dtype=torch.float64),
        torch.as_tensor(world).reshape(-1).to(torch.float64),
        torch.tensor([mesh.size, dev.index if on_card else -1,
                      torch.cuda.current_device() if on_card else -1, *own, *taken],
                     dtype=torch.float64)])


def gather_reports(mine, n_proc):
    """[n_proc, len(mine)]: every process's report, in rank order."""
    import torch.distributed as dist

    out = [torch.empty_like(mine) for _ in range(n_proc)]
    dist.all_gather(out, mine)
    return torch.stack(out)


def judge(got, mesh_spec, on_card):
    """What rank 0 finds in the gathered reports: {"agreed": every answer
    within the tolerances of rank 0's, "bit_equal": all of them equal to
    it, "layout": every mesh of processes x cards_per_process ranks, each
    process on its rank's card and the cards distinct (on the card),
    "work": every process's reduction took in each rank's valid hypotheses
    as the rank made them, none zero}."""
    lcp_gap = (got[:, 0] - got[0, 0]).abs().max()
    t = got[:, 1:17].reshape(-1, 4, 4)[:, :3, 3]
    t_gap = (t - t[0]).abs().max()
    size = int(got[0, 17])
    cards = got[:, 18]
    layout = (bool((got[:, 17] == mesh_spec["processes"] * mesh_spec["cards_per_process"]).all())
              and got.shape[0] == mesh_spec["processes"])
    if on_card:
        layout = (layout and bool((cards == got[:, 19]).all())
                  and len(set(cards.tolist())) == got.shape[0])
    local = (got.shape[1] - 20 - size) if size > 0 else 0
    made = got[:, 20:20 + local].reshape(-1)
    taken = got[:, 20 + local:]
    work = (local > 0 and made.numel() == size and bool((made > 0).all())
            and bool((taken == made).all()))
    return {"agreed": bool(lcp_gap <= LCP_TOL and t_gap <= TRANSLATION_TOL),
            "bit_equal": bool((got[:, :17] == got[0, :17]).all()),
            "layout": layout, "work": work}


class Group:
    """Rank 0's side of the group: the helper processes, their logs, the
    mesh, and what the answers' comparison found."""

    def __init__(self, world, timeout, log_dir):
        self.world, self.timeout, self.log_dir = world, timeout, log_dir
        self.procs, self.mesh = [], None
        self.requests = 0
        self.found = dict.fromkeys(("agreed", "bit_equal", "layout", "work"), 0)
        self.joined = False
        self.threads = torch.get_num_threads()

    def start(self, plan_path, port):
        from model_matching_tpu_torch.parallel import sharding

        for rank in range(1, self.world):
            with open(self.log(rank), "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, HELPER, plan_path], cwd=ROOT,
                    env={**os.environ, **sharding.torchrun_env(port, self.world, rank)},
                    stdout=log, stderr=subprocess.STDOUT))
        atexit.register(self.kill)

    def log(self, rank):
        return os.path.join(self.log_dir, f"rank{rank}.log")

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + 5
        for p in self.procs:
            try:
                p.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    def leave(self):
        import torch.distributed as dist

        if self.joined and dist.is_initialized():
            dist.destroy_process_group()
        self.joined = False
        torch.set_num_threads(self.threads)
        atexit.unregister(self.kill)

    def abort(self, why):
        """End the run: the helpers killed, their logs on standard error,
        the group left."""
        self.kill()
        for rank, p in enumerate(self.procs, 1):
            with open(self.log(rank), errors="replace") as f:
                tail = f.read()[-4000:]
            print(f"--- sweep4 rank {rank} (exit code {p.returncode}):\n{tail}",
                  file=sys.stderr)
        try:
            self.leave()
        except Exception as e:  # the group is already broken; the run ends anyway
            print(f"sweep4: leaving the group: {e!r}", file=sys.stderr)
        raise SystemExit(f"error: sweep4: {why}")

    def stop(self):
        """Broadcast the stop, wait for the helpers, leave the group."""
        import torch.distributed as dist

        try:
            dist.broadcast(torch.tensor([-1], dtype=torch.int64), src=0)
            for p in self.procs:
                p.wait(self.timeout)
        except Exception as e:
            self.abort(f"the stop failed: {e!r}")
        bad = [(r, p.returncode) for r, p in enumerate(self.procs, 1) if p.returncode]
        if bad:
            self.abort(f"helpers exited with {bad}")
        self.leave()
        f = self.found
        print(f"sweep4: {self.world} processes agreed on {f['agreed']} of {self.requests} "
              f"requests, bit-equal on {f['bit_equal']}; the configuration's layout on "
              f"{f['layout']}, every rank's work taken in on {f['work']}", file=sys.stderr)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def setup(session):
    from model_matching_tpu_torch.parallel.sharding import (init_distributed, make_mesh,
                                                            torchrun_env)

    mesh_spec = session.spec["config"]["mesh"]
    log_dir = os.path.join(session.tmp, "sweep4")
    os.makedirs(log_dir)
    frames = [fr.paths(session.objects) for fr in session.frames]
    d = os.path.join(session.tmp, "models", session.objects[0])
    plan = {"frames": frames, "match": session.spec["config"]["match"],
            "scale": session.scale, "traffic": session.spec["traffic"],
            "model": [os.path.join(d, "model_search.ply"), os.path.join(d, "ppf_table.npz")],
            "device": session.dev.type, "timeout": mesh_spec["collective_timeout_s"],
            "threads": torch.get_num_threads() if session.dev.type == "cpu" else None}
    plan_path = os.path.join(log_dir, "plan.json")
    with open(plan_path, "w") as f:
        json.dump(plan, f)
    port = _free_port()
    g = session.sweep4 = Group(mesh_spec["processes"], mesh_spec["collective_timeout_s"],
                               log_dir)
    g.start(plan_path, port)
    saved = {k: os.environ.get(k) for k in TORCHRUN_KEYS}
    env = torchrun_env(port, g.world, 0)
    os.environ.update({k: env[k] for k in TORCHRUN_KEYS})
    if session.dev.type == "cuda":
        torch.set_num_threads(int(env["OMP_NUM_THREADS"]))
    try:
        g.joined = True
        init_distributed(timeout=g.timeout)
        session.sweep_scenes = load_scenes(frames, session.cfg, session.dev)
        session.sweep_scene_out = [scene_out(s) for s in session.sweep_scenes]
        g.mesh = make_mesh(mesh_devices(session.dev))
    except Exception as e:
        g.abort(f"set-up failed: {e!r}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def request(session, rec, fr):
    import torch.distributed as dist

    g = session.sweep4
    try:
        with session.span("sweep", rec):
            dist.broadcast(torch.tensor([rec.frame], dtype=torch.int64), src=0)
            best, world, stats = sweep(g.mesh, session.packs[0],
                                       session.sweep_scenes[rec.frame], session.cfg,
                                       session.spec["traffic"])
            got = gather_reports(report(g.mesh, best, world, stats), g.world)
    except Exception as e:
        g.abort(f"request {rec.i} failed: {e!r}")
    found = judge(got, session.spec["config"]["mesh"], session.dev.type == "cuda")
    g.requests += 1
    for k, v in found.items():
        g.found[k] += v
    if not (found["agreed"] and found["layout"] and found["work"]):
        print(f"sweep4: request {rec.i} failed its checks {found}: mesh sizes, cards "
              f"{got[:, 17:20].tolist()}, hypotheses by rank {got[:, 20:].tolist()}",
              file=sys.stderr)
    rec.bases = int(stats["total_bases"])
    rec.ok = best > 0 and found["agreed"] and found["layout"] and found["work"]
    rec.out = {"lcp": [best], "pose": [world]}


def scene_outputs(session, rec):
    return session.sweep_scene_out[rec.frame]


def release(session):
    session.sweep_scenes = []
    session.sweep4.stop()


def helper(plan_path):
    """A helper process's whole run (benchmark/sweep4_helper.py): join the
    group, load the pack and every frame, then sweep each frame index rank 0
    broadcasts until the stop."""
    import torch.distributed as dist

    import loops
    from model_matching_tpu_torch.model import load_model_pack
    from model_matching_tpu_torch.parallel.sharding import init_distributed, make_mesh

    with open(plan_path) as f:
        plan = json.load(f)
    if plan["threads"]:
        torch.set_num_threads(plan["threads"])
    init_distributed(timeout=plan["timeout"])
    try:
        cfg = loops.match_config(plan["match"], plan["scale"])
        pack = load_model_pack(*plan["model"], cfg.max_model_points, standardize=STANDARDIZE,
                               device=plan["device"])
        scenes = load_scenes(plan["frames"], cfg, plan["device"])
        mesh = make_mesh(mesh_devices(torch.device(plan["device"])))
        n_proc = dist.get_world_size()
        while True:
            idx = torch.zeros(1, dtype=torch.int64)
            dist.broadcast(idx, src=0)
            if int(idx) < 0:
                break
            best, world, stats = sweep(mesh, pack, scenes[int(idx)], cfg, plan["traffic"])
            gather_reports(report(mesh, best, world, stats), n_proc)
    finally:
        dist.destroy_process_group()

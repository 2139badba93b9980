"""One process of an N-process torch.distributed group, and its launcher.

Counterpart of ``model_matching_tpu/parallel/dcn_worker.py``. Launched N
times (once per process index), a worker joins the group through
sharding.init_distributed (gloo, a localhost TCP rendezvous), builds a mesh
of `--local-devices` ranks on `--device`, runs one sharded matching step, a
sharded class sweep and a sharded instance sweep over the global mesh, and
writes the results as JSON, so that the launcher's caller can check that
every process agreed and that the results equal a one-process run of the
same rank count.

Run (one command per process index):
    python -m model_matching_tpu_torch.parallel.dcn_worker \\
        --coordinator localhost:12345 --num-processes 2 --process-id 0 \\
        --local-devices 4 --device cpu --out /tmp/p0.json

Without `--coordinator` a worker joins the group that torchrun's
environment names, as the CLI does, and without `--local-devices` its
ranks are the CLI's (`sharding.process_devices`): under torchrun its own
card, or the CPU alone with `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def launch(num_processes: int = 2, local_devices: int | None = 4,
           out_dir: str | None = None, timeout: float = 600.0,
           device: str = "cuda"):
    """Start `num_processes` workers against a free localhost port and
    return their parsed results in process order. With `local_devices`
    None the workers get torchrun's environment (`sharding.torchrun_env`)
    in place of the coordinator arguments, and one rank each. When a worker fails, or the
    group outlives `timeout` seconds, every worker is killed and this
    raises with the failed worker's output (p<i>.log in `out_dir`)."""
    import socket
    import subprocess
    import tempfile
    import time

    from .sharding import torchrun_env

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    out_dir = out_dir or tempfile.mkdtemp(prefix="mm_dcn_")
    os.makedirs(out_dir, exist_ok=True)
    outs = [os.path.join(out_dir, f"p{i}.json") for i in range(num_processes)]
    logs = [os.path.join(out_dir, f"p{i}.log") for i in range(num_processes)]

    def tail(i):
        with open(logs[i]) as f:
            return f.read()[-4000:]

    procs, failed, late = [], None, False
    try:
        for i in range(num_processes):
            cmd = [sys.executable, "-m", "model_matching_tpu_torch.parallel.dcn_worker",
                   "--num-processes", str(num_processes), "--device", device,
                   "--out", outs[i], "--timeout", str(timeout)]
            env = None
            if local_devices is None:
                env = {**os.environ, **torchrun_env(port, num_processes, i)}
            else:
                cmd += ["--coordinator", f"localhost:{port}", "--process-id", str(i),
                        "--local-devices", str(local_devices)]
            with open(logs[i], "w") as log:
                procs.append(subprocess.Popen(cmd, cwd=repo, env=env, stdout=log,
                                              stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            failed = next((i for i, c in enumerate(codes) if c not in (None, 0)), None)
            if failed is not None or all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                late = True
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if late:
        raise RuntimeError(f"the dcn workers did not finish in {timeout} s:\n"
                           + "\n".join(f"[worker {i}] {tail(i)}" for i in range(len(procs))))
    if failed is not None:
        raise RuntimeError(f"dcn worker {failed} failed (rc={procs[failed].returncode}):\n"
                           + tail(failed))
    results = []
    for o in outs:
        with open(o) as f:
            results.append(json.load(f))
    return results


def edge_scene(scene, seed: int = 23, height: int = 24, width: int = 32):
    """`scene` laid on a `height` x `width` pixel map (distinct pixels drawn
    from `seed`) with an edge wall down the middle column: the instance
    path's input of the worker and of the tests that check it."""
    import dataclasses

    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    flat = rng.choice(height * width, size=scene.pos.shape[0], replace=False)
    pixel = np.stack([flat // width, flat % width], axis=-1).astype(np.int32)
    edge_free = np.ones((height, width), bool)
    edge_free[:, width // 2] = False
    dev = scene.pos.device
    return dataclasses.replace(
        scene, pixel=torch.from_numpy(pixel).to(dev),
        edge_prob=torch.from_numpy(
            (pixel[:, 1] == width // 2).astype(np.float32)).to(dev),
        edge_free=torch.from_numpy(edge_free).to(dev), has_edge=True,
    )


def run_workload(mesh, device):
    """The worker's programs on `mesh` (D ranks): the synthetic setup at
    128 model and 512 scene points, one matching_step_sharded of 2D bases,
    a class run_sweep_sharded and an instance one (edge_scene) of 2D bases
    in chunks of D. Returns the JSON-ready results (the class sweep's
    valid hypotheses also by rank, as its reduction counted them and as
    this process's ranks made them), with the collectives
    this process made and the bytes it sent in them (the trace's
    `sharding.collectives` and `sharding.collective_bytes` over the
    call)."""
    from .. import rng
    from ..synthetic import synthetic_setup
    from ..utils import trace
    from .sharding import matching_step_sharded, run_sweep_sharded

    n = mesh.size
    calls, sent = trace.total("sharding.collectives"), trace.total("sharding.collective_bytes")
    model, scene, cfg = synthetic_setup(num_model=128, num_scene=512, num_bases=2 * n,
                                        max_pairs=256, max_congruent=16, device=device)
    best, pose, n_valid = matching_step_sharded(mesh, model, scene, cfg, rng.PRNGKey(0))
    kw = dict(total_bases=2 * n, chunk=n, keep_per_chunk=n, verbose=False)
    best_lcp, best_w, _ct, cl_s, st = run_sweep_sharded(mesh, model, scene, cfg, **kw)
    inst_best, inst_w, _ict, _ics, inst_stats = run_sweep_sharded(
        mesh, model, edge_scene(scene), cfg, **kw)
    trace.count("host_reads", 3)        # best, pose and n_valid below
    return {
        "global_devices": n,
        "step_best": float(best),
        "step_pose": pose.cpu().tolist(),
        "step_valid": int(n_valid),
        "sweep_best": float(best_lcp),
        "sweep_pose": best_w.tolist(),
        "sweep_clusters": len(cl_s),
        "sweep_hyp": int(st["hypotheses"]),
        "sweep_rank_hyp": st["rank_hypotheses"],
        "sweep_local_hyp": st["local_hypotheses"],
        "instance_best": float(inst_best),
        "instance_pose": inst_w.tolist(),
        "instance_hyp": int(inst_stats["hypotheses"]),
        "collectives": trace.total("sharding.collectives") - calls,
        "collective_bytes": trace.total("sharding.collective_bytes") - sent,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dcn_worker")
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0's rendezvous (default: "
                        "torchrun's environment)")
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's index (default: RANK)")
    p.add_argument("--local-devices", type=int, default=None,
                   help="ranks of this process, all on --device (default: "
                        "the CLI's, one rank under torchrun)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="the device of every local rank (default cuda)")
    p.add_argument("--out", required=True, help="result JSON path")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="seconds to wait for the other processes")
    a = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    from ..utils.device import require
    from .sharding import init_distributed, make_mesh, process_devices

    dev = require(a.device)
    if dev.type == "cpu":
        # the group's processes share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // (2 * a.num_processes)))
    nproc = init_distributed(coordinator_address=a.coordinator,
                             num_processes=a.num_processes,
                             process_id=a.process_id, timeout=a.timeout)
    try:
        assert nproc == a.num_processes, (nproc, a.num_processes)
        mesh = make_mesh(process_devices(dev) if a.local_devices is None
                         else [dev] * a.local_devices)
        assert mesh.size == a.num_processes * mesh.local, mesh
        out = {"process_id": dist.get_rank(), "process_count": nproc,
               "ranks": [str(d) for d in mesh.devices], **run_workload(mesh, dev)}
    finally:
        dist.destroy_process_group()
    with open(a.out, "w") as f:
        json.dump(out, f)
    print(f"dcn_worker[{out['process_id']}] ok: step_best={out['step_best']:.3f} "
          f"sweep_best={out['sweep_best']:.3f} devices={out['global_devices']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

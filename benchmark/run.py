"""Run one benchmark cell once and print its result as one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of BENCHMARK.json's `workloads`; its configuration
(benchmark/configs/<config>.json), traffic mix (benchmark/traffic/<traffic>.json,
whose "loop" names its request loop, benchmark/traffic/<loop>.py) and run
parameters with the limits of its checks (benchmark/cells/<cell>.json) are
found by name, and so are the readers of its metrics
(benchmark/metrics/<metric>.py). With --trace 0 the line carries the cell's
end-to-end metrics, with --trace 1 its per-layer metrics, read from spans
over the same window and from a device trace of a few more requests.

It needs the card: without one it exits with code 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "model_matching_tpu"}


def load_spec(workload, root=ROOT):
    """Everything one cell runs by: its BENCHMARK.json entries and its files."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def data(*parts):
        with open(os.path.join(root, *parts)) as f:
            return json.load(f)

    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload] if m["moves"] in moved else [])]
    return {"name": workload, "chips": cell["chips"], "root": root,
            "config": data(cfg_entry["file"]),
            "traffic": data("benchmark", "traffic", f"{cell['traffic']}.json"),
            "cell": data("benchmark", "cells", f"{workload}.json"),
            "end_to_end": e2e, "per_layer": layer}


def read_metric(name, run, root=ROOT):
    """The reader benchmark/metrics/<name>.py applied to the run."""
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}",
        os.path.join(root, "benchmark", "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


class RunView:
    """What the metric readers see."""

    def __init__(self, session, setup_s, trace=None, launches=None, peaks=None):
        self.records = session.records
        self.traced_records = session.traced_records
        self.window_s = session.window_s
        self.setup_s = setup_s
        self.trace, self.launches, self.peaks = trace, launches, peaks


def execute(spec, seed, seconds, trace, device="cuda", scale=1.0, t_start=None,
            program=None):
    """One run of a cell; returns the result's dict (its last key `checks`).
    `device` and `scale` other than the card at full size serve the CPU
    tests of the harness; `program` (a name in faults.PROGRAMS) puts the
    bfloat16 control or a broken program in the program's place, for the
    checks' own tests (benchmark/control.py, benchmark/tests)."""
    import torch

    import bounds
    import check
    import loops
    import trace as trace_mod

    t_start = T_START if t_start is None else t_start
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    session = loops.Session(spec, seed, device, scale)
    on_card = session.dev.type == "cuda"
    undo = None
    if program is not None:
        import faults

        undo = faults.install(program, session)
    try:
        session.setup()
        setup_s = time.perf_counter() - t_start
        session.window(seconds)
        peak = torch.cuda.max_memory_allocated(session.dev) if on_card else 0
        summary = launches = None
        if trace:
            launches = bounds.LaunchRecorder()
            n = spec["cell"]["traced_requests"]
            if on_card:
                summary = trace_mod.capture(lambda: session.traced(n, launches))
            else:
                session.traced(n, launches)
        kind = torch.cuda.get_device_name(session.dev) if on_card else "cpu"
        view = RunView(session, setup_s, summary, launches, bounds.PEAKS.get(kind))
        metrics = {}
        for m in spec["per_layer"] if trace else spec["end_to_end"]:
            v = read_metric(m["name"], view)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        session.release()
        del view, launches
        numbers = check.run_checks(session, spec["cell"]["limits"], seed, session.dev)
    finally:
        if undo is not None:
            undo()
        session.close()
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": spec["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": all(v <= lim for v, lim in numbers.values()),
           "attempted": len(session.records),
           "failed": sum(1 for r in session.records if not r.ok),
           "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
        out["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}
    by_layout = {}
    for r in session.records:
        by_layout.setdefault(session.frames[r.frame].layout, []).append(
            round((r.t1 - r.t0) * 1e3, 1))
    print("request ms by layout:", json.dumps(dict(sorted(by_layout.items()))), file=sys.stderr)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every build and kernel cache at a fixed place inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    sys.path.insert(0, HERE)
    sys.path.insert(1, ROOT)
    spec = load_spec(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        print(f"error: the cell needs {spec['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = execute(spec, args.seed, args.seconds, args.trace)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"error: the run loaded {loaded}", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

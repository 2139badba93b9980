"""The checks' own test on the card: the bfloat16 control, or a program
broken underneath, put in the program's place (benchmark/faults.py) and
judged by the harness's own run and verdict (`run.execute`), at the cell's
own size. The benchmark's runs do not run it.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 \\
        [--programs control k1_halved sound] [--seconds 2] [--warmup 0]

`sound` is the program itself. Every run is one `run.execute` in this one
process (the kernels are built once), with `--warmup` warm-up requests and
a window of `--seconds`. Prints one JSON line a run: the program, the seed,
`correct`, the numbers compared beside their limits, and each answer's pose
readings (layout, object, ADD-S in mm, LCP shortfall).
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--programs", nargs="+", default=["control"])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--warmup", type=int, default=0)
    args = p.parse_args(argv)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    sys.path.insert(0, HERE)
    sys.path.insert(1, ROOT)
    import check
    import run

    readings = {}
    orig = check.run_checks

    def keep(session, *a, **k):
        numbers = orig(session, *a, **k)
        readings["pose"] = session.pose_readings
        return numbers

    check.run_checks = keep
    for program in args.programs:
        for seed in args.seeds:
            spec = run.load_spec(args.workload)
            spec["cell"]["warmup_requests"] = args.warmup
            t = time.perf_counter()
            out = run.execute(spec, seed, args.seconds, 0, t_start=t,
                              program=None if program == "sound" else program)
            print(json.dumps({"workload": args.workload, "program": program, "seed": seed,
                              "correct": out["correct"], "attempted": out["attempted"],
                              "checks": out["checks"],
                              "pose": [[a, b, round(c, 4), round(d, 5)]
                                       for a, b, c, d in readings.get("pose", [])],
                              "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

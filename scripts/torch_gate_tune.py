"""Time the dense-gate kernel on the card at the main path's dense-tier
shapes, on seeded 8-cell inputs (chip_smoke.py's) and on the main path's
own launches, and check it against its plain version first.

    python3 scripts/torch_gate_tune.py [--root DIR] [--rows] [--bases N] [--recorded]

Per shape (P = Q in 4608 / 8704 / 17408 / 21760): one case of kernel ==
plain on three bases with partial counts and a live mask, then the device
time of one launch on `--bases` bases with every lane valid and the
distance test skipped. `--recorded` runs chip_smoke.py's in-memory main
path once, records the arguments of its dense-gate launches, and checks
and times the kernel on each. `--rows` also times five builds of the
kernel with the row-tile height fixed (nvcc -DMM_GATE_ROWS=32 ... 256, all
compiled together under build/torch_gate_tune/) beside the launch's own
choice (sources that predate that macro ignore it). `--root` names another checkout of the repository whose package is
used instead (the parent commit, unpacked under build/), so that two
versions are timed on one card in one call. The inputs, the timer and the
recorder are always this checkout's chip_smoke.py's, so both versions get
the same measurement. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROW_HEIGHTS = (32, 64, 96, 128, 256)


def _row_variants(_build, root):
    """{rows: mm_dense_gate of a build with that row-tile height}."""
    src = os.path.join(root, "model_matching_tpu_torch", "csrc", "dense_gate.cu")
    out_dir = os.path.join(root, "build", "torch_gate_tune")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for rows in _ROW_HEIGHTS:
        so = os.path.join(out_dir, f"dense_gate_rows{rows}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-DMM_GATE_ROWS={rows}",
               "-shared", "-o", so, src]
        procs[rows] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for rows, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {rows} rows:\n{out}")
        fn = ctypes.CDLL(so).mm_dense_gate
        fn.argtypes = _build.load().mm_dense_gate.argtypes
        fn.restype = ctypes.c_int
        fns[rows] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=_HERE)
    ap.add_argument("--rows", action="store_true")
    ap.add_argument("--bases", type=int, default=1)
    ap.add_argument("--recorded", action="store_true")
    a = ap.parse_args()
    sys.path.insert(0, _HERE)
    from chip_smoke import MAIN_SETUP, _device_ms, _gate_inputs, _record_gates

    sys.path[0] = os.path.abspath(a.root)

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the kernel runs only on the card")
    from model_matching_tpu_torch.estimator import StocsEstimator
    from model_matching_tpu_torch.ops import _build
    from model_matching_tpu_torch.ops.dense_gate import dense_gate, dense_gate_reference

    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    print(f"package root {os.path.abspath(a.root)}")
    _build.load()
    print("\n".join(l for l in _build.build_log.splitlines()
                    if "Used" in l or "spill" in l or "Compiling entry" in l))
    variants = _row_variants(_build, os.path.abspath(a.root)) if a.rows else {}
    gen = torch.Generator().manual_seed(0)
    tol, thr, rand_mask, marker = 0.3, 0.01, 0x7FFF8000, 1 << 15
    for p, q_tile in ((4608, 4608), (8704, 4352), (17408, 4352), (21760, 4352)):
        inp = _gate_inputs(torch, gen, 3, p, p, q_tile, dev)
        pf, qf, pc, qc, rp, rq, alpha, p_count, q_count, live = inp
        args = (pf, qf, pc, qc, rp, rq, alpha, tol, thr, rand_mask, marker)
        for skip in (True, False):
            kw = dict(q_tile=q_tile, skip_dist=skip, p_count=p_count,
                      q_count=q_count, live=live)
            got = dense_gate(*args, **kw)
            ref = dense_gate_reference(*args, **kw)
            torch.cuda.synchronize()
            for g, r, what in zip(got, ref, ("row_best", "counts")):
                if not torch.equal(g, r):
                    raise AssertionError(
                        f"{what} differs at P=Q={p} skip_dist={skip}: "
                        f"{int((g != r).sum())} elements")
        n = a.bases
        many = [t[:1].expand(n, *t.shape[1:]).contiguous() for t in inp[:7]]
        full = torch.full((n,), p, dtype=torch.int32, device=dev)
        kw = dict(q_tile=q_tile, skip_dist=True, p_count=full, q_count=full)
        ms = _device_ms(torch, lambda: dense_gate(*many, tol, thr, rand_mask, marker, **kw))
        line = f"P=Q={p} q_tile={q_tile} bases={n}: equal; kernel {ms:.4f} ms"
        if a.rows:
            rb = torch.empty((n, p, 16), dtype=torch.int32, device=dev)
            cn = torch.empty((n, p), dtype=torch.int32, device=dev)
            ptrs = [t.data_ptr() for t in many] + [full.data_ptr(), full.data_ptr(),
                                                   None, rb.data_ptr(), cn.data_ptr()]
            for rows, fn in variants.items():
                def call():
                    err = _build.launch(dev, fn, *ptrs, n, p, p, q_tile, 16, tol,
                                        thr, rand_mask, marker, 1, 1)
                    if err:
                        raise RuntimeError(f"launch failed: {err}")
                line += f"; {rows} rows {_device_ms(torch, call):.4f} ms"
        print(line, flush=True)
    if a.recorded:
        from model_matching_tpu_torch.synthetic import synthetic_setup

        model, scene, cfg = synthetic_setup(**MAIN_SETUP, device=dev)
        gates = _record_gates()
        try:
            StocsEstimator(model, scene, cfg).run(verbose=False)
        finally:
            gates.stop()
        for args, kw in gates.calls:
            got = dense_gate(*args, **kw)
            ref = dense_gate_reference(*args, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(g, r) for g, r in zip(got, ref)):
                raise AssertionError("the kernel differs on a recorded launch")
            ms = _device_ms(torch, lambda: dense_gate(*args, **kw))
            print(f"recorded launch, {args[2].shape[0]} bases, P={args[2].shape[1]}, "
                  f"Q={args[3].shape[1]}, q_tile={kw['q_tile']}: equal; kernel "
                  f"{ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

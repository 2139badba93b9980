"""Host time of the hand kernels' launch path on the card, by part.

    python3 scripts/torch_launch_path.py [--root DIR] [--iters N]

Times, with the host clock over N calls each (a device synchronise before
and after, none in between, so the number is what a caller pays to enqueue
one call): `row_gather` at the TPU probe's four shapes beside
`torch.index_select` and `table[idx]`, `dense_gate` at a small shape, and
the steps a ctypes launch is made of (the device guard, the two ways to
read the stream handle, `torch.empty`, `data_ptr()`, the argument checks,
the bare ctypes call of the row-gather kernel). `--root` names another
checkout of the repository whose package is timed instead (the parent
commit, unpacked under build/), so that two versions are compared inside
one process start on one card. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _per_call_us(torch, fn, iters):
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / iters / 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--iters", type=int, default=2000)
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the launch path is timed on the card")
    from model_matching_tpu_torch.ops import _build
    from model_matching_tpu_torch.ops.dense_gate import dense_gate
    from model_matching_tpu_torch.ops.row_gather import row_gather

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    print(f"package root {os.path.abspath(a.root)}; {a.iters} calls per number, "
          f"microseconds of host time per call")
    lib = _build.load()
    us = lambda fn: round(_per_call_us(torch, fn, a.iters), 3)

    gen = torch.Generator().manual_seed(5)
    for rows, n_idx in ((8, 8), (64, 64), (1024, 256), (4096, 512)):
        tab = torch.randn(rows, 128, generator=gen).to(dev)
        idx = torch.randint(0, rows, (n_idx,), generator=gen, dtype=torch.int32).to(dev)
        idx64 = idx.long()
        row = {"shape": f"[{rows}, 128] x {n_idx}",
               "row_gather_us": us(lambda: row_gather(tab, idx)),
               "index_select_us": us(lambda: torch.index_select(tab, 0, idx)),
               "plain_us": us(lambda: tab[idx64])}
        print("row_gather " + json.dumps(row))

    # the steps of one launch, on the last (largest) probe shape
    res = torch.empty((idx.numel(), 128), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    parts = {}
    parts["empty_call"] = us(lambda: None)
    parts["build_load"] = us(_build.load)
    parts["checks"] = us(lambda: (tab.dim() != 2 or tab.dtype != torch.float32
                                  or not tab.is_contiguous()
                                  or idx.dtype not in (torch.int32, torch.int64)
                                  or idx.device != tab.device))
    parts["idx_contiguous"] = us(idx.contiguous)
    parts["torch_empty"] = us(lambda: torch.empty((idx.numel(), 128),
                                                  dtype=torch.float32, device=dev))

    def guard():
        with torch.cuda.device(dev):
            pass
    parts["device_guard"] = us(guard)
    parts["current_device"] = us(torch.cuda.current_device)
    parts["current_stream_handle"] = us(
        lambda: torch.cuda.current_stream(dev).cuda_stream)
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        parts["raw_stream_handle"] = us(lambda: raw(0))
    parts["three_data_ptr"] = us(lambda: (tab.data_ptr(), idx.data_ptr(),
                                          res.data_ptr()))
    fn = lib.mm_row_gather
    tp, ip, rp_ = tab.data_ptr(), idx.data_ptr(), res.data_ptr()
    n = idx.numel()
    parts["ctypes_call_and_launch"] = us(lambda: fn(tp, ip, 0, rp_, n, 128, stream))
    parts["attribute_lookup_and_call"] = us(
        lambda: lib.mm_row_gather(tp, ip, 0, rp_, n, 128, stream))
    print("parts " + json.dumps(parts))

    # the dense gate's wrapper at a small shape (one 256-row tile): host
    # time per call, checks and output allocation included
    p = q = 256
    f = torch.randn(1, 8, p, generator=gen).to(dev)
    c = torch.randint(0, 8, (1, p), generator=gen, dtype=torch.int32).to(dev)
    r = torch.randint(0, 2 ** 31 - 1, (1, p), generator=gen).to(torch.int32).to(dev)
    al = torch.zeros(1, device=dev)
    full = torch.tensor([p], dtype=torch.int32, device=dev)
    gate_us = us(lambda: dense_gate(
        f, f, c, c, r, r, al, 0.3, 0.01, 0x7FFF8000, 1 << 14, q_tile=q,
        skip_dist=True, p_count=full, q_count=full))
    print(f"dense_gate P=Q={p}, one base: {gate_us} us per call")

    return 0


if __name__ == "__main__":
    sys.exit(main())

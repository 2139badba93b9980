"""The yardstick for the two hand-written kernels: the card's peaks, the least
bytes and operations each launch needs (frozen copies of the counts in
chip_smoke.py's `_gate_bound` and `_check_gathers`), and a recorder that
keeps each launch's inputs while traced requests run.

K1 is the congruent dense gate (csrc/dense_gate.cu), K2 the row gather
(csrc/row_gather.cu). A launch's bound is the larger of its bytes over the
peak bandwidth and its operations over the peak float32 rate; a kernel's
roofline share is the sum of its launches' bounds over the device time of
its kernels in the trace.
"""

from __future__ import annotations

import contextlib

import torch

# published dense peaks (NVIDIA's data sheet, SXM part): HBM bytes/s and
# float32 operations/s outside the tensor cores
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "fp32_ops_per_s": 67e12},
}
# substrings of the kernels' names in a profiler trace
K1_KERNEL, K2_KERNELS = "dense_gate_kernel", ("row_gather_vec4", "row_gather_scalar")
P_TILE = 256


def same_cell_pairs(p_cell, q_cell, p_count, q_count, live, q_tile):
    """Pairs (p, q) of equal cell id in the tiles the gate evaluates: the P
    tiles below ceil(p_count / 256) and the Q tiles below ceil(q_count /
    q_tile) (at least one each), and live ones where a live mask is given.
    One sorted Q tile at a time, every base at once."""
    b, p = p_cell.shape
    q = q_cell.shape[1]
    n_pt, n_qt = -(-p // P_TILE), q // q_tile
    dev = p_cell.device
    pt = torch.clamp((p_count.long() + P_TILE - 1) // P_TILE, 1, n_pt)
    qt = torch.clamp((q_count.long() + q_tile - 1) // q_tile, 1, n_qt)
    row_tile = torch.arange(p, device=dev) // P_TILE
    rows_ok = row_tile[None, :] < pt[:, None]
    pc = p_cell.contiguous()
    total = 0
    for j in range(n_qt):
        srt = torch.sort(q_cell[:, j * q_tile:(j + 1) * q_tile], dim=1).values.contiguous()
        n_eq = (torch.searchsorted(srt, pc, right=True) - torch.searchsorted(srt, pc))
        ok = rows_ok & (qt > j)[:, None]
        if live is not None:
            ok = ok & (live[:, row_tile, j] != 0)
        total += int((n_eq * ok).sum())
    return total


def gate_launch_cost(args, kw):
    """(bytes, operations) that one dense-gate launch needs, from its
    arguments alone: each input its modes read once (of a side's 8 feature
    rows the 3 direction rows with the cone test, the 3 position rows and
    the squared norm with the distance test), each output written once;
    one bucket operation per P row and Q column plus 14 for each same-cell
    pair of an evaluated tile."""
    pc, qc = args[2], args[3]
    b, p = pc.shape
    q = qc.shape[1]
    tensors = list(args[2:7]) + [kw["p_count"], kw["q_count"]]
    if kw.get("live") is not None:
        tensors.append(kw["live"])
    feat_rows = (3 if kw.get("check_cos", True) else 0) + (0 if kw["skip_dist"] else 4)
    nbytes = (sum(t.numel() * t.element_size() for t in tensors)
              + feat_rows * b * (p + q) * 4
              + b * p * kw.get("n_sub", 16) * 4 + b * p * 4)
    same = same_cell_pairs(pc, qc, kw["p_count"], kw["q_count"], kw.get("live"),
                           kw["q_tile"])
    return nbytes, b * (p + q) + 14 * same


def gather_launch_bytes(table, idx):
    """Bytes one row gather needs: each distinct row read once, the indices
    read once, the rows written once."""
    c = table.shape[1]
    ix = idx.reshape(-1)
    return (int(torch.unique(ix).numel()) * c * 4 + ix.numel() * ix.element_size()
            + ix.numel() * c * 4)


def bound_seconds(nbytes, ops, peaks):
    return max(nbytes / peaks["hbm_bytes_per_s"], ops / peaks["fp32_ops_per_s"])


class LaunchRecorder:
    """Keeps the arguments of every K1 and K2 launch made while `active()`
    is entered, by wrapping the names the port's modules call them by."""

    def __init__(self):
        self.gates = []      # (args, kwargs)
        self.gathers = []    # (table, idx)

    @contextlib.contextmanager
    def active(self):
        from model_matching_tpu_torch import congruent
        from model_matching_tpu_torch.ops import densefield, gridhash

        gate, gather = congruent.dense_gate, densefield.row_gather

        def rec_gate(*args, **kw):
            self.gates.append((args, kw))
            return gate(*args, **kw)

        def rec_gather(table, idx):
            self.gathers.append((table, idx))
            return gather(table, idx)

        saved = (congruent.dense_gate, densefield.row_gather, gridhash.row_gather)
        congruent.dense_gate = rec_gate
        densefield.row_gather = gridhash.row_gather = rec_gather
        try:
            yield self
        finally:
            congruent.dense_gate, densefield.row_gather, gridhash.row_gather = saved

    def k1_bound_seconds(self, peaks):
        return sum(bound_seconds(*gate_launch_cost(a, kw), peaks) for a, kw in self.gates)

    def k2_bound_seconds(self, peaks):
        return sum(bound_seconds(gather_launch_bytes(t, i), 0, peaks)
                   for t, i in self.gathers)

"""Row gather out[i, :] = table[idx[i], :]: the CUDA kernel's wrapper and
its plain torch version.

Replaces ``scripts/probe_vmem_gather.py`` (``make_probe`` -> ``kernel``),
the TPU's row gather from a table in fast memory. The scoring ladder
reads its dense-field rows (``ops/densefield.field_lookup``) and its
restricted-NN payload rows (``ops/gridhash._query_payload``) through it.
The kernel is ``csrc/row_gather.cu``; a gather is a copy, so the kernel
equals ``row_gather_reference`` bit for bit.
"""

from __future__ import annotations

import torch

from ..utils import trace
from . import _build


def row_gather_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain torch version: table[idx] ([..., C])."""
    return table[idx.long()]


_kernel = None   # the bound C function, resolved at the first CUDA call


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of a [R, C] float32 contiguous table at int32/int64 indices of
    any shape (each in [0, R); callers clamp). Returns [*idx.shape, C].

    CUDA tensors launch the kernel (built at first use) and count
    `k2.launches`; CPU tensors take the plain version. Nothing else is
    accepted."""
    global _kernel
    dev = table.device
    wide = idx.dtype == torch.int64
    # one pass; the slow path only names the offender
    if not (table.dtype == torch.float32 and table.dim() == 2
            and table.is_contiguous() and (wide or idx.dtype == torch.int32)
            and idx.device == dev and dev.type in ("cpu", "cuda")):
        if table.dim() != 2 or table.dtype != torch.float32 or not table.is_contiguous():
            raise ValueError(
                f"row_gather: table must be a contiguous 2-D float32 tensor, got "
                f"{tuple(table.shape)} {table.dtype}")
        if not (wide or idx.dtype == torch.int32):
            raise TypeError(f"row_gather: idx must be int32 or int64, got {idx.dtype}")
        if idx.device != dev:
            raise ValueError(f"row_gather: idx is on {idx.device}, the table on {dev}")
        raise ValueError(f"row_gather: unsupported device {dev}")
    rows, c = table.shape
    n_idx = idx.numel()
    if rows == 0 and n_idx > 0:
        raise ValueError("row_gather: gather from an empty table")
    if dev.type == "cpu":
        return row_gather_reference(table, idx)
    out = table.new_empty((*idx.shape, c))
    if n_idx == 0 or c == 0:
        return out
    if not idx.is_contiguous():
        idx = idx.contiguous()

    if _kernel is None:
        _kernel = _build.load().mm_row_gather
    err = _build.launch(dev, _kernel, table.data_ptr(), idx.data_ptr(), int(wide),
                        out.data_ptr(), n_idx, c)
    if err != 0:
        raise RuntimeError(f"row_gather: CUDA kernel launch failed (error {err})")
    trace.count("k2.launches")
    return out

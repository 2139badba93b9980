"""Build and load the port's CUDA kernels.

At first use, every ``model_matching_tpu_torch/csrc/*.cu`` is compiled with
nvcc for ``sm_90a`` (one nvcc process per source, all started together)
and linked into one shared library with a plain C interface, under
``build/torch_kernels/<hash of the sources>/`` at the repository root, and
loaded with ctypes. A changed source gives a new hash and a new
build; an existing library for the same sources is reused. Importing this
module builds nothing. The build is the span `kernels.build`; each build
counts `kernels.builds` and each load `kernels.loads` (utils/trace).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

from ..utils import trace

_CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None
build_log = ""         # nvcc's output (register and shared-memory use)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, /usr/local/cuda and PATH): "
            "the CUDA kernels cannot be built"
        )
    return found


def _declare(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mm_dense_gate.argtypes = [p] * 12 + [i, i, i, i, i, f, f, i, i, i, i, p]
    lib.mm_dense_gate.restype = ctypes.c_int
    lib.mm_dense_gate_rows.argtypes = [i, i, ctypes.POINTER(i)]
    lib.mm_dense_gate_rows.restype = ctypes.c_int
    lib.mm_row_gather.argtypes = [p, p, i, p, ctypes.c_longlong, i, p]
    lib.mm_row_gather.restype = ctypes.c_int
    for fn in (lib.mm_base_pre, lib.mm_base_post):
        fn.argtypes = [p, p]
        fn.restype = ctypes.c_int
    lib.mm_base_rounds_fmath.argtypes = [p, p, p, ctypes.c_longlong, p]
    lib.mm_base_rounds_fmath.restype = ctypes.c_int
    lib.mm_base_rounds_scratch_bytes.argtypes = []
    lib.mm_base_rounds_scratch_bytes.restype = ctypes.c_longlong
    return lib


# The current CUDA stream of a device index as the integer handle a launch
# takes, without building a torch.cuda.Stream object. A torch built without
# CUDA lacks the getter; load() raises there, so no launch reaches it.
raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def launch(dev: torch.device, fn, *args) -> int:
    """Call the bound C function `fn(*args, stream)` on the current stream
    of `dev`, under a device guard only when `dev` is not the current
    device. Returns the CUDA error code."""
    cur = torch.cuda.current_device()
    index = cur if dev.index is None else dev.index
    if index == cur:
        return fn(*args, raw_stream(index))
    with torch.cuda.device(index):
        return fn(*args, raw_stream(index))


def load():
    """The kernels' shared library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    if raw_stream is None:
        raise RuntimeError(
            "this torch build has no CUDA support: the CUDA kernels cannot be "
            "launched"
        )
    sources = sorted(_CSRC.glob("*.cu"))
    h = hashlib.sha256()
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out_dir = _BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / "libmm_torch_kernels.so"
    if not lib_path.exists():
        with trace.span("kernels.build"):
            _compile(sources, out_dir, lib_path)
        trace.count("kernels.builds")
    _lib = _declare(ctypes.CDLL(str(lib_path)))
    trace.count("kernels.loads")
    return _lib


def _compile(sources, out_dir, lib_path):
    """nvcc: one process per source, all started together, then the link."""
    global build_log
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs, procs = [], []
    for s in sources:
        obj = out_dir / f"{s.stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(s)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    build_log = "".join(logs)
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = out_dir / f"libmm_torch_kernels.{os.getpid()}.so"
    cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    for obj in objs:
        obj.unlink()

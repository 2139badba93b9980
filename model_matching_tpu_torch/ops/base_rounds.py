"""The sequential instance sampler's per-base parts, `pre` and `post`: the
CUDA kernel's wrapper and the plain torch versions.

`pre` decays the class probability inside the previous base's segment,
prunes edge points, takes the log weights, draws point 1, masks the
weights by PPF existence from it, and finds its segment's pixel radius and
the claim on its seed pixel. The flood fill (or the cached mask) follows.
`post` records the segment, draws points 2-4 under the round-2 angle and
round-3 plane, distance and existence masks, and writes the base's output
rows. Both work in place on a `Rounds`, the state the sampler allocates
once a call, and read the base number from the device, so that they can
be captured in CUDA graphs.

On a CUDA device each part is one launch of ``csrc/base_rounds.cu`` (two
grid kernels for `pre`, three for `post`, one at each draw), added because
the plain parts are hundreds of tiny kernels a base and the sampler was
bound by their launch cost; the kernels equal the plain parts bit for
bit. The plain versions
(`base_pre_reference`, `base_post_reference`) are the CPU path and the
reference the kernel is held to on the card. Each launch of a part counts
`base_rounds.launches` (utils/trace); a launch captured in a graph counts
when the sampler replays it (`count_replay`).
"""

from __future__ import annotations

import ctypes

import torch

from .. import flood, sampling
from ..utils import trace
from . import _build
from .fp import sqrt_rn
from .ppf import _angle_bin_cos_thresholds, _angle_bin_thresholds

# the most angle-bin thresholds the kernel holds (kMaxThresholds)
MAX_THRESHOLDS = 256

_draw_rows = sampling._categorical_rows_with_noise


def pixel_distance(pixel, seed_rc):
    """[K, N] float32 euclidean distance of every point's pixel to each
    seed pixel; the squares are exact integers, the root correctly
    rounded."""
    d = (pixel[None, :, :] - seed_rc[:, None, :]).to(torch.float32)
    return sqrt_rn(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])


def cached_id(seg_buffer, seed_rc):
    """[K] int32: the claim (base number, 0 for none) of each of the [K, 2]
    seed pixels in the [H, W] claim buffer, gathered at row * W + col
    (indexing by 0-dim device tensors would read them on the host)."""
    flat = seed_rc[:, 0].long() * seg_buffer.shape[1] + seed_rc[:, 1].long()
    return seg_buffer.reshape(-1)[flat]


class Rounds:
    """What a base's parts read and write, allocated once a sampler call on
    the device of `pos`: the scene's inputs, the state carried across
    bases (the decayed prior, the previous segment, the claim buffer, the
    mask cache, the output rows and the base number `row`), and what `pre`
    hands to the fill and to `post`. The caller writes each block of
    bases' Gumbel noise into `noise` ([rows, 4, 1, N]; base b reads row
    b % block) and the fill writes `seg` and `fill_ok`."""

    def __init__(self, table, pos, normal, class_prob0, edge_prob, pixel, valid,
                 shape, num_bases, block, dispersion, tr_disc, rot_disc,
                 plane_threshold, min_distance_base, internal_angle_threshold,
                 exists_bits=None):
        dev = pos.device
        h, w = shape
        n = pos.shape[0]
        self.table, self.exists_bits = table, exists_bits
        pos, normal, pixel = pos.contiguous(), normal.contiguous(), pixel.contiguous()
        self.pos, self.normal, self.valid = pos, normal, valid.contiguous()
        self.edge_prob, self.pixel = edge_prob.contiguous(), pixel
        self.block, self.tr_disc, self.rot_disc = block, tr_disc, rot_disc
        self.dispersion = dispersion
        self.plane_threshold = plane_threshold
        self.min_distance_base = min_distance_base
        self.internal_angle_threshold = internal_angle_threshold
        self.disp = torch.tensor(dispersion, dtype=torch.float32, device=dev)
        self.arange_n = torch.arange(n, dtype=torch.int32, device=dev)
        self.prow, self.pcol = pixel[:, 0].long(), pixel[:, 1].long()

        self.class_prob = class_prob0.clone(memory_format=torch.contiguous_format)
        self.prev_in = torch.zeros(n, dtype=torch.bool, device=dev)
        self.seg_buffer = torch.zeros((h, w), dtype=torch.int32, device=dev)  # claims
        self.masks = torch.zeros((num_bases + 1, h, w), dtype=torch.bool, device=dev)
        self.seg = torch.zeros((h, w), dtype=torch.bool, device=dev)
        self.fill_ok = torch.zeros(1, dtype=torch.bool, device=dev)
        self.noise = torch.empty((min(block, num_bases), 4, 1, n), dtype=torch.float32,
                                 device=dev)
        self.row = torch.zeros(1, dtype=torch.int64, device=dev)   # base number - 1
        self.raws = torch.zeros((num_bases, 4), dtype=torch.int32, device=dev)
        self.oks = torch.zeros(num_bases, dtype=torch.bool, device=dev)
        self.fills = torch.zeros(num_bases, dtype=torch.bool, device=dev)

        self.probs = torch.zeros(n, dtype=torch.float32, device=dev)
        self.log_w = torch.zeros(n, dtype=torch.float32, device=dev)
        self.idx1 = torch.zeros(1, dtype=torch.int32, device=dev)
        self.ok1 = torch.zeros(1, dtype=torch.bool, device=dev)
        self.seed_rc = torch.zeros((1, 2), dtype=pixel.dtype, device=dev)
        self.max_pix_dist = torch.zeros(1, dtype=torch.float32, device=dev)
        self.cached_id = torch.zeros(1, dtype=torch.int32, device=dev)

        self.graph_launches = 0   # kernel launches inside captured graphs
        self._args = None         # the kernel's arguments, made at its first launch
        self._scratch = None      # the kernel's scratch and running weights


# ------------------------------------------------------------ plain parts

def base_pre_reference(s: Rounds) -> None:
    """Plain torch `pre`: the decay, round 1, its PPF mask, the segment's
    largest feasible pixel distance and the claim on the seed pixel."""
    # cross-base dispersion decay inside the previous segment; this mutates
    # the carried class_prob, one float32 multiply a base
    s.class_prob.copy_(torch.where(s.prev_in & s.valid, s.class_prob * s.disp,
                                   s.class_prob))
    probs = torch.where(s.valid, s.class_prob, 0.0)
    probs = flood.prune_edge_points(probs, s.edge_prob)[None, :]
    log_w = sampling.log_weights(probs)      # once for the four draws
    g = s.noise.index_select(0, s.row % s.block)[0]           # [4, 1, N]
    idx1, ok1 = _draw_rows(g[0], probs, log_w)

    exists1 = sampling._pairwise_exists(
        s.table, s.pos, s.normal, idx1, s.tr_disc, s.rot_disc, s.exists_bits)
    probs = torch.where(exists1 & (s.arange_n != idx1[:, None]), probs, 0.0)
    seed_rc = s.pixel[idx1.long()]                            # [1, 2]
    pix_d = pixel_distance(s.pixel, seed_rc)
    s.probs.copy_(probs[0])
    s.log_w.copy_(log_w[0])
    s.idx1.copy_(idx1)
    s.ok1.copy_(ok1)
    s.seed_rc.copy_(seed_rc)
    s.max_pix_dist.copy_(torch.where(probs > 0, pix_d, 0.0).amax(dim=1))
    s.cached_id.copy_(cached_id(s.seg_buffer, seed_rc))


def base_post_reference(s: Rounds) -> None:
    """Plain torch `post`: the segment into the mask cache and `prev_in`,
    rounds 2-4 and the base's rows of raws, oks and fills; row += 1."""
    s.masks.index_copy_(0, s.row + 1, s.seg[None])
    s.prev_in.copy_(s.seg[s.prow, s.pcol])
    g = s.noise.index_select(0, s.row % s.block)[0]
    log_w, idx1 = s.log_w[None], s.idx1
    probs = torch.where(s.prev_in[None, :], s.probs[None], 0.0)

    idx2, ok2 = _draw_rows(g[1], probs, log_w)
    keep2 = sampling.round2_keep_mask(
        s.table, s.pos, s.normal, idx1, idx2, s.tr_disc, s.rot_disc,
        s.internal_angle_threshold, s.exists_bits)
    probs = torch.where(keep2, probs, 0.0)

    idx3, ok3 = _draw_rows(g[2], probs, log_w)
    keep3 = sampling.round3_keep_mask(
        s.table, s.pos, s.normal, idx1, idx2, idx3, s.tr_disc, s.rot_disc,
        s.plane_threshold, s.min_distance_base, s.exists_bits)
    probs = torch.where(keep3, probs, 0.0)

    idx4, ok4 = _draw_rows(g[3], probs, log_w)

    s.raws.index_copy_(0, s.row, torch.cat([idx1, idx2, idx3, idx4])[None])
    s.oks.index_copy_(0, s.row, s.ok1 & ok2 & ok3 & ok4)
    s.fills.index_copy_(0, s.row, s.fill_ok)
    s.row.add_(1)


# ------------------------------------------------------------ the kernel

class _Args(ctypes.Structure):
    """csrc/base_rounds.cu: BaseArgs, field by field."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "pos", "normal", "valid", "edge_prob", "pixel", "noise",
        "exists_bits", "exist_direct", "exist_keys", "thresholds",
        "class_prob", "prev_in", "seg_buffer", "seg", "masks", "fill_ok", "row",
        "raws", "oks", "fills",
        "probs", "log_w", "idx1", "ok1", "seed_rc", "max_pix_dist", "cached_id",
        "scratch", "work")] + [
        ("hw", ctypes.c_longlong), ("direct_words", ctypes.c_longlong)] + [
        (name, ctypes.c_int) for name in (
            "n", "h", "w", "block", "bits_words", "exist_size", "max_probes",
            "n_thresholds", "tr_disc", "rot_disc", "mode")] + [
        (name, ctypes.c_float) for name in (
            "disp", "plane_threshold", "min_distance_base", "internal_angle_threshold")]


_DTYPES = (("pos", torch.float32), ("normal", torch.float32), ("valid", torch.bool),
           ("edge_prob", torch.float32), ("pixel", torch.int32),
           ("class_prob", torch.float32))


def _kernel_args(s: Rounds) -> _Args:
    """The kernel's arguments for `s`, checked; made once (the tensors they
    point at stay where they are for the sampler call)."""
    dev = s.pos.device
    n = s.pos.shape[0]
    if n == 0:
        raise ValueError("base_rounds: no points to draw from")
    for name, dtype in _DTYPES:
        t = getattr(s, name)
        if t.dtype != dtype or t.device != dev or not t.is_contiguous():
            raise ValueError(f"base_rounds: {name} must be a contiguous {dtype} tensor "
                             f"on {dev}, got {t.dtype} on {t.device}")
    if tuple(s.pos.shape) != (n, 3) or tuple(s.normal.shape) != (n, 3) \
            or tuple(s.pixel.shape) != (n, 2):
        raise ValueError("base_rounds: pos, normal must be [N, 3] and pixel [N, 2]")
    table = s.table
    a = _Args()
    if s.exists_bits is not None:
        bits = s.exists_bits
        if bits.dtype != torch.int32 or bits.dim() != 2 or not bits.is_contiguous() \
                or bits.shape[1] * 32 < n or bits.device != dev:
            raise ValueError("base_rounds: exists_bits must be a contiguous [N, >= N/32] "
                             f"int32 tensor on {dev}")
        a.mode, a.exists_bits, a.bits_words = 0, bits.data_ptr(), bits.shape[1]
    elif table.exist_direct is not None:
        direct = table.exist_direct
        if direct.dtype != torch.int64 or not direct.is_contiguous() or direct.device != dev:
            raise ValueError(f"base_rounds: exist_direct must be contiguous int64 on {dev}")
        a.mode, a.exist_direct, a.direct_words = 1, direct.data_ptr(), direct.shape[0]
    else:
        keys = table.exist_keys
        size = keys.shape[0]
        if keys.dtype != torch.int32 or not keys.is_contiguous() or keys.device != dev \
                or size & (size - 1):
            raise ValueError(f"base_rounds: exist_keys must be contiguous int32 on {dev}, "
                             "of a power-of-two size")
        a.mode, a.exist_keys, a.exist_size = 2, keys.data_ptr(), size
        a.max_probes = table.exist_max_probes
    cos = _angle_bin_cos_thresholds(s.rot_disc)
    if cos.shape[0] > MAX_THRESHOLDS or (cos[1:] > cos[:-1]).any():
        raise ValueError(f"base_rounds: the kernel bisects at most {MAX_THRESHOLDS} "
                         "non-increasing angle-bin thresholds")
    th = _angle_bin_thresholds(s.rot_disc, str(dev))
    lib = _build.load()
    s._scratch = (torch.zeros(lib.mm_base_rounds_scratch_bytes(), dtype=torch.uint8,
                              device=dev),
                  torch.empty(n, dtype=torch.float32, device=dev))
    for name in ("pos", "normal", "valid", "edge_prob", "pixel", "noise", "class_prob",
                 "prev_in", "seg_buffer", "seg", "masks", "fill_ok", "row", "raws", "oks",
                 "fills", "probs", "log_w", "idx1", "ok1", "seed_rc", "max_pix_dist",
                 "cached_id"):
        setattr(a, name, getattr(s, name).data_ptr())
    a.thresholds, a.n_thresholds = th.data_ptr(), th.shape[0]
    a.scratch, a.work = (t.data_ptr() for t in s._scratch)
    h, w = s.seg.shape
    a.hw, a.n, a.h, a.w, a.block = h * w, n, h, w, s.block
    a.tr_disc, a.rot_disc = s.tr_disc, s.rot_disc
    a.disp, a.plane_threshold = s.dispersion, s.plane_threshold
    a.min_distance_base = s.min_distance_base
    a.internal_angle_threshold = s.internal_angle_threshold
    return a


_kernels = {}   # the bound C functions, resolved at the first CUDA call


def _launch(s: Rounds, name: str) -> None:
    dev = s.pos.device
    if dev.type != "cuda":
        raise ValueError(f"base_rounds: unsupported device {dev}")
    if s._args is None:
        s._args = _kernel_args(s)
    fn = _kernels.get(name)
    if fn is None:
        fn = _kernels[name] = getattr(_build.load(), name)
    err = _build.launch(dev, fn, ctypes.addressof(s._args))
    if err != 0:
        raise RuntimeError(f"base_rounds: CUDA kernel launch failed (error {err})")
    if torch.cuda.is_current_stream_capturing():
        s.graph_launches += 1
    else:
        trace.count("base_rounds.launches")


def base_pre(s: Rounds) -> None:
    """`pre` on `s`: one launch of its kernels for CUDA tensors, the
    plain version for CPU tensors; nothing else is accepted."""
    if s.pos.device.type == "cpu":
        base_pre_reference(s)
    else:
        _launch(s, "mm_base_pre")


def base_post(s: Rounds) -> None:
    """`post` on `s`: one launch of its kernels for CUDA tensors, the
    plain version for CPU tensors; nothing else is accepted."""
    if s.pos.device.type == "cpu":
        base_post_reference(s)
    else:
        _launch(s, "mm_base_post")


def count_replay(s: Rounds) -> None:
    """Count the kernel launches of one base replayed from the graphs that
    captured them."""
    if s.graph_launches:
        trace.count("base_rounds.launches", s.graph_launches)


def kernel_fmath(x: torch.Tensor):
    """(log(x), acos(x)) of a contiguous float32 CUDA tensor through the
    kernel's own copies of ops/fmath.py's log and acos: the test entry
    point that holds them to fmath bit for bit."""
    if x.dtype != torch.float32 or x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError("kernel_fmath: x must be a contiguous float32 CUDA tensor")
    out_log, out_acos = torch.empty_like(x), torch.empty_like(x)
    fn = _kernels.get("mm_base_rounds_fmath")
    if fn is None:
        fn = _kernels["mm_base_rounds_fmath"] = _build.load().mm_base_rounds_fmath
    err = _build.launch(x.device, fn, x.data_ptr(), out_log.data_ptr(),
                        out_acos.data_ptr(), x.numel())
    if err != 0:
        raise RuntimeError(f"kernel_fmath: CUDA kernel launch failed (error {err})")
    return out_log, out_acos

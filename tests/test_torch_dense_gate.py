"""The dense gate's plain version against the JAX package's Pallas kernel
(interpret mode) on the cases of tests/test_pallas_congruent.py: the
cross-Q-tile merge, the dynamic grid bounded by the valid-lane counts, the
skipped distance test and the banded live mask, and on the cell
distributions that could break a kernel that buckets its columns by a hash
of the cell id (synthetic.GATE_CELL_CASES). Integer outputs are compared
for equality. Also: the wrapper takes the plain version for CPU tensors
only (and then launches and builds nothing), and its argument check
rejects what the kernel does not take. The CUDA kernel is held against the
plain version on a card in tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from model_matching_tpu.ops.pallas_congruent import dense_gate as jgate
from model_matching_tpu_torch.ops import _build
from model_matching_tpu_torch.ops import dense_gate as tdg
from model_matching_tpu_torch.synthetic import GATE_CELL_CASES, gate_cells
from model_matching_tpu_torch.utils import trace

P_TILE = 256
MASK = 0x7FFFFFFF & ~((1 << 15) - 1)
MARKER = 1 << 14


def _feats(rng, n, count, tag):
    """JAX-layout features [16, n]: valid-first lanes, cells 0..5 in the
    low half, invalid lanes tagged in both halves."""
    f = rng.normal(0, 0.05, (16, n)).astype(np.float32)
    ok = np.arange(n) < count
    f[6] = (f[0:3] ** 2).sum(axis=0)
    f[7] = np.where(ok, rng.integers(0, 6, n), tag)
    f[8] = np.where(ok, 0.0, tag)
    return f


def _feats_of_cells(rng, cells, count, tag):
    """JAX-layout features [16, n] for given int32 cell ids: the id split
    into its 16-bit halves (rows 7 and 8), invalid lanes tagged in both."""
    n = cells.shape[0]
    f = _feats(rng, n, count, tag)
    ok = np.arange(n) < count
    f[7] = np.where(ok, cells & 0xFFFF, tag)
    f[8] = np.where(ok, cells >> 16, tag)
    return f


def _port_layout(f):
    """JAX features -> the port's [1, 8, N] features and [1, N] cell ids."""
    feat = np.concatenate([f[0:7], np.zeros((1, f.shape[1]), np.float32)])
    cell = np.where(f[7] < 0, f[7], f[7] + f[8] * 65536).astype(np.int32)
    return torch.from_numpy(feat[None].copy()), torch.from_numpy(cell[None].copy())


def _both(pf, qf, rp, rq, q_tile, p_count, q_count, skip_dist, live=None,
          alpha=0.1, tol=0.5, thr=0.01, n_sub=16):
    """The JAX kernel (16 stripes) and the port on the same inputs; with
    n_sub < 16 the JAX kernel's stripes are merged in groups of 16 / n_sub,
    which are the port's wider stripes."""
    p, q = pf.shape[1], qf.shape[1]
    jkw = dict(q_tile=q_tile, p_tile=P_TILE, interpret=True, skip_dist=skip_dist,
               p_count=None if p_count is None else jnp.int32(p_count),
               q_count=None if q_count is None else jnp.int32(q_count),
               live=None if live is None else jnp.asarray(live))
    jrb, jcnt = jgate(jnp.asarray(pf), jnp.asarray(qf), jnp.asarray(rp),
                      jnp.asarray(rq), alpha, tol, thr, MASK, MARKER, **jkw)
    tpf, tpc = _port_layout(pf)
    tqf, tqc = _port_layout(qf)
    trb, tcnt = tdg.dense_gate(
        tpf, tqf, tpc, tqc, torch.from_numpy(rp[None].copy()),
        torch.from_numpy(rq[None].copy()),
        torch.tensor([alpha], dtype=torch.float32), tol, thr, MASK, MARKER,
        q_tile=q_tile, skip_dist=skip_dist,
        p_count=torch.tensor([p if p_count is None else p_count], dtype=torch.int32),
        q_count=torch.tensor([q if q_count is None else q_count], dtype=torch.int32),
        live=None if live is None else torch.from_numpy(live[None].copy()),
        n_sub=n_sub,
    )
    jrb = np.asarray(jrb).reshape(p, n_sub, 16 // n_sub).max(-1)
    np.testing.assert_array_equal(jrb, trb[0].numpy())
    np.testing.assert_array_equal(np.asarray(jcnt), tcnt[0].numpy())
    return tcnt


def _rand32(rng, n):
    return rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("skip_dist", [False, True])
def test_cross_q_tile_merge(skip_dist):
    rng = np.random.default_rng(0)
    pf, qf = _feats(rng, 256, 256, -1), _feats(rng, 512, 512, -2)
    cnt = _both(pf, qf, _rand32(rng, 256), _rand32(rng, 512), 256, None, None,
                skip_dist)
    assert 0 < int(cnt.sum()) < 256 * 512


@pytest.mark.parametrize("p_cnt,q_cnt", [(512, 512), (300, 510), (256, 256),
                                         (1, 1), (0, 0)])
def test_dynamic_grid(p_cnt, q_cnt):
    rng = np.random.default_rng(p_cnt + 7 * q_cnt)
    pf, qf = _feats(rng, 512, p_cnt, -1), _feats(rng, 512, q_cnt, -2)
    _both(pf, qf, _rand32(rng, 512), _rand32(rng, 512), 256, p_cnt, q_cnt, False)


def test_live_mask():
    rng = np.random.default_rng(3)
    pf, qf = _feats(rng, 512, 512, -1), _feats(rng, 1024, 1024, -2)
    live = np.array([[1, 0, 1, 1], [0, 1, 1, 0]], np.int32)
    cnt = _both(pf, qf, _rand32(rng, 512), _rand32(rng, 1024), 256, 512, 1024,
                True, live=live)
    assert int(cnt.sum()) > 0


@pytest.mark.parametrize("skip_dist", [False, True])
@pytest.mark.parametrize("kind", GATE_CELL_CASES)
def test_cell_distributions(kind, skip_dist):
    """Two Q tiles of 256; the valid Q lanes end inside the second tile."""
    rng = np.random.default_rng(11)
    pf = _feats_of_cells(rng, gate_cells(kind, rng, 512), 400, -1)
    qf = _feats_of_cells(rng, gate_cells(kind, rng, 512), 300, -2)
    cnt = _both(pf, qf, _rand32(rng, 512), _rand32(rng, 512), 256, 400, 300,
                skip_dist)
    assert int(cnt.sum()) > 0
    if kind == "one_cell" and skip_dist:
        assert int(cnt.sum()) == 400 * 300      # every valid pair passes


@pytest.mark.parametrize("kind", [None, "all_distinct", "above_low_16_bits"])
def test_eight_stripes_q_tile_not_a_multiple_of_256(kind):
    """n_sub 8 on 400-column Q tiles (stripes of 50), partial counts."""
    rng = np.random.default_rng(12)
    cells = (lambda n: rng.integers(0, 6, n).astype(np.int32)) if kind is None \
        else (lambda n: gate_cells(kind, rng, n))
    pf = _feats_of_cells(rng, cells(256), 200, -1)
    qf = _feats_of_cells(rng, cells(1200), 930, -2)
    cnt = _both(pf, qf, _rand32(rng, 256), _rand32(rng, 1200), 400, 200, 930,
                False, n_sub=8)
    assert int(cnt.sum()) > 0


def _cpu_args(rng, p=256, q=256):
    pf, pc = _port_layout(_feats(rng, p, p, -1))
    qf, qc = _port_layout(_feats(rng, q, q, -2))
    rp = torch.from_numpy(_rand32(rng, p)[None].copy())
    rq = torch.from_numpy(_rand32(rng, q)[None].copy())
    return dict(p_feat=pf, q_feat=qf, p_cell=pc, q_cell=qc, rp=rp, rq=rq,
                alpha=torch.tensor([0.1]),
                p_count=torch.tensor([p], dtype=torch.int32),
                q_count=torch.tensor([q], dtype=torch.int32),
                live=torch.ones((1, 1, 1), dtype=torch.int32), q_tile=q)


@pytest.mark.parametrize("name,change,error", [
    ("p_feat", lambda t: t.double(), TypeError),
    ("q_cell", lambda t: t.long(), TypeError),
    ("rq", lambda t: t.float(), TypeError),
    ("alpha", lambda t: t.to("meta"), ValueError),
    ("live", lambda t: t.to("meta"), ValueError),
    ("q_feat", lambda t: t.transpose(1, 2).contiguous().transpose(1, 2), ValueError),
    ("rp", lambda t: t[:, :-1], ValueError),
    ("p_count", lambda t: t[None], ValueError),
])
def test_argument_check_rejects(name, change, error):
    """The one-pass check of the CUDA path, run here on CPU tensors: wrong
    dtype, another device, a non-contiguous view, a wrong shape."""
    args = _cpu_args(np.random.default_rng(5))
    tdg._check_kernel_args(torch.device("cpu"), **args)       # all good
    tdg._check_kernel_args(torch.device("cpu"), **dict(args, live=None))
    with pytest.raises(error, match=name):
        tdg._check_kernel_args(torch.device("cpu"), **dict(args, **{name: change(args[name])}))


def test_wrapper_cpu_takes_plain_version_only():
    rng = np.random.default_rng(4)
    pf, pc = _port_layout(_feats(rng, 256, 256, -1))
    qf, qc = _port_layout(_feats(rng, 256, 256, -2))
    r = torch.from_numpy(_rand32(rng, 256)[None].copy())
    kw = dict(q_tile=256, skip_dist=False, p_count=torch.tensor([256], dtype=torch.int32),
              q_count=torch.tensor([256], dtype=torch.int32))
    args = (pf, qf, pc, qc, r, r, torch.tensor([0.1]), 0.5, 0.01, MASK, MARKER)
    before = trace.total("k1.launches")
    built = (_build._lib, tdg._kernel)
    got = tdg.dense_gate(*args, **kw)
    ref = tdg.dense_gate_reference(*args, **kw)
    assert trace.total("k1.launches") == before
    assert (_build._lib, tdg._kernel) == built      # nothing was built or bound
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError):
        tdg.dense_gate(*meta, **{k: v.to("meta") if isinstance(v, torch.Tensor)
                                 else v for k, v in kw.items()})


def test_gate_rows_takes_only_a_cuda_device():
    """The launcher's row height is asked of the card; on the CPU, where the
    plain version has no blocks, gate_rows refuses and builds nothing."""
    built = (_build._lib, tdg._kernel)
    for dev in ("cpu", torch.device("cpu"), "meta"):
        with pytest.raises(ValueError, match="not a CUDA device"):
            tdg.gate_rows(1, 26112, dev)
    assert (_build._lib, tdg._kernel) == built

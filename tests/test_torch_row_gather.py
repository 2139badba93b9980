"""The row gather (ops/row_gather.py) on the CPU: its plain version equals
np.take at the TPU probe's four shapes (scripts/probe_vmem_gather.py:
f32 [rows, 128] tables, `n_idx` indices), and the two scoring reads that
go through it, the dense-field row read and the restricted-NN payload
read, return what the JAX package's do on the same multi-dimensional
query batches. A gather is a copy: every comparison is exact. The CUDA
kernel itself is held to the plain version in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from model_matching_tpu.ops import densefield as jdf, gridhash as jgh
from model_matching_tpu_torch.ops import _build
from model_matching_tpu_torch.ops import densefield as tdf, gridhash as tgh
from model_matching_tpu_torch.ops import row_gather as trg
from model_matching_tpu_torch.ops.row_gather import row_gather, row_gather_reference
from model_matching_tpu_torch.utils import trace


@pytest.mark.parametrize("rows,n_idx", [(8, 8), (64, 64), (1024, 256), (4096, 512)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_plain_gather_equals_np_take(rows, n_idx, dtype):
    rng = np.random.default_rng(rows)
    tab = rng.normal(size=(rows, 128)).astype(np.float32)
    idx = rng.integers(0, rows, n_idx)
    want = np.take(tab, idx, axis=0)
    t_tab = torch.from_numpy(tab)
    t_idx = torch.from_numpy(idx).to(dtype)
    before = trace.total("k2.launches")
    built = (_build._lib, trg._kernel)
    got = row_gather(t_tab, t_idx)
    assert trace.total("k2.launches") == before      # the CPU takes the plain version
    assert (_build._lib, trg._kernel) == built      # and builds and binds nothing
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(row_gather_reference(t_tab, t_idx).numpy(), want)
    # any index shape
    idx2 = idx.reshape(-1, 2)
    np.testing.assert_array_equal(row_gather(t_tab, torch.from_numpy(idx2).to(dtype)).numpy(),
                                  np.take(tab, idx2, axis=0))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    tab = torch.zeros(16, 8)
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="contiguous"):
        row_gather(tab.t(), idx)
    with pytest.raises(ValueError, match="float32"):
        row_gather(tab.double(), idx)
    with pytest.raises(TypeError, match="int32 or int64"):
        row_gather(tab, idx.float())
    with pytest.raises(ValueError, match="unsupported device"):
        row_gather(tab.to("meta"), idx.to("meta"))
    with pytest.raises(ValueError, match="idx is on"):
        row_gather(tab, idx.to("meta"))
    with pytest.raises(ValueError, match="2-D"):
        row_gather(tab[0], idx)
    with pytest.raises(ValueError, match="empty table"):
        row_gather(tab[:0], idx)
    # no rows asked of an empty table, and a non-contiguous index, are fine
    assert row_gather(tab[:0], idx[:0]).shape == (0, 8)
    wide = torch.arange(8).view(4, 2).t()
    assert torch.equal(row_gather(tab, wide), tab[wide])


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(21)
    pos = rng.uniform(-0.05, 0.05, (900, 3)).astype(np.float32)
    nrm = rng.normal(size=(900, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    prob = rng.uniform(0.1, 1.0, 900).astype(np.float32)
    # the scoring shape: [hypotheses, model points, 3]
    q = (pos[rng.integers(0, 900, (40, 60))]
         + rng.normal(0, 0.003, (40, 60, 3))).astype(np.float32)
    q[0, :5] = 3.0
    return pos, nrm, prob, q


def test_field_lookup_batches_unchanged(scene):
    pos, nrm, prob, q = scene
    jf = jdf.build_dense_field(pos, nrm, 0.005, prob=prob)
    tf = tdf.build_dense_field(pos, nrm, 0.005, prob=prob)
    got = tdf.field_lookup(tf, torch.from_numpy(q))
    for a, b in zip(jdf.field_lookup(jf, jnp.asarray(q)), got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert got[0].shape == (40, 60, 3)


def test_payload_query_batches_unchanged(scene):
    pos, nrm, prob, q = scene
    jg = jgh.build_neighbor_grid(pos, cell_size=0.005, normal=nrm, prob=prob)
    tg = tgh.build_neighbor_grid(pos, cell_size=0.005, normal=nrm, prob=prob)
    ji, jd, jk, jpay = jgh._query_payload(jg, jnp.asarray(q), 0.005)
    ti, td, tk, tpay = tgh._query_payload(tg, torch.from_numpy(q), 0.005)
    assert tpay.shape == (40, 60, tg.cell_cap, 8)
    for a, b in ((ji, ti), (jd, td), (jk, tk), (jpay, tpay)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int((ti >= 0).sum()) > 1000

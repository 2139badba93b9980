"""PPF-table persistence and model loading of the port against the JAX
package, on the CPU: the .npz format read both ways with equal arrays,
resize_table (built in torch, with no bulk host read) and
load_model_pack(standardize=True) giving the JAX package's shapes, probe
buckets and contents. Tables come from the seeded
synthetic model (synthetic.synthetic_arrays). Everything here is integer
or copied data, so every comparison is exact."""

import numpy as np
import pytest
import torch

from model_matching_tpu import model as jmodel, ppf_table as jtab
from model_matching_tpu.io import ply as jply
from model_matching_tpu_torch import model as tmodel, ppf_table as ttab
from model_matching_tpu_torch.synthetic import synthetic_arrays

_FIELDS = ("exist_keys", "bin_keys", "bin_offset", "bin_count", "pairs",
           "bin_direct", "exist_direct")


def _same_table(t, j):
    for f in _FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype),
                                          err_msg=f)
    for f in ("tr_disc", "rot_disc", "exist_max_probes", "bin_max_probes"):
        assert getattr(t, f) == getattr(j, f), f


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("model")
    mpos, mnrm, *_ = synthetic_arrays(200, 300, seed=6)
    table, _ = ttab.build_ppf_table(mpos, mnrm, 5, 5)
    rgb = np.random.default_rng(6).integers(0, 256, (200, 3)).astype(np.float32)
    jply.write_ply(str(d / "model_search.ply"), mpos, mnrm, rgb)
    ttab.save_ppf_table(str(d / "t_table.npz"), table, extra_meta={"source": "synthetic"})
    jt, _ = jtab.build_ppf_table(mpos, mnrm, 5, 5)
    jtab.save_ppf_table(str(d / "j_table.npz"), jt, extra_meta={"source": "synthetic"})
    return d, table, jt


def test_npz_cross_load(model_files):
    d, table, jt = model_files
    _same_table(table, jt)
    for name in ("t_table.npz", "j_table.npz"):
        t, tmeta = ttab.load_ppf_table(str(d / name))
        j, jmeta = jtab.load_ppf_table(str(d / name))
        assert tmeta == jmeta and tmeta["format_version"] == ttab.FORMAT_VERSION
        _same_table(t, j)
        _same_table(t, jt)


def test_npz_version_checked(model_files, tmp_path):
    d, table, _jt = model_files
    path = str(tmp_path / "v.npz")
    ttab.save_ppf_table(path, table, extra_meta={"format_version": 99})
    with pytest.raises(ValueError, match="version"):
        ttab.load_ppf_table(path)


@pytest.mark.parametrize("direct_size", [0, None, 1 << 16])
def test_resize_table_matches_jax(model_files, direct_size):
    _d, table, jt = model_files
    t = ttab.resize_table(table, 1 << 14, 1 << 13, 70000, direct_size=direct_size)
    j = jtab.resize_table(jt, 1 << 14, 1 << 13, 70000, direct_size=direct_size)
    _same_table(t, j)
    assert t.exist_keys.shape[0] >= 1 << 14 and t.pairs.shape[0] == 70000


@pytest.mark.parametrize("direct_size", [None, ttab.DIRECT_CAP * 2])
@pytest.mark.parametrize("sizes", ["below", "equal", "above"])
def test_resize_table_reads_only_sizes(model_files, sizes, direct_size):
    """resize_table rebuilds on the table's device with no bulk read (a few
    counted scalar reads), counts one `ppf_table.resizes` a call, and gives
    the JAX package's arrays, with sizes below, equal to and above the
    table's own and the direct twins dropped or refused past DIRECT_CAP."""
    from model_matching_tpu_torch.utils import trace

    _d, table, jt = model_files
    own = (table.exist_keys.shape[0], table.bin_keys.shape[0], table.pairs.shape[0])
    args = {"below": (1 << 10, 1 << 10, 1000), "equal": own,
            "above": (own[0] * 2, own[1] * 2, own[2] + 5000)}[sizes]
    rec = trace.recorder()
    bytes0, resizes0 = rec.total("host_read_bytes"), rec.total("ppf_table.resizes")
    t = ttab.resize_table(table, *args, direct_size=direct_size)
    assert rec.total("host_read_bytes") - bytes0 < 4 << 10
    assert rec.total("ppf_table.resizes") - resizes0 == 1
    _same_table(t, jtab.resize_table(jt, *args, direct_size=direct_size))
    assert t.bin_direct is None and t.exist_direct is None
    for f in _FIELDS[:5]:
        assert getattr(t, f).device == getattr(table, f).device, f
    assert t.exist_keys.shape[0] >= args[0] and t.pairs.shape[0] == max(args[2], own[2])


@pytest.mark.parametrize("standardize", [False, True])
def test_load_model_pack_matches_jax(model_files, standardize):
    d, _table, _jt = model_files
    args = (str(d / "model_search.ply"), str(d / "j_table.npz"), 4096)
    j = jmodel.load_model_pack(*args, standardize=standardize)
    t = tmodel.load_model_pack(*args, standardize=standardize, device="cpu")
    assert t.pos.shape == tuple(j.pos.shape) == ((512 if standardize else 256), 3)
    for f in ("pos", "normal", "rgb", "valid", "centroid", "pair_ep"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                      err_msg=f)
    _same_table(t.table, j.table)
    assert int(t.count()) == int(j.count()) == 200


def test_load_model_pack_errors(model_files, tmp_path):
    d, _table, _jt = model_files
    with pytest.raises(ValueError, match="capacity"):
        tmodel.load_model_pack(str(d / "model_search.ply"), str(d / "j_table.npz"), 100,
                               device="cpu")
    bare = str(tmp_path / "bare.ply")
    jply.write_ply(bare, np.zeros((4, 3), np.float32))
    with pytest.raises(ValueError, match="model-preprocess"):
        tmodel.load_model_pack(bare, str(d / "j_table.npz"), 4096, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmodel.load_model_pack(str(d / "model_search.ply"), str(d / "j_table.npz"), 4096)

"""The check that a sweep names the prior that scored its answer, shared by
the CPU case (tests/test_torch_sweep.py) and the card's
(tests/test_torch_cuda.py); it imports no jax.

On the synthetic scene (the edge-mapped one for the instance path), a
48-base sweep in three chunks of 16:
- the port's exact LCP of the returned pose under `best_prior` is the
  returned `best_lcp`;
- `best_chunk` is the chunk of the pool's argmax, read from sweeps stopped
  after fewer chunks: their pool best falls short of the whole sweep's
  before that chunk and equals it from that chunk on;
- the class path names the scene's prior, the instance path a chunk's;
- a sweep resumed from a checkpoint written after the best chunk names
  no prior (the checkpoint keeps only the last one), and one resumed
  before it names the same as the uninterrupted sweep;
- a sweep reads the host as often as before the sweep named its prior."""

import dataclasses

import numpy as np
import torch

from model_matching_tpu_torch import scoring
from model_matching_tpu_torch.estimator import StocsEstimator
from model_matching_tpu_torch.synthetic import synthetic_setup
from model_matching_tpu_torch.utils import trace

CHUNKS = 3
CHUNK = 16
# (path, sample_dispersion, seed) -> (the pool's best chunk, host reads):
# at dispersion 0.9 the decay leaves the first chunk the best, at 0.99 a
# later chunk wins; the reads are 7 a sweep and one a base on the
# instance path (the sampler's segment lookup)
CASES = {
    ("class", 0.9, 0): (2, 7),
    ("instance", 0.9, 0): (0, 7 + CHUNKS * CHUNK),
    ("instance", 0.99, 0): (1, 7 + CHUNKS * CHUNK),
}


def exact_lcp(est, world, prior):
    """The port's exact LCP of the world pose `world` under `prior`."""
    m, s = est.model, est.scene
    a = np.eye(4, dtype=np.float32)
    a[:3, 3] = -s.centroid.cpu().numpy()
    b = np.eye(4, dtype=np.float32)
    b[:3, 3] = m.centroid.cpu().numpy()
    centered = torch.from_numpy(a @ world @ b).to(s.pos.device)
    one = torch.ones(1, dtype=torch.bool, device=s.pos.device)
    return float(scoring.score_transforms(
        centered[None], one, m.pos, m.normal, m.valid, s.grid, s.pos, s.normal, prior,
        est.cfg.distance_threshold, est.cfg.lcp_normal_angle_threshold,
        model_count=m.valid.to(torch.float32).sum())[0])


def check_sweep_names_its_prior(dev, path, dispersion, seed, tmp_path):
    want_chunk, want_reads = CASES[(path, dispersion, seed)]
    model, scene, cfg = synthetic_setup(device=dev, edge=path == "instance")
    cfg = dataclasses.replace(cfg, sample_dispersion=dispersion, instance_scan_block=8)
    kw = dict(chunk=CHUNK, keep_per_chunk=16, seed=seed, verbose=False)

    def sweep(**more):
        est = StocsEstimator(model, scene, cfg)
        return est, est.run_sweep(CHUNKS * CHUNK, **kw, **more)

    est = StocsEstimator(model, scene, cfg)
    reads = trace.total("host_reads")
    best_lcp, world, _cw, _cs, stats = est.run_sweep(CHUNKS * CHUNK, **kw)
    assert trace.total("host_reads") - reads == want_reads
    assert stats["best_chunk"] == want_chunk and stats["best_refined"] in (False, True)
    assert abs(exact_lcp(est, world, est.best_prior) - best_lcp) <= 1e-6
    if path == "class":
        assert est.best_prior is scene.class_prob
        return
    if stats["best_refined"]:
        assert est.best_prior is est.class_prob
    else:
        # the fault the benchmark's check must catch: the last prior
        # reads another LCP where an earlier chunk won
        assert (abs(exact_lcp(est, world, est.class_prob) - best_lcp) > 1e-3) == (
            want_chunk < CHUNKS - 1)
    for k in range(1, CHUNKS):
        part = sweep(stop_after_chunks=k)[1][4]
        assert part["best_chunk"] == min(want_chunk, k - 1)
        assert (part["pool_best_lcp"] == stats["pool_best_lcp"]) == (k > want_chunk)

    def resumed(stop):
        ckpt = str(tmp_path / f"sweep.{path}.{dispersion}.{stop}.npz")
        sweep(checkpoint_path=ckpt, stop_after_chunks=stop)
        est, out = sweep(checkpoint_path=ckpt)
        assert out[0] == best_lcp and np.array_equal(out[1], world)
        return est

    after = resumed(want_chunk + 1)
    if not stats["best_refined"]:
        assert after.best_prior is None
    if want_chunk > 0:
        assert torch.equal(resumed(want_chunk).best_prior, est.best_prior)

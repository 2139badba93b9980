"""The instance-path sweep loop: one sweep a request, as `cli stocs-single
<bin> <box> --sweep 1024 --sweep-chunk 256` runs it on a scene with an edge
map: `StocsEstimator.run_sweep` on one of the frames, each ingested once in
set-up (sweep.py's set-up), on a pack loaded unstandardized as stocs-single
loads it. The traffic file gives "bases" and "chunk".

Each chunk of an instance sweep scores under the prior that its own
sampling left, so the check's `lcp_gap` weighs the plain LCP by the prior
that scored the answer, which the estimator names (`best_prior`). Set-up
stops, before any request, where the program names none. After the window
the loop prints how many answers each chunk of a sweep held."""

import collections
import json
import os
import sys

from loops import load_loop

_sweep = load_loop("sweep", os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

STANDARDIZE = _sweep.STANDARDIZE
scene_outputs = _sweep.scene_outputs


def setup(session):
    from model_matching_tpu_torch.estimator import StocsEstimator

    _sweep.setup(session)
    est = StocsEstimator(session.packs[0], session.sweep_scenes[0], session.cfg)
    if not hasattr(est, "best_prior"):
        raise SystemExit("isweep: the program does not name the prior that scored a "
                         "sweep's answer (StocsEstimator.best_prior)")


def request(session, rec, fr):
    from model_matching_tpu_torch.estimator import StocsEstimator

    t = session.spec["traffic"]
    with session.span("sweep", rec):
        est = StocsEstimator(session.packs[0], session.sweep_scenes[rec.frame], session.cfg)
        best_lcp, best_w, _cw, _cs, stats = est.run_sweep(t["bases"], chunk=t["chunk"],
                                                          verbose=False)
    rec.bases = int(stats["total_bases"])
    rec.ok = best_lcp > 0
    rec.best_chunk = stats["best_chunk"]
    rec.out = {"lcp": [best_lcp], "pose": [best_w], "prior": est.best_prior}


def release(session):
    held = collections.Counter(r.best_chunk for r in session.records + session.traced_records
                               if r.ok)
    print("isweep: answers by best chunk:", json.dumps(dict(sorted(held.items()))),
          file=sys.stderr)
    _sweep.release(session)

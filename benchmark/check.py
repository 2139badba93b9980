"""The comparison that decides `correct`: what the window's requests produced
against the plain reference (benchmark/reference) and the frames' ground
truth, once the window has closed.

Numbers compared, each against the cell's limit; a cell's file
(benchmark/cells/<cell>.json) names the numbers it compares:
- `scene_miss`: share of scene points that find no partner in the other
  cloud (within 0.1 mm, with equal class and edge probabilities), the worse
  direction, over the checked requests' ingested scenes;
- `normal_miss`: share of the judged side's scene points whose normal
  differs by more than 5 degrees from that of the nearest reference point;
- `model_miss`: the same two tests on the model packs, as one share;
- `lcp_gap`: the largest gap between a returned LCP and the reference's
  LCP of the returned pose on the reference's scene and model;
- `adds_mm`: the largest ADD-S of a returned pose (mean distance from each
  reference model point, posed, to the nearest of the model's points at
  the true pose), in mm, against the nearest true instance of its object,
  over every answer of the window;
- `lcp_short`: the largest shortfall of the reference's LCP at a returned
  pose below its LCP at that true pose, as a share of the latter, both on
  the reference's scene with the ingested (undecayed) probability, over
  every answer of the window;
- `failed`: requests in the window that raised or found no pose (limit 0).

The scene, model and LCP numbers cover a sample of requests drawn from the
seed, with the longest; the pose numbers cover every answer.

On the instance path the program scores with the prior as the sampler
decayed it, which only the program's own run can give: for `lcp_gap` the
reference takes each point's decay (decayed over ingested probability, the
program's state) from its partner and applies it to its own probability.
`adds_mm` and `lcp_short` read no program state: a fault in the decay that
moves the pose shows there.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference.cloud import nearest
from reference.lcp import lcp as ref_lcp
from reference.model import preprocess as ref_preprocess
from reference.scene import ingest as ref_ingest

POS_TOL = 1e-4          # metres
PROB_TOL = 1e-6
NORMAL_DEG = 5.0


def _angle_miss(na, nb):
    cos = (na * nb).sum(-1) / (torch.linalg.vector_norm(na, dim=-1)
                                * torch.linalg.vector_norm(nb, dim=-1))
    return ~(cos >= math.cos(math.radians(NORMAL_DEG)))


def compare_clouds(a, b):
    """a (the side judged) and b (the reference): dicts of pos [N, 3] and
    normal [N, 3], optionally prob [O, N] and edge_prob [N], on one device.
    Returns (share without a partner, the worse direction; share of a's
    normals more than 5 degrees from their nearest b point's)."""
    pa, pb = a["pos"].double(), b["pos"].double()
    if pa.shape[0] == 0 or pb.shape[0] == 0:
        return 1.0, 1.0

    def partners(x, y, xs, ys):
        idx, d2 = nearest(x, y)
        ok = d2 <= POS_TOL ** 2
        for k in ("prob", "edge_prob"):
            if k in xs:
                diff = (xs[k].double() - ys[k].double()[..., idx]).abs()
                ok &= (diff.reshape(-1, idx.numel()) <= PROB_TOL).all(0)
        return idx, ok

    ia, oka = partners(pa, pb, a, b)
    _ib, okb = partners(pb, pa, b, a)
    miss = max(1.0 - float(oka.double().mean()), 1.0 - float(okb.double().mean()))
    bad = _angle_miss(a["normal"].double(), b["normal"].double()[ia])
    return miss, float(bad.double().mean())


def port_scene(out):
    """The program's ingested scene as a cloud in the camera frame."""
    v = out["valid"]
    prob = out["class_prob"]
    prob = prob[None] if prob.dim() == 1 else prob
    return {"pos": out["pos"][v].double() + out["centroid"].double(),
            "normal": out["normal"][v], "prob": prob[:, v], "edge_prob": out["edge_prob"][v]}


def checked_requests(records, n, seed):
    """A sample of n requests drawn from the seed, with the longest in it."""
    if not records:
        return []
    rng = np.random.default_rng([seed, 11])
    pick = set(rng.choice(len(records), size=min(n, len(records)), replace=False).tolist())
    pick.add(max(range(len(records)), key=lambda k: records[k].t1 - records[k].t0))
    return [records[k] for k in sorted(pick)]


def adds_m(world, truths, model_pos):
    """(ADD-S of the pose `world` in metres, index of the nearest true
    instance): the mean distance from each model point posed by `world` to
    the nearest model point posed by a true pose, the least over `truths`."""
    dev, dt = model_pos.device, model_pos.dtype

    def posed(g):
        g = torch.as_tensor(np.asarray(g, np.float64), device=dev).to(dt)
        return model_pos @ g[:3, :3].T + g[:3, 3]

    got = posed(world)
    best = (math.inf, -1)
    for k, g in enumerate(truths):
        _i, d2 = nearest(got, posed(g))
        best = min(best, (float(torch.sqrt(d2).mean()), k))
    return best


def truths_of(session, fr, o):
    """The true poses that object o's answer is judged against: its own,
    or every instance's where one object stands in many places."""
    return [fr.truth[o]] if len(fr.truth) == len(session.objects) else fr.truth


def run_checks(session, limits, seed, dev):
    """Returns {name: (value, limit)} for each number that the cell's
    `limits` name (a cell compares the numbers that separate its sound runs
    from its faults)."""
    match = session.spec["config"]["match"]
    pre = session.spec["config"]["preprocess"]
    if session.scale != 1.0:
        match = {**match, "camera": {k: v * session.scale
                                     for k, v in match["camera"].items()}}
    args = (match["distance_threshold"], match["lcp_normal_angle_threshold"])
    numbers = {}
    failed = sum(1 for r in session.records if not r.ok)
    numbers["failed"] = (float(failed), limits["failed"])

    models, model_miss = [], 0.0
    for name, (ppos, pnrm) in zip(session.objects, session.pack_out):
        mpos, mnrm = ref_preprocess(session.sources[name][0], pre, device=dev)
        models.append((mpos, mnrm))
        miss, nmiss = compare_clouds({"pos": ppos.to(dev), "normal": pnrm.to(dev)},
                                     {"pos": mpos, "normal": mnrm})
        model_miss = max(model_miss, miss, nmiss)
    numbers["model_miss"] = (model_miss, limits["model_miss"])

    scenes = {}

    def ref_scene(k):
        if k not in scenes:
            fr = session.frames[k]
            scenes[k] = ref_ingest(fr.depth, np.stack(fr.probs), fr.edge, match, device=dev)
        return scenes[k]

    scene_miss, normal_miss, gap = 0.0, 0.0, 0.0
    for rec in checked_requests(session.records, session.spec["cell"]["checked_requests"],
                                seed):
        ref = ref_scene(rec.frame)
        port = {k: v.to(dev) for k, v in port_scene(session.scene_outputs(rec)).items()}
        miss, nmiss = compare_clouds(port, ref)
        scene_miss, normal_miss = max(scene_miss, miss), max(normal_miss, nmiss)
        if not rec.ok:
            continue
        for o, (mpos, mnrm) in enumerate(models):
            weight = ref["prob"][o]
            prior = rec.out.get("prior")
            if prior is not None and session.scene_spec["edge"]:
                weight = weight * decay_of(session.scene_outputs(rec), prior, ref, dev)
            got = ref_lcp(rec.out["pose"][o], mpos, mnrm, ref["pos"], ref["normal"], weight,
                          *args)
            gap = max(gap, abs(rec.out["lcp"][o] - got))
    numbers["scene_miss"] = (scene_miss, limits["scene_miss"])
    numbers["normal_miss"] = (normal_miss, limits["normal_miss"])
    numbers["lcp_gap"] = (gap, limits["lcp_gap"])

    # every answer's pose against the frame's ground truth
    adds, short, at_truth = 0.0, -math.inf, {}
    session.pose_readings = []      # (layout, object, ADD-S mm, shortfall) an answer
    for rec in session.records:
        if not rec.ok:
            continue
        fr, ref = session.frames[rec.frame], ref_scene(rec.frame)
        for o, (mpos, mnrm) in enumerate(models):
            truths = truths_of(session, fr, o)
            d, k = adds_m(rec.out["pose"][o], truths, mpos)
            adds = max(adds, d)
            key = (rec.frame, o, k)
            if key not in at_truth:
                at_truth[key] = ref_lcp(truths[k], mpos, mnrm, ref["pos"], ref["normal"],
                                        ref["prob"][o], *args)
            got = ref_lcp(rec.out["pose"][o], mpos, mnrm, ref["pos"], ref["normal"],
                          ref["prob"][o], *args)
            s = 1.0 - got / at_truth[key] if at_truth[key] > 0 else -math.inf
            short = max(short, s)
            session.pose_readings.append((fr.layout, o, 1e3 * d, s))
    numbers["adds_mm"] = (1e3 * adds, limits.get("adds_mm"))
    numbers["lcp_short"] = (short if short > -math.inf else 0.0, limits.get("lcp_short"))
    return {k: v for k, v in numbers.items() if k in limits}


def decay_of(out, prior, ref, dev):
    """Each reference point's decay: decayed over ingested probability at
    its partner among the program's points (1 where it has none)."""
    v = out["valid"]
    raw = out["class_prob"][v].double().to(dev)
    dec = prior[v].double().to(dev)
    ratio = torch.where(raw > 0, dec / torch.where(raw > 0, raw, 1.0), 1.0)
    pos = out["pos"][v].double().to(dev) + out["centroid"].double().to(dev)
    idx, d2 = nearest(ref["pos"].double(), pos)
    return torch.where(d2 <= POS_TOL ** 2, ratio[idx], 1.0)

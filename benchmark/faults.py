"""Programs put in the program's place for the checks' own tests: the
bfloat16 control and runs whose timed path is broken underneath. Each is
installed on a session before its set-up (`run.execute(..., program=name)`)
and returns the function that takes it out again. The benchmark's own runs
install none.

- `control`: the plain reference in bfloat16 answers every request: its
  ingest is the scene, its preprocessing the model packs, the true pose
  the answer, and the LCP there its score;
- `k1_halved`: the congruent dense gate (K1) drops the matches of every
  other row;
- `icp_skipped`: the ICP polish of the best pose is left out;
- `answer_moved`: every returned pose moved by 2 cm where it is produced;
- `half_scene`: half of every ingested scene left out;
- `stale_state`: every request hands back the first request's answer.
"""

from __future__ import annotations

import types

import numpy as np
import torch

LOW = torch.bfloat16


def _scaled_match(session):
    match = dict(session.spec["config"]["match"])
    match["camera"] = {k: v * session.scale for k, v in match["camera"].items()}
    return match


def _control(session):
    from reference.lcp import lcp
    from reference.model import preprocess
    from reference.scene import ingest

    pre = session.spec["config"]["preprocess"]
    models = {}

    def low_models():
        if not models:
            for name in session.objects:
                models[name] = preprocess(session.sources[name][0], pre, dt=LOW,
                                          device=session.dev)
        return [models[n] for n in session.objects]

    def request(s, rec, fr):
        match = _scaled_match(s)
        got = ingest(fr.depth, np.stack(fr.probs), fr.edge, match, dt=LOW, device=s.dev)
        n = got["pos"].shape[0]
        scene = {"pos": got["pos"], "normal": got["normal"], "class_prob": got["prob"],
                 "edge_prob": got["edge_prob"],
                 "valid": torch.ones(n, dtype=torch.bool, device=s.dev),
                 "centroid": torch.zeros(3, dtype=torch.float64, device=s.dev)}
        poses, lcps = [], []
        for o, (mpos, mnrm) in enumerate(low_models()):
            g = fr.truth[o]
            poses.append(g)
            lcps.append(lcp(g, mpos, mnrm, got["pos"], got["normal"], got["prob"][o],
                            match["distance_threshold"], match["lcp_normal_angle_threshold"],
                            dt=LOW))
        rec.ok = True
        rec.out = {"scene": scene, "lcp": lcps, "pose": poses}

    loop = session.loop
    session.loop = types.SimpleNamespace(STANDARDIZE=loop.STANDARDIZE, request=request)
    release = session.release

    def control_release():
        release()
        session.pack_out = low_models()

    session.release = control_release

    def undo():
        session.loop = loop
        del session.release
    return undo


def _patch(obj, name, new):
    old = getattr(obj, name)
    setattr(obj, name, new)
    return lambda: setattr(obj, name, old)


def _k1_halved(session):
    from model_matching_tpu_torch import congruent

    gate = congruent.dense_gate

    def halved(*args, **kw):
        row_best, counts = gate(*args, **kw)
        row_best, counts = row_best.clone(), counts.clone()
        row_best[:, 1::2] = 0
        counts[:, 1::2] = 0
        return row_best, counts

    return _patch(congruent, "dense_gate", halved)


def _icp_skipped(session):
    from model_matching_tpu_torch import estimator

    def skipped(best_t, model, scene, class_prob, cfg):
        # a score no pose reaches: the unrefined pose is kept
        return best_t, torch.full((), -1.0, device=best_t.device)

    return _patch(estimator, "_phase_refine", skipped)


HOOKS = ("STANDARDIZE", "setup", "scene_outputs", "window", "release")


def _wrap_request(session, after):
    loop = session.loop
    request = loop.request

    def wrapped(s, rec, fr):
        request(s, rec, fr)
        after(rec)

    session.loop = types.SimpleNamespace(
        request=wrapped, **{k: getattr(loop, k) for k in HOOKS if hasattr(loop, k)})

    def undo():
        session.loop = loop
    return undo


def _answer_moved(session):
    def move(rec):
        poses = []
        for g in rec.out.get("pose", []):
            g = np.array(g, np.float32, copy=True)
            g[:3, 3] += np.float32(0.02)
            poses.append(g)
        rec.out["pose"] = poses

    return _wrap_request(session, move)


def _stale_state(session):
    first = []

    def stale(rec):
        if first:
            rec.out, rec.ok = dict(first[0].out), first[0].ok
        else:
            first.append(rec)

    return _wrap_request(session, stale)


def _half_scene(session):
    from model_matching_tpu_torch import scene

    one, multi = scene.load_scene, scene.load_scene_multi

    def half(pack):
        pack.valid[1::2] = False
        return pack

    undo_one = _patch(scene, "load_scene", lambda *a, **k: half(one(*a, **k)))
    undo_multi = _patch(scene, "load_scene_multi",
                        lambda *a, **k: (lambda r: (half(r[0]), r[1]))(multi(*a, **k)))

    def undo():
        undo_one()
        undo_multi()
    return undo


PROGRAMS = {"control": _control, "k1_halved": _k1_halved, "icp_skipped": _icp_skipped,
            "answer_moved": _answer_moved, "half_scene": _half_scene,
            "stale_state": _stale_state}


def install(name, session):
    """Put program `name` in the program's place; returns the undo."""
    return PROGRAMS[name](session)

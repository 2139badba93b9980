"""The sweep loop: one sweep a request, as `cli stocs-single --sweep` runs
it without `--cluster`: `StocsEstimator.run_sweep` on one of the frames,
each ingested once in set-up, on a pack loaded unstandardized as
stocs-single loads it. The traffic file gives "bases" and "chunk"."""

from loops import scene_out

STANDARDIZE = False


def setup(session):
    from model_matching_tpu_torch.scene import load_scene

    session.sweep_scenes, session.sweep_scene_out = [], []
    for fr in session.frames:
        rgb, depth, probs, edge = fr.paths(session.objects)
        scene = load_scene(rgb, depth, probs[0], edge, session.cfg, device=session.dev)
        session.sweep_scenes.append(scene)
        session.sweep_scene_out.append(scene_out(scene))


def request(session, rec, fr):
    from model_matching_tpu_torch.estimator import StocsEstimator

    t = session.spec["traffic"]
    with session.span("sweep", rec):
        est = StocsEstimator(session.packs[0], session.sweep_scenes[rec.frame], session.cfg)
        best_lcp, best_w, _cw, _cs, stats = est.run_sweep(t["bases"], chunk=t["chunk"],
                                                          verbose=False)
    rec.bases = int(stats["total_bases"])
    rec.ok = best_lcp > 0
    rec.out = {"lcp": [best_lcp], "pose": [best_w]}


def scene_outputs(session, rec):
    return session.sweep_scene_out[rec.frame]


def release(session):
    session.sweep_scenes = []

"""The serve loop: one frame a request, as `cli serve` answers a line:
`load_scene` from the frame's files, then `StocsEstimator.run` on a pack
loaded in set-up with `standardize=True`."""

from loops import scene_out

STANDARDIZE = True


def request(session, rec, fr):
    from model_matching_tpu_torch.estimator import StocsEstimator
    from model_matching_tpu_torch.scene import load_scene

    rgb, depth, probs, edge = fr.paths(session.objects)
    with session.span("ingest", rec, "ingest_s"):
        scene = load_scene(rgb, depth, probs[0], edge, session.cfg, device=session.dev)
    with session.span("estimate", rec):
        est = StocsEstimator(session.packs[0], scene, session.cfg)
        res = est.run(verbose=False)
    rec.timings = dict(res.timings)
    rec.bases = res.num_bases
    rec.ok = res.best_index >= 0
    rec.out = {"scene": scene_out(scene), "prior": est.class_prob,
               "lcp": [res.best_lcp], "pose": [res.best_world_transform]}

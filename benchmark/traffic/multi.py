"""The multi loop: one frame a request, as `cli stocs-multi` runs it:
`load_scene_multi`, then `match_all_objects` over every object's pack,
loaded in set-up with `standardize=True`."""

from loops import scene_out

STANDARDIZE = True


def request(session, rec, fr):
    from model_matching_tpu_torch.multi import match_all_objects
    from model_matching_tpu_torch.scene import load_scene_multi

    rgb, depth, probs, edge = fr.paths(session.objects)
    with session.span("ingest", rec, "ingest_s"):
        scene, prob = load_scene_multi(rgb, depth, probs, edge, session.cfg,
                                       device=session.dev)
    with session.span("multi", rec, "multi_s"):
        best, poses, _nhyp = match_all_objects(session.packs, scene, prob, session.cfg,
                                               seed=session.cfg.seed)
    rec.bases = session.cfg.number_of_bases * len(session.objects)
    rec.ok = bool((best > 0).all())
    rec.out = {"scene": {**scene_out(scene), "class_prob": prob},
               "lcp": [float(v) for v in best], "pose": list(poses)}

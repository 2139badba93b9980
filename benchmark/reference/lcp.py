"""Plain weighted LCP of one pose: the share of the model that a pose lays
onto the scene, weighted by the scene's class probability.

Each model point, posed, takes its nearest scene point; it counts when
that point lies within the distance threshold and the two normals, the
model's posed, are within the angle threshold; it adds that scene point's
weight. The sum is divided by the number of model points.
"""

from __future__ import annotations

import math

import torch

from .cloud import nearest


def lcp(world, model_pos, model_normal, scene_pos, scene_normal, weight,
        distance_threshold, angle_deg, dt=torch.float64):
    """world: 4x4 pose of the model's frame in the camera's (numpy or
    tensor); model and scene tensors on one device. Returns a float."""
    dev = scene_pos.device
    w = torch.as_tensor(world, device=dev).to(dt)
    rot, t = w[:3, :3], w[:3, 3]
    q = (model_pos.to(dt)[:, None, :] * rot[None]).sum(-1) + t
    nq = (model_normal.to(dt)[:, None, :] * rot[None]).sum(-1)
    idx, d2 = nearest(q, scene_pos.to(dt))
    cos = (scene_normal.to(dt)[idx] * nq).sum(-1)
    hit = (d2 <= distance_threshold ** 2) & (cos > math.cos(math.radians(angle_deg)))
    s = torch.where(hit, weight.to(dt)[idx], 0.0).to(torch.float64).sum()
    return float(s) / model_pos.shape[0]

"""The one traffic generator: set-up, and one client sending the requests of
the kind that a traffic file names.

A traffic file (benchmark/traffic/<mix>.json) names its request loop under
"loop"; the loop is the module benchmark/traffic/<loop>.py, found by that
name, so that a new kind of traffic is a new file. A loop module gives

- `STANDARDIZE`: whether the model packs are loaded standardized, as the
  command it stands for loads them;
- `request(session, rec, frame)`: one request on one frame; it fills the
  record, and keeps references to what the checks compare in `rec.out`
  ("pose" and "lcp" a list an object, "scene" the ingested scene);

and may give `setup(session)` (set-up of its own after the packs are
loaded), `scene_outputs(session, rec)` (the ingested scene a request's
answer rests on, by default `rec.out["scene"]`) and `window(session,
seconds)` (by default a closed loop: the next request is sent when the
answer is back).

Set-up writes the run's frames and the models' source clouds under a
fresh directory in TMPDIR, preprocesses each model with the port's
`preprocess_model`, loads the packs, and runs the warm-up requests. The
closed loop cycles the frames from the first until `seconds` have passed;
the request in flight at that moment runs to its end, and the window ends
with it. Every request keeps references to what the checks compare (no
copies in the timed path).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import os
import shutil
import sys
import tempfile
import time
import traceback

import torch

import frames as frames_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def match_config(match: dict, scale: float = 1.0):
    """The port's MatchConfig from a configuration's "match" block;
    `scale` shrinks the image and the camera together (CPU tests)."""
    from model_matching_tpu_torch.config import CameraIntrinsics, MatchConfig

    m = dict(match)
    cam = m.pop("camera")
    m["camera"] = CameraIntrinsics(*(cam[k] * scale for k in ("fx", "cx", "fy", "cy")))
    m["image_width"] = int(round(m["image_width"] * scale))
    m["image_height"] = int(round(m["image_height"] * scale))
    m["cluster_symmetry"] = tuple(m["cluster_symmetry"])
    return MatchConfig(**m)


def load_loop(name, root=ROOT):
    """The request loop benchmark/traffic/<name>.py under the checkout `root`."""
    spec = importlib.util.spec_from_file_location(
        f"bench_loop_{name.replace('.', '_')}",
        os.path.join(root, "benchmark", "traffic", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Record:
    i: int
    frame: int
    t0: float = 0.0
    t1: float = 0.0
    ok: bool = False
    bases: int = 0
    ingest_s: float = 0.0
    multi_s: float = 0.0
    timings: dict = dataclasses.field(default_factory=dict)
    out: dict = dataclasses.field(default_factory=dict)   # what the checks compare


def scene_out(scene):
    """What the checks read of an ingested scene (references, no copies)."""
    return {"pos": scene.pos, "normal": scene.normal, "class_prob": scene.class_prob,
            "edge_prob": scene.edge_prob, "valid": scene.valid, "centroid": scene.centroid}


class Session:
    """One run of one cell: set-up, the window, the traced requests."""

    def __init__(self, spec, seed, device="cuda", scale=1.0):
        self.spec, self.seed, self.scale = spec, seed, scale
        self.dev = torch.device(device)
        self.loop = load_loop(spec["traffic"]["loop"], spec.get("root", ROOT))
        self.scene_spec = {**spec["config"]["scene"], **spec["traffic"].get("scene", {})}
        self.kind = self.scene_spec["kind"]
        self.objects = frames_mod.object_names(self.kind)
        self.records, self.traced_records = [], []
        self.window_s = 0.0
        self.tmp = None

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    @contextlib.contextmanager
    def span(self, name, rec, field=None):
        from torch.profiler import record_function

        t0 = time.perf_counter()
        with record_function(f"bench.{name}"):
            yield
            if field:
                self.sync()
        if field:
            setattr(rec, field, time.perf_counter() - t0)

    # ------------------------------------------------------------ set-up

    def setup(self):
        from model_matching_tpu_torch.config import PreprocessConfig
        from model_matching_tpu_torch.model import load_model_pack
        from model_matching_tpu_torch.preprocess import preprocess_model

        cfg_spec = self.spec["config"]
        self.cfg = match_config(cfg_spec["match"], self.scale)
        pre = PreprocessConfig(**cfg_spec["preprocess"])
        self.tmp = tempfile.mkdtemp(prefix="bench-frames-")
        cam = self.cfg.camera.as_tuple()
        self.frames = frames_mod.write_frames(
            self.tmp, self.kind, self.scene_spec["frames"], self.seed, cam,
            self.cfg.image_width, self.cfg.image_height, self.cfg.depth_scale,
            self.cfg.probability_scale, self.scene_spec["edge"])
        self.sources = frames_mod.write_models(self.tmp, self.kind,
                                               self.scene_spec["source_points"])
        self.packs = []
        for name in self.objects:
            d = os.path.join(self.tmp, "models", name)
            preprocess_model(os.path.join(d, "textured_vertices.ply"),
                             os.path.join(d, "model_search.ply"),
                             os.path.join(d, "ppf_table.npz"), pre, verbose=False,
                             device=self.dev)
            self.packs.append(load_model_pack(
                os.path.join(d, "model_search.ply"), os.path.join(d, "ppf_table.npz"),
                self.cfg.max_model_points, standardize=self.loop.STANDARDIZE,
                device=self.dev))
        if hasattr(self.loop, "setup"):
            self.loop.setup(self)
        for i in range(self.spec["cell"]["warmup_requests"]):
            self.request(i)
        self.sync()

    # --------------------------------------------------------- requests

    def request(self, i):
        rec = Record(i=i, frame=i % len(self.frames))
        fr = self.frames[rec.frame]
        rec.t0 = time.perf_counter()
        try:
            with self.span("request", rec):
                self.loop.request(self, rec, fr)
        except Exception:  # a failed request is counted, and the loop goes on
            traceback.print_exc(file=sys.stderr)
            rec.ok = False
        rec.t1 = time.perf_counter()
        return rec

    # ----------------------------------------------------------- window

    def window(self, seconds):
        if hasattr(self.loop, "window"):
            self.loop.window(self, seconds)
            return
        start = time.perf_counter()
        i = 0
        while time.perf_counter() - start < seconds:
            self.records.append(self.request(i))
            i += 1
        self.window_s = self.records[-1].t1 - start

    def traced(self, n, recorder):
        """n more requests, continuing the cycle, with K1/K2 launches
        recorded."""
        base = len(self.records)
        with recorder.active():
            for i in range(base, base + n):
                self.traced_records.append(self.request(i))

    def scene_outputs(self, rec):
        """The ingested scene a request's answer rests on."""
        if hasattr(self.loop, "scene_outputs"):
            return self.loop.scene_outputs(self, rec)
        return rec.out["scene"]

    def release(self):
        """Drop the program's state except what the checks compare: of each
        model pack its points in the model file's frame, and normals."""
        self.pack_out = [(p.pos[p.valid].double() + p.centroid.double(), p.normal[p.valid])
                         for p in self.packs]
        self.packs = []
        if hasattr(self.loop, "release"):
            self.loop.release(self)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def close(self):
        if self.tmp:
            shutil.rmtree(self.tmp, ignore_errors=True)

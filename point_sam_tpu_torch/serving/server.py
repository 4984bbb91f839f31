"""Interactive segmentation HTTP server (counterpart of
point_sam_tpu/serving/server.py).

Equivalent of the reference's Flask demo backend (reference: demo/app.py),
on the stdlib ``http.server`` and backed by the port's stateful Predictor
(encode once per cloud, cheap per-click decodes, on the card unless
``device="cpu"`` / ``--device cpu``). Route/JSON contract matches the reference so its
three.js frontend can drive it unmodified:

- ``GET /pointcloud/<name>``     load a PLY from the model dir, normalize,
                                 cache, return {"xyz": [...], "rgb": [...]}
                                 (app.py:110-140)
- ``POST /sampled_pointcloud``   accept browser-sampled points
                                 {"points": {...}, "colors": {...}}
                                 (app.py:91-107)
- ``POST /segment``              {"prompt_point": [x,y,z], "prompt_label"}
                                 -> {"seg": [bool,...]} appending the click
                                 and feeding the best mask logits back as
                                 the next mask prompt (app.py:177-206)
- ``POST /clear`` / ``/next`` / ``/save``  session management
                                 (app.py:143-174)
- ``GET /``, ``/static/...``     static frontend files (a path that
                                 leaves the static directory: 403).

    python -m point_sam_tpu_torch.serving.make_assets --out demo_models
    python -m point_sam_tpu_torch.serving.server --model_dir demo_models \
        [--ckpt_path model.safetensors] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np


class SegmentSession:
    """The demo's mutable per-server state (reference keeps module globals,
    app.py:69-82)."""

    def __init__(self, predictor, model_dir: Path, output_dir: Path):
        self.predictor = predictor
        self.model_dir = Path(model_dir)
        self.output_dir = Path(output_dir)
        self.lock = threading.Lock()
        self.clear_all()

    def clear_all(self):
        self.xyz = None
        self.rgb = None
        self.obj_name = None
        self.prompts: list = []
        self.labels: list = []
        self.prompt_mask = None
        self.segment_mask = None
        self.masks: list = []

    # ------------------------------------------------------------- routes
    def load_pointcloud(self, name: str):
        from ..utils.ply import load_ply

        path = self.model_dir / name
        xyz, rgb = load_ply(path)
        rgb = (np.full_like(xyz, 128) if rgb is None else rgb).astype(
            np.float32
        ) / 255.0
        # unit-sphere normalization (app.py:123-126)
        shift = xyz.mean(0)
        xyz = xyz - shift
        scale = np.linalg.norm(xyz, axis=1).max()
        xyz = (xyz / max(scale, 1e-12)).astype(np.float32)

        self.set_points(xyz, rgb, name)
        return {"xyz": xyz.flatten().tolist(), "rgb": rgb.flatten().tolist()}

    def set_points(self, xyz, rgb, name="sampled"):
        self.xyz, self.rgb, self.obj_name = xyz, rgb, name
        self.prompts, self.labels = [], []
        self.prompt_mask = None
        self.segment_mask = None
        self.masks = []
        self.predictor.set_pointcloud(xyz, rgb)

    def segment(self, prompt_point, prompt_label):
        if self.xyz is None:
            raise ValueError("no point cloud loaded")
        self.prompts.append(list(map(float, prompt_point)))
        self.labels.append(int(prompt_label))
        masks, scores, logits = self.predictor.predict_masks(
            np.asarray(self.prompts, np.float32),
            np.asarray(self.labels),
            self.prompt_mask,
            multimask_output=self.prompt_mask is None,
        )
        best = int(np.argmax(scores[0]))
        self.prompt_mask = logits[0, best]
        self.segment_mask = masks[0, best]
        return {"seg": self.segment_mask.tolist()}

    def clear(self):
        self.prompts, self.labels = [], []
        self.prompt_mask = None
        self.segment_mask = None
        return {"status": "cleared"}

    def next_instance(self):
        if self.segment_mask is not None:
            self.masks.append(np.asarray(self.segment_mask))
        return self.clear() | {"num_instances": len(self.masks)}

    def save(self):
        self.output_dir.mkdir(parents=True, exist_ok=True)
        stem = (self.obj_name or "cloud").split(".")[0]
        out = self.output_dir / f"{stem}.npy"
        np.save(
            out,
            {
                "xyz": self.xyz,
                "rgb": self.rgb,
                "mask": np.stack(self.masks) if self.masks else np.zeros(
                    (0, len(self.xyz)), bool
                ),
            },
        )
        self.clear()
        self.masks = []
        return {"status": "saved", "path": str(out)}


def make_handler(session: SegmentSession, static_dir: Path | None):
    class Handler(BaseHTTPRequestHandler):
        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_json(self):
            length = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(length) or b"{}")

        def log_message(self, fmt, *args):  # quiet
            pass

        def do_GET(self):
            try:
                if self.path.startswith("/pointcloud/"):
                    name = self.path[len("/pointcloud/"):]
                    with session.lock:
                        self._json(session.load_pointcloud(name))
                elif static_dir is not None:
                    rel = "index.html" if self.path in ("/", "") else \
                        self.path.lstrip("/")
                    f = (static_dir / rel).resolve()
                    if static_dir.resolve() not in f.parents and \
                            f != static_dir.resolve():
                        self._json({"error": "forbidden"}, 403)
                        return
                    if not f.is_file():
                        self._json({"error": "not found"}, 404)
                        return
                    ctype = {
                        ".html": "text/html", ".js": "text/javascript",
                        ".css": "text/css", ".ply": "application/octet-stream",
                    }.get(f.suffix, "application/octet-stream")
                    data = f.read_bytes()
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                else:
                    self._json({"error": "not found"}, 404)
            except Exception as e:  # surface errors as JSON
                self._json({"error": str(e)}, 500)

        def do_POST(self):
            try:
                data = self._read_json()
                with session.lock:
                    if self.path == "/segment":
                        self._json(session.segment(
                            data["prompt_point"], data["prompt_label"]))
                    elif self.path == "/sampled_pointcloud":
                        pts = np.asarray(
                            list(data["points"].values()), np.float32
                        ).reshape(-1, 3)
                        cols = np.asarray(
                            list(data["colors"].values()), np.float32
                        ).reshape(-1, 3)
                        session.set_points(pts, cols)
                        self._json({"response": "success"})
                    elif self.path == "/clear":
                        self._json(session.clear())
                    elif self.path == "/next":
                        self._json(session.next_instance())
                    elif self.path == "/save":
                        self._json(session.save())
                    else:
                        self._json({"error": "not found"}, 404)
            except Exception as e:
                self._json({"error": str(e)}, 500)

    return Handler


def build_server(model, *, device=None, host="127.0.0.1", port=5000,
                 model_dir="demo_models", output_dir="demo_out",
                 static_dir="bundled"):
    """(server, session): a ``ThreadingHTTPServer`` over a Predictor of
    ``model`` on ``device`` (``cuda`` unless given). ``port=0`` binds a
    free port (``server.server_address[1]``)."""
    from .predictor import Predictor

    if static_dir == "bundled":
        static_dir = Path(__file__).parent / "static"
    predictor = Predictor(model, device=device)
    session = SegmentSession(predictor, Path(model_dir), Path(output_dir))
    handler = make_handler(
        session, Path(static_dir) if static_dir else None
    )
    httpd = ThreadingHTTPServer((host, port), handler)
    return httpd, session


def main(argv=None):
    from ..evalsuite.eval_interactive import add_model_args, load_model

    parser = argparse.ArgumentParser(prog="point_sam_tpu_torch.serving.server")
    add_model_args(parser)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=5000)
    parser.add_argument("--model_dir", default="demo_models")
    parser.add_argument("--output_dir", default="demo_out")
    parser.add_argument("--static_dir", default="bundled")
    args = parser.parse_args(argv)

    model, device, _ = load_model(args)
    httpd, _ = build_server(
        model, device=device, host=args.host, port=args.port,
        model_dir=args.model_dir, output_dir=args.output_dir,
        static_dir=args.static_dir,
    )
    print(f"serving on http://{args.host}:{args.port}")
    httpd.serve_forever()


if __name__ == "__main__":
    main()

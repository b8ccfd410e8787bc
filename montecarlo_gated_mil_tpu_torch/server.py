"""Serving front-ends for :class:`~montecarlo_gated_mil_tpu_torch.serve.MCDOPredictor`.

Counterpart of ``montecarlo_gated_mil_tpu/server.py``: a JSONL batch mode
for offline scoring and a minimal stdlib HTTP server for online requests.
Both emit the same result schema, which mirrors the figure-caption
statistics of the reference's ``infer.py:47-74`` (mean/std/median/IQR/range
of P(cancer), mean predictive entropy and its verbal bucket).

JSONL request line::

    {"image": "scan_001.npy", "laterality": "R", "seed": 3, "maps": false}

``image`` is a path to a ``(H, W)`` array (``.npy``): float in [0, 1], or
raw integer pixels normalized on the device by ``pixel_max``.  Requests
without ``maps`` are scored through ``predict_many`` in chunks of 16; map
requests also return the mean/std attention maps, written as ``.npy``
artifacts (paths in the result).  ``"map_downsample": k`` returns their
exact k-fold box mean.

HTTP mode (stdlib ``http.server``; one process, one thread per request;
the predictor's gate serializes device work, uploads overlap it)::

    GET  /healthz            -> {"status": "ok", ...}
    POST /predict            <- {"image": [[...]] | "image_path": "...",
                                 "laterality": "L", "seed": 0, "maps": false}
"""

from __future__ import annotations

import itertools
import json
import os
import tempfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from montecarlo_gated_mil_tpu_torch.core.config import Config
from montecarlo_gated_mil_tpu_torch.mcdo.sampling import interpret_entropy
from montecarlo_gated_mil_tpu_torch.serve import MCDOPredictor, PredictionResult

# Map-free JSONL requests scored per predict_many call: bounds the images
# held on the host at once (about 79 MB each at the shipped geometry).
JSONL_CHUNK = 16


def build_predictor(
    cfg: Config,
    checkpoint: str | None = None,
    *,
    device: str | torch.device = "cuda",
    **kw,
) -> MCDOPredictor:
    """Predictor from a config and, optionally, a saved model.

    Without ``checkpoint`` the model is a fresh one seeded by ``cfg.seed``
    (smoke tests, throughput probes); with it, the weights
    ``run_training`` saved (``Checkpointer.save_params``), by name under
    ``cfg.model_path`` or by absolute path.  The JAX package's Orbax
    checkpoints are not read: convert them with ``weights.from_jax_params``.
    """
    from montecarlo_gated_mil_tpu_torch.experiment import build_model
    from montecarlo_gated_mil_tpu_torch.train.state import Checkpointer

    if checkpoint:
        weights = Checkpointer(cfg.model_path).restore_params(checkpoint)
    else:
        weights = build_model(cfg, seed=cfg.seed).state_dict()
    return MCDOPredictor.from_config(cfg, weights, device=device, **kw)


def result_to_dict(r: PredictionResult, *, maps_prefix: str | None = None) -> dict:
    """JSON-safe result record (schema shared by both front-ends).  Maps
    are written to ``{maps_prefix}_attention_{mean,std}.npy`` when a prefix
    is given, else inlined as nested lists."""
    s = r.stats
    out = {
        "prediction": int(r.prediction),
        "mean_probs": s.mean_probs.double().tolist(),
        "p_mean": float(s.mean),
        "p_std": float(s.std),
        "p_median": float(s.median),
        "p_iqr": float(s.iqr),
        "p_low": float(s.low),
        "p_high": float(s.high),
        "mean_entropy": float(s.mean_entropy),
        "entropy_bucket": interpret_entropy(s.mean_entropy),
        "num_instances": int(r.num_instances),
    }
    if r.attention_mean_maps is not None:
        if maps_prefix is not None:
            mean_path = f"{maps_prefix}_attention_mean.npy"
            std_path = f"{maps_prefix}_attention_std.npy"
            np.save(mean_path, r.attention_mean_maps)
            np.save(std_path, r.attention_std_maps)
            out["attention_mean_maps"] = mean_path
            out["attention_std_maps"] = std_path
        else:
            out["attention_mean_maps"] = np.asarray(r.attention_mean_maps, np.float64).tolist()
            out["attention_std_maps"] = np.asarray(r.attention_std_maps, np.float64).tolist()
    return out


def _load_image(path: str) -> np.ndarray:
    """Load a 2-D grayscale array, keeping integer dtypes (raw pixels ship
    to the device at 1-2 bytes/px and are normalized there)."""
    img = np.load(path)
    if img.ndim != 2:
        raise ValueError(f"{path}: expected a 2-D grayscale array, got {img.shape}")
    if img.dtype.kind in "ui":
        return img
    return np.asarray(img, np.float32)


def _validate_request(req: dict) -> None:
    """Reject malformed optional fields up front, so one bad line costs one
    ``{"error": ...}`` record (JSONL) or one 400 (HTTP), never the batch; a
    float or bool ``map_downsample`` is rejected, never truncated."""
    seed = req.get("seed", 0)
    if isinstance(seed, bool) or not isinstance(seed, int):
        raise ValueError(f"seed must be an integer, got {seed!r}")
    pm = req.get("pixel_max")
    if pm is not None and (isinstance(pm, bool) or not isinstance(pm, (int, float))):
        raise ValueError(f"pixel_max must be a number, got {pm!r}")
    k = req.get("map_downsample", 1)
    if isinstance(k, bool) or not isinstance(k, int) or k < 1:
        raise ValueError(f"map_downsample must be an integer >= 1, got {k!r}")


_BAD_REQUEST = (KeyError, OSError, ValueError, TypeError)


def serve_jsonl(
    predictor: MCDOPredictor,
    in_stream,
    out_stream,
    *,
    maps_dir: str | None = None,
) -> int:
    """Score JSONL requests from ``in_stream`` to ``out_stream`` in order;
    returns the number of lines written.

    A malformed line, or a request whose image cannot be loaded, produces
    an ``{"error": ...}`` line at its position instead of aborting the
    batch.  Every finished result is flushed as soon as its turn comes, so
    a crash mid-batch loses at most the current chunk.
    """
    requests: list[tuple[int, dict | Exception]] = []
    for i, line in enumerate(in_stream):
        line = line.strip()
        if not line:
            continue
        try:
            requests.append((i, json.loads(line)))
        except json.JSONDecodeError as e:
            requests.append((i, e))

    n = 0

    def emit(record: dict) -> None:
        nonlocal n
        out_stream.write(json.dumps(record) + "\n")
        n += 1

    pending: list[tuple[int, dict]] = []

    def flush_pending() -> None:
        if not pending:
            return
        results: dict[int, dict] = {}
        loaded: list[tuple[int, dict, np.ndarray]] = []
        for i, req in pending:
            try:
                _validate_request(req)
                loaded.append((i, req, _load_image(req["image"])))
            except _BAD_REQUEST as e:
                results[i] = {"error": str(e)}
        if loaded:
            rs = predictor.predict_many(
                [img for _, _, img in loaded],
                [req.get("laterality", "L") for _, req, _ in loaded],
                seeds=[int(req.get("seed", 0)) for _, req, _ in loaded],
                pixel_maxes=[req.get("pixel_max") for _, req, _ in loaded],
            )
            for (i, _, _), r in zip(loaded, rs):
                results[i] = result_to_dict(r)
        for i in sorted(results):
            emit(results[i])
        out_stream.flush()
        pending.clear()

    for i, req in requests:
        if isinstance(req, Exception):
            flush_pending()  # keep output in stream order
            emit({"error": f"bad request line: {req}"})
            continue
        if req.get("maps"):
            flush_pending()
            try:
                _validate_request(req)
                img = _load_image(req["image"])
            except _BAD_REQUEST as e:
                emit({"error": str(e)})
                continue
            prefix = None
            if maps_dir is not None:
                os.makedirs(maps_dir, exist_ok=True)
                prefix = os.path.join(maps_dir, f"request_{i:05d}")
            r = predictor.predict(
                img,
                req.get("laterality", "L"),
                seed=int(req.get("seed", 0)),
                return_maps=True,
                map_downsample=int(req.get("map_downsample", 1)),
                pixel_max=req.get("pixel_max"),
            )
            emit(result_to_dict(r, maps_prefix=prefix))
            out_stream.flush()
        else:
            pending.append((i, req))
            if len(pending) >= JSONL_CHUNK:
                flush_pending()
    flush_pending()
    out_stream.flush()
    return n


class _Handler(BaseHTTPRequestHandler):
    predictor: MCDOPredictor = None  # set by make_server
    maps_dir: str = None
    counter = None  # itertools.count, set by make_server
    data_root: str = None  # image_path requests allowed only under this root

    def log_message(self, *args):  # quiet by default
        pass

    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            p = self.predictor
            self._reply(200, {
                "status": "ok",
                "num_samples": p.num_samples,
                "quantized": p.quantized,
                "bucket": int(p.pipeline.bucket),
            })
        else:
            self._reply(404, {"error": "unknown path"})

    def _image_under_root(self, image_path) -> np.ndarray:
        """HTTP clients may only read files under the configured data root:
        an unrestricted ``np.load`` of a client-supplied path would let any
        client read or probe the server's files.  (The JSONL mode reads any
        path: its request file comes from the operator, not the network.)"""
        if self.data_root is None:
            raise ValueError(
                "image_path requests are disabled: start the server with a data "
                "root (cli: serve --data-root DIR) or send inline pixel data"
            )
        path = os.path.realpath(str(image_path))
        root = os.path.realpath(self.data_root)
        if os.path.commonpath([path, root]) != root:
            raise ValueError("image_path outside the configured data root")
        return _load_image(path)

    def do_POST(self):
        if self.path != "/predict":
            self._reply(404, {"error": "unknown path"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length))
            if "image" in req:
                img = np.asarray(req["image"], np.float32)
                if img.ndim != 2:
                    raise ValueError(f"expected 2-D image, got {img.shape}")
            else:
                img = self._image_under_root(req["image_path"])
            _validate_request(req)  # the JSONL front-end's contract
        except (*_BAD_REQUEST, json.JSONDecodeError) as e:
            self._reply(400, {"error": str(e)})
            return
        want_maps = bool(req.get("maps", False))
        try:
            # No lock here: the predictor is thread-safe and gates device
            # work itself, so request threads overlap their decode and
            # upload with the request on the device.
            r = self.predictor.predict(
                img,
                req.get("laterality", "L"),
                seed=req.get("seed", 0),
                return_maps=want_maps,
                map_downsample=req.get("map_downsample", 1),
                pixel_max=req.get("pixel_max"),
            )
            prefix = None
            if want_maps:
                # Full-resolution maps are 2 x 79 MB at the shipped size:
                # always server-side .npy artifacts, never inlined.
                os.makedirs(self.maps_dir, exist_ok=True)
                prefix = os.path.join(self.maps_dir, f"request_{next(self.counter):05d}")
            payload = result_to_dict(r, maps_prefix=prefix)
        except Exception as e:  # noqa: BLE001 — the client gets JSON, not a dropped socket
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._reply(200, payload)


def make_server(
    predictor: MCDOPredictor,
    port: int,
    host: str = "127.0.0.1",
    maps_dir: str | None = None,
    data_root: str | None = None,
) -> ThreadingHTTPServer:
    """HTTP server around a warm predictor (call ``serve_forever`` on it).

    One thread per request and no lock in front: the predictor serializes
    device work behind its ``max_inflight`` gate, so queued requests decode
    and upload while one runs.  Maps requested with ``"maps": true`` are
    written to ``maps_dir`` (default: a fresh temporary directory) as
    ``.npy`` files, their paths in the response.  ``data_root`` confines
    ``image_path`` requests to files under it; without it they are refused
    (inline ``image`` pixel data always works).
    """
    if maps_dir is None:
        maps_dir = tempfile.mkdtemp(prefix="mcgmil_maps_")
    handler = type("Handler", (_Handler,), {
        "predictor": predictor,
        "maps_dir": maps_dir,
        "counter": itertools.count(),
        "data_root": data_root,
    })
    return ThreadingHTTPServer((host, port), handler)


def run_server(
    cfg: Config,
    *,
    checkpoint: str | None = None,
    port: int = 8000,
    host: str = "127.0.0.1",
    warmup: bool = True,
    background_warmup: bool = False,
    maps_dir: str | None = None,
    data_root: str | None = None,
    device: str | torch.device = "cuda",
) -> None:
    """Build, warm and serve until interrupted.  ``background_warmup=True``
    listens after the cap bucket is warm and warms the rest in a daemon
    thread (requests meanwhile run at the smallest warm bucket that holds
    them: the same results, more padding)."""
    predictor = build_predictor(cfg, checkpoint, device=device)
    if warmup:
        predictor.warmup(background=background_warmup)
    srv = make_server(predictor, port, host, maps_dir, data_root)
    print(f"serving on http://{host}:{srv.server_address[1]} (POST /predict, GET /healthz)",
          flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()

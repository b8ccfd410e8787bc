"""Serving latency and throughput at full production scale.

Counterpart of the JAX package's ``tools/measure_serving.py``: the numbers a
deployment sees, beside the device time of ``measure_fullscale``.  A
predictor for the shipped configuration (``server.build_predictor``, seeded
weights) answers warm ``predict`` requests on four full-size synthetic
mammograms (the port's generator, ``data/synthetic.py``), as float32 and as
12-bit pixels in uint16: wall latency per request (host clock, the fetch of
the statistics included), p50/p90/min, and the back-to-back throughput;
then one maps request.  ``--concurrency 1,4 --duration S`` then soaks the
port's HTTP server (``server.py::make_server``, in this process, on a free
local port) from that many client threads per level for S seconds, the
images sent as ``image_path`` under a data root, and prints requests/s,
errors, the maximum latency and the percentiles that the level's request
count backs (p95 from 20 requests, p99 from 100).

    python -m montecarlo_gated_mil_tpu_torch.tools.measure_serving [--requests 30]
        [--concurrency 1,4 --duration 300 --max-inflight 1] [--config C.yml]
"""

from __future__ import annotations

import http.client
import json
import os
import tempfile
import threading
import time

import numpy as np

from montecarlo_gated_mil_tpu_torch.tools import _common


def _percentiles(lat_s: list[float], qs=(50, 90)) -> dict[str, float]:
    a = np.asarray(lat_s) * 1e3
    return {f"p{q}": float(np.percentile(a, q)) for q in qs} | {"min": float(a.min()),
                                                              "max": float(a.max())}


def soak(predictor, images: list[np.ndarray], concurrencies, duration: float) -> dict:
    """Client threads against the HTTP server for ``duration`` s per
    concurrency level, one warm predictor across levels."""
    from montecarlo_gated_mil_tpu_torch.server import make_server

    out = {}
    with tempfile.TemporaryDirectory(prefix="mcgmil_soak_") as root:
        paths = []
        for i, img in enumerate(images):
            paths.append(os.path.join(root, f"img_{i}.npy"))
            np.save(paths[-1], img)
        srv = make_server(predictor, port=0, data_root=root, maps_dir=root)
        server = threading.Thread(target=srv.serve_forever, daemon=True)
        server.start()
        try:
            for c in concurrencies:
                out[c] = _soak_one(srv.server_address[1], paths, c, duration)
        finally:
            srv.shutdown()
            srv.server_close()
            server.join(timeout=30)
    return out


def _soak_one(port: int, paths: list[str], concurrency: int, duration: float) -> dict:
    gate = threading.Barrier(concurrency + 1)
    stop = [0.0]  # set once every client is ready
    lat: list[list[float]] = [[] for _ in range(concurrency)]
    errors = [0] * concurrency
    samples: list[str] = []  # the first few errors

    def client(ci: int) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        gate.wait()
        i = ci
        while time.perf_counter() < stop[0]:
            body = json.dumps({"image_path": paths[i % len(paths)], "seed": i})
            t = time.perf_counter()
            try:
                conn.request("POST", "/predict", body, {"Content-Type": "application/json"})
                resp = conn.getresponse()
                payload = resp.read()
                if resp.status == 200:
                    lat[ci].append(time.perf_counter() - t)
                else:
                    errors[ci] += 1
                    samples.append(f"HTTP {resp.status}: {payload[:300]!r}")
            except (OSError, http.client.HTTPException) as e:
                errors[ci] += 1
                samples.append(f"{type(e).__name__}: {e}")
                conn.close()
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            i += concurrency
        conn.close()

    threads = [threading.Thread(target=client, args=(ci,)) for ci in range(concurrency)]
    for t in threads:
        t.start()
    stop[0] = time.perf_counter() + duration
    gate.wait()
    t_start = time.perf_counter()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t_start
    all_lat = [x for li in lat for x in li]
    row = {"ok": len(all_lat), "errors": sum(errors), "seconds": elapsed,
           "requests_per_s": len(all_lat) / elapsed}
    print(f"soak concurrency={concurrency} for {elapsed:.1f} s: {row['ok']} ok, "
          f"{row['errors']} errors, {row['requests_per_s']:.3f} requests/s", flush=True)
    if all_lat:
        # A percentile q is read only where at least 100 / (100 - q) requests
        # lie at or above it: p99 needs 100 requests, p95 20.
        qs = [q for q in (50, 95, 99) if len(all_lat) * (100 - q) >= 100]
        row |= _percentiles(all_lat, qs)
        print(f"  wall latency over {len(all_lat)} requests: "
              + "".join(f"p{q} {row[f'p{q}']:.1f} ms, " for q in qs)
              + f"max {row['max']:.1f} ms", flush=True)
    for s in samples[:5]:
        print(f"  sample error: {s}", flush=True)
    return row


def main(argv=None, *, device="cuda") -> dict:
    from montecarlo_gated_mil_tpu_torch.core.config import Config, load_config
    from montecarlo_gated_mil_tpu_torch.data.synthetic import synthetic_image
    from montecarlo_gated_mil_tpu_torch.server import build_predictor

    ap = _common.parser(__doc__)
    ap.add_argument("--config", help="YAML config (default: the shipped Config())")
    ap.add_argument("--requests", type=int, default=30)
    ap.add_argument("--concurrency", type=_common.ints, default=(),
                    help="client threads per soak level, e.g. 1,4 (default: no soak)")
    ap.add_argument("--duration", type=float, default=300.0, help="seconds per soak level")
    ap.add_argument("--max-inflight", type=int, default=1,
                    help="requests on the device at once (serve.py max_inflight)")
    args = ap.parse_args(argv)
    device = _common.start(device)
    cfg = load_config(args.config) if args.config else Config()
    d, n = cfg.data, args.requests
    results: dict = {}
    with _common.main_path_settings():
        t0 = time.perf_counter()
        predictor = build_predictor(cfg, device=device, max_inflight=args.max_inflight)
        print(f"build_predictor: {time.perf_counter() - t0:.2f} s (quantized="
              f"{predictor.quantized}, max_inflight={args.max_inflight})", flush=True)
        images = [synthetic_image(d.H, d.W, positive=bool(i % 2), seed=i) for i in range(4)]
        # The DICOM wire format: 12-bit pixels in uint16, normalized on the device.
        images16 = [np.round(im * 4095).astype(np.uint16) for im in images]
        t0 = time.perf_counter()
        predictor.predict(images[0])
        print(f"first request: {time.perf_counter() - t0:.2f} s", flush=True)
        for label, batch, kw in (("float32 in", images, {}),
                                 ("uint16 in", images16, {"pixel_max": 4095})):
            predictor.predict(batch[0], **kw)  # warm for the dtype
            lat = []
            for i in range(n):
                t0 = time.perf_counter()
                predictor.predict(batch[i % len(batch)], seed=i, **kw)
                lat.append(time.perf_counter() - t0)
            row = _percentiles(lat) | {"requests_per_s": n / sum(lat)}
            print(f"warm predict({label}) wall latency over {n}: p50 {row['p50']:.1f} ms, "
                  f"p90 {row['p90']:.1f} ms, min {row['min']:.1f} ms; back to back "
                  f"{row['requests_per_s']:.3f} requests/s", flush=True)
            results[label] = row
        predictor.predict(images[0], return_maps=True)
        t0 = time.perf_counter()
        r = predictor.predict(images[1], return_maps=True)
        results["maps_ms"] = (time.perf_counter() - t0) * 1e3
        print(f"predict(return_maps=True): {results['maps_ms']:.1f} ms warm (maps "
              f"{r.attention_mean_maps.shape}, {r.attention_mean_maps.nbytes / 1e6:.0f} MB a map "
              "fetched)", flush=True)
        if args.concurrency:
            results["soak"] = soak(predictor, images, args.concurrency, args.duration)
    return results


if __name__ == "__main__":
    main()

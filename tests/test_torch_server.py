"""The port's serving front-ends (server.py) on the CPU: the JSONL batch
mode against the JAX package's at dropout 0 and against the serial
``predict``, the HTTP server (health, predict, errors, map artifacts,
``data_root`` confinement, concurrent clients) and ``build_predictor``."""

import http.client
import io
import json
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from montecarlo_gated_mil_tpu.core.config import config_from_dict as jax_config
from montecarlo_gated_mil_tpu.experiment import build_model as jax_build_model
from montecarlo_gated_mil_tpu.serve import MCDOPredictor as JaxPredictor
from montecarlo_gated_mil_tpu.server import serve_jsonl as jax_serve_jsonl
from montecarlo_gated_mil_tpu_torch import server
from montecarlo_gated_mil_tpu_torch.core.config import config_from_dict
from montecarlo_gated_mil_tpu_torch.data.synthetic import synthetic_image
from montecarlo_gated_mil_tpu_torch.experiment import build_model
from montecarlo_gated_mil_tpu_torch.serve import MCDOPredictor
from montecarlo_gated_mil_tpu_torch.server import (
    build_predictor,
    make_server,
    result_to_dict,
    serve_jsonl,
)
from montecarlo_gated_mil_tpu_torch.train.state import Checkpointer
from montecarlo_gated_mil_tpu_torch.weights import from_jax_params


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The JAX package's test_server.py geometry: 128x128, patch 64, bucket 8, T=3.
RAW = {
    "N": 3,
    "seed": 0,
    "data": {
        "H": 128, "W": 128, "patch_size": 64, "overlap_train": 0.0,
        "overlap_val_test": 0.0, "empty_threshold": 0.05, "synthetic_count": 1,
    },
    "tpu": {"buckets": [8], "use_pallas_attention": False},
}


def _raw(**over):
    raw = json.loads(json.dumps(RAW))
    for k, v in over.items():
        raw[k] = {**raw[k], **v} if isinstance(v, dict) else v
    return raw


@pytest.fixture(scope="module")
def predictor():
    return build_predictor(config_from_dict(_raw()), device="cpu")


def _write_images(tmp_path, n, *, uint16=()):
    """``n`` synthetic mammograms as .npy (those in ``uint16`` as raw
    16-bit pixels); returns their paths."""
    paths = []
    for i in range(n):
        img = synthetic_image(128, 128, positive=bool(i % 2), seed=20 + i)
        if i in uint16:
            img = np.round(img * 65535).astype(np.uint16)
        p = tmp_path / f"img_{i}.npy"
        np.save(p, img)
        paths.append(str(p))
    return paths


def _jsonl(reqs):
    return "".join((r if isinstance(r, str) else json.dumps(r)) + "\n" for r in reqs)


def _serial(pred, req, **kw):
    """The record ``predict`` gives for one request, by itself."""
    r = pred.predict(np.load(req["image"]), req.get("laterality", "L"),
                     seed=req.get("seed", 0), pixel_max=req.get("pixel_max"), **kw)
    return result_to_dict(r)


def _both_serve_jsonl(raw, tmp_path):
    """The same requests through both packages' ``serve_jsonl``, with the
    same weights; returns each one's records."""
    jcfg = jax_config(raw)
    jmodel = jax_build_model(jcfg)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.key(0), jnp.zeros((2, 64, 64, 3)), jnp.ones(2, bool))["params"])
    jpred = JaxPredictor.from_config(jcfg, params)
    tpred = MCDOPredictor.from_config(config_from_dict(raw), from_jax_params(params), device="cpu")
    paths = _write_images(tmp_path, 3, uint16=(1,))
    reqs = [
        {"image": paths[0], "seed": 5},
        {"image": paths[1], "seed": 9, "laterality": "R"},
        "not json",
        {"image": paths[2], "seed": 2, "pixel_max": 0.5},
        {"image": str(tmp_path / "missing.npy")},
        {"image": paths[0], "seed": 1, "maps": True},
        {"image": paths[2], "seed": 1, "maps": True, "map_downsample": 3, "laterality": "R"},
    ]
    outs = {}
    for name, fn, pred in (("jax", jax_serve_jsonl, jpred), ("port", serve_jsonl, tpred)):
        out = io.StringIO()
        assert fn(pred, io.StringIO(_jsonl(reqs)), out,
                  maps_dir=str(tmp_path / f"maps_{name}")) == len(reqs)
        outs[name] = [json.loads(line) for line in out.getvalue().splitlines()]
    return outs


def test_serve_jsonl_matches_jax_at_dropout_zero(tmp_path, monkeypatch):
    """Dropout 0, the same weights: the JAX package's ``serve_jsonl`` on its
    predictor (jnp head) and the port's give the same records within 1e-4,
    errors at the same positions.  Overlap 0.5, so the maps average
    overlapping tiles.  The attention itself differs by up to about 4e-6
    between the two packages (the f32 rounding of a random r18 embed,
    ROADMAP.md "Faults", first entry), which the maps' peak normalization
    turns into up to 3e-5: the whole path's maps are held within 5e-5, and
    each map the port wrote is held within 1e-5 against the JAX package's
    ``attention_map_stats`` of the attention, tile indices and mask the
    port's request passed it."""
    from montecarlo_gated_mil_tpu.ops.patching import compute_tile_grid as jax_grid
    from montecarlo_gated_mil_tpu.viz.attention import attention_map_stats as jax_map_stats
    from montecarlo_gated_mil_tpu_torch import serve

    seen = []

    def recording(a, tile_indices, mask, grid, *, downsample):
        seen.append((a.numpy(), tile_indices.numpy(), mask.numpy(), grid, downsample))
        return port_map_stats(a, tile_indices, mask, grid, downsample=downsample)

    port_map_stats = serve.attention_map_stats
    monkeypatch.setattr(serve, "attention_map_stats", recording)
    raw = _raw(feature_dropout=0.0, attention_dropout=0.0,
               data={"overlap_val_test": 0.5}, tpu={"buckets": [16]})
    outs = _both_serve_jsonl(raw, tmp_path)
    for want, got in zip(outs["jax"], outs["port"]):
        assert set(got) == set(want)
        if "error" in want:
            continue
        assert got["prediction"] == want["prediction"]
        assert got["num_instances"] == want["num_instances"] > 0
        for k in ("mean_probs", "p_mean", "p_std", "p_median", "p_iqr", "p_low", "p_high",
                  "mean_entropy"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0, err_msg=k)
        for k in ("attention_mean_maps", "attention_std_maps"):
            if k in want:
                g, w = np.load(got[k]), np.load(want[k])
                assert g.shape == w.shape and g.dtype == np.float32
                np.testing.assert_allclose(g, w, atol=5e-5, rtol=0, err_msg=k)
    map_lines = [got for got in outs["port"] if "attention_mean_maps" in got]
    assert len(seen) == len(map_lines) == 2
    for (a, idx, mask, grid, k), got in zip(seen, map_lines):
        jgrid = jax_grid(grid.height, grid.width, grid.patch_size, grid.overlap)
        want = jax_map_stats(jnp.asarray(a), jnp.asarray(idx, jnp.int32), jnp.asarray(mask),
                             jgrid, downsample=k)
        for name, w in zip(("attention_mean_maps", "attention_std_maps"), want):
            np.testing.assert_allclose(np.load(got[name]), np.asarray(w), atol=1e-5, rtol=0)
    assert np.load(map_lines[1]["attention_mean_maps"]).shape == (2, 43, 43)


def test_serve_jsonl_error_lines_and_order(predictor, tmp_path):
    """The JAX package's test_server.py:86-116: a malformed line, a missing
    file and each malformed optional field cost one error line each, in
    place, and a good request after them still scores."""
    good = {"image": _write_images(tmp_path, 1)[0], "seed": 1, "maps": True}
    bad_fields = [
        {"image": good["image"], "maps": True, "map_downsample": "full"},
        {"image": good["image"], "seed": None},
        {"image": good["image"], "pixel_max": "x"},
        {"image": good["image"], "map_downsample": 0},
    ]
    text = _jsonl([good, "not json", {"image": "/nope.npy"}, *bad_fields, good])
    out = io.StringIO()
    assert serve_jsonl(predictor, io.StringIO(text), out, maps_dir=str(tmp_path / "maps")) == 8
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    assert np.load(lines[0]["attention_mean_maps"]).shape == (2, 128, 128)
    assert np.load(lines[0]["attention_std_maps"]).shape == (2, 128, 128)
    assert lines[1]["error"].startswith("bad request line")
    assert all(set(bad) == {"error"} for bad in lines[1:7])
    assert lines[7]["prediction"] == lines[0]["prediction"]
    assert lines[7]["p_mean"] == lines[0]["p_mean"]


def test_serve_jsonl_chunks_keep_order_and_equal_predict(predictor, tmp_path, monkeypatch):
    """Map-free requests go through ``predict_many`` in chunks (2 here);
    every record equals the serial ``predict`` of its request bit for bit,
    in stream order, with client seeds and integer pixels carried through."""
    monkeypatch.setattr(server, "JSONL_CHUNK", 2)
    paths = _write_images(tmp_path, 3, uint16=(2,))
    reqs = [
        {"image": paths[0], "seed": 3},
        {"image": paths[1], "seed": 4, "laterality": "R"},
        {"image": paths[2], "seed": 5, "pixel_max": 60000},
        {"image": paths[0], "seed": 6, "laterality": "R"},
        {"image": paths[1], "seed": 3},
    ]
    out = io.StringIO()
    assert serve_jsonl(predictor, io.StringIO(_jsonl(reqs)), out) == 5
    got = [json.loads(line) for line in out.getvalue().splitlines()]
    assert got == [_serial(predictor, r) for r in reqs]
    assert all("attention_mean_maps" not in g for g in got)
    assert {g["entropy_bucket"] for g in got} <= {"very low", "low", "moderate", "high"}


class _Running:
    """A server on an ephemeral port, serving in a thread until closed."""

    def __init__(self, pred, **kw):
        self.srv = make_server(pred, port=0, **kw)
        self.port = self.srv.server_address[1]
        self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)
        self.thread.start()

    def request(self, method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=120)
        try:
            data = None if body is None else (body if isinstance(body, bytes)
                                              else json.dumps(body).encode())
            conn.request(method, path, data, {"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def test_http_health_predict_errors_and_maps(predictor, tmp_path):
    run = _Running(predictor, maps_dir=str(tmp_path / "maps"))
    try:
        assert run.request("GET", "/healthz") == (200, {
            "status": "ok", "num_samples": 3, "quantized": False, "bucket": 8,
        })
        assert run.request("GET", "/nope")[0] == 404
        img = synthetic_image(128, 128, positive=True, seed=4)
        status, got = run.request("POST", "/predict", {"image": img.tolist(), "seed": 6})
        assert status == 200
        assert got == result_to_dict(predictor.predict(img, seed=6))

        status, got_m = run.request("POST", "/predict", {
            "image": img.tolist(), "seed": 6, "maps": True, "map_downsample": 3,
        })
        assert status == 200 and got_m["attention_mean_maps"].endswith(".npy")
        want = predictor.predict(img, seed=6, return_maps=True, map_downsample=3)
        np.testing.assert_array_equal(np.load(got_m["attention_mean_maps"]),
                                      want.attention_mean_maps)
        np.testing.assert_array_equal(np.load(got_m["attention_std_maps"]),
                                      want.attention_std_maps)
        assert want.attention_mean_maps.shape == (2, 43, 43)

        for body in (b'{"nope": 1}', b"not json", {"image": [1, 2, 3]},
                     {"image": img.tolist(), "seed": 1.5},
                     {"image": img.tolist(), "map_downsample": 0}):
            status, err = run.request("POST", "/predict", body)
            assert status == 400 and set(err) == {"error"}, body
        assert run.request("POST", "/other", {})[0] == 404
        assert run.request("GET", "/healthz")[0] == 200  # still up
    finally:
        run.close()


def test_http_image_path_confined_to_data_root(predictor, tmp_path):
    root = tmp_path / "root"
    root.mkdir()
    inside = root / "scan.npy"
    np.save(inside, synthetic_image(128, 128, positive=False, seed=8))
    outside = tmp_path / "outside.npy"
    np.save(outside, synthetic_image(128, 128, positive=True, seed=9))
    os.symlink(outside, root / "link.npy")
    run = _Running(predictor, data_root=str(root))
    try:
        status, got = run.request("POST", "/predict", {"image_path": str(inside), "seed": 2})
        assert status == 200
        assert got == result_to_dict(predictor.predict(np.load(inside), seed=2))
        for path in (str(root / ".." / "outside.npy"), str(outside), str(root / "link.npy"),
                     "/etc/hostname"):
            status, err = run.request("POST", "/predict", {"image_path": path})
            assert status == 400 and "outside the configured data root" in err["error"], path
        status, err = run.request("POST", "/predict", {"image_path": str(root / "none.npy")})
        assert status == 400  # inside the root but missing
    finally:
        run.close()
    run = _Running(predictor)  # no data root: image_path refused outright
    try:
        status, err = run.request("POST", "/predict", {"image_path": str(inside)})
        assert status == 400 and "disabled" in err["error"]
    finally:
        run.close()


def test_http_concurrent_clients_equal_serial_predict(predictor, tmp_path):
    """Eight client threads, two requests each by ``image_path``: every
    answer equals the serial ``predict`` for its image and seed, bit for
    bit (the predictor's gate, not a front-end lock, keeps requests apart)."""
    paths = _write_images(tmp_path, 2, uint16=(1,))
    run = _Running(predictor, data_root=str(tmp_path))
    results, errors = {}, []

    def client(ci):
        try:
            for r in range(2):
                seed = ci * 10 + r
                status, payload = run.request("POST", "/predict", {
                    "image_path": paths[seed % 2], "seed": seed,
                    "laterality": "LR"[ci % 2],
                })
                if status != 200:
                    errors.append(f"seed {seed}: {status} {payload}")
                results[seed] = payload
        except Exception as e:  # noqa: BLE001 — surfaced in the main thread
            errors.append(f"client {ci}: {type(e).__name__}: {e}")

    try:
        threads = [threading.Thread(target=client, args=(ci,)) for ci in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        run.close()
    assert not errors, errors
    assert len(results) == 16
    for seed, got in results.items():
        ci = seed // 10
        want = _serial(predictor, {"image": paths[seed % 2], "seed": seed,
                                   "laterality": "LR"[ci % 2]})
        assert got == want, seed


def test_build_predictor_restores_checkpoint(tmp_path):
    """``build_predictor(cfg, checkpoint)`` serves the weights
    ``Checkpointer.save_params`` saved, by name under ``cfg.model_path`` or
    by absolute path; without one, a fresh model seeded by ``cfg.seed``."""
    cfg = config_from_dict(_raw(model_path=str(tmp_path / "models")))
    weights = build_model(cfg, seed=5).state_dict()
    path = Checkpointer(cfg.model_path).save_params("served", weights)
    img = synthetic_image(128, 128, positive=False, seed=7)
    want = MCDOPredictor.from_config(cfg, weights, device="cpu").predict(img, seed=1)
    for ckpt in ("served", path):
        got = build_predictor(cfg, ckpt, device="cpu").predict(img, seed=1)
        assert result_to_dict(got) == result_to_dict(want)
    fresh = build_predictor(cfg, device="cpu").predict(img, seed=1)
    seeded = MCDOPredictor.from_config(
        cfg, build_model(cfg, seed=cfg.seed).state_dict(), device="cpu"
    ).predict(img, seed=1)
    assert result_to_dict(fresh) == result_to_dict(seeded) != result_to_dict(want)
    with pytest.raises(FileNotFoundError):
        build_predictor(cfg, "absent", device="cpu")


@pytest.mark.parametrize("req", [
    {"seed": "3"}, {"seed": True}, {"seed": 1.0}, {"pixel_max": "x"}, {"pixel_max": False},
    {"map_downsample": 2.0}, {"map_downsample": True}, {"map_downsample": 0},
])
def test_validate_request_rejects(req):
    with pytest.raises(ValueError):
        server._validate_request(req)
    server._validate_request({"seed": 4, "pixel_max": 4095, "map_downsample": 8})


def test_result_to_dict_inline_maps(predictor):
    r = predictor.predict(synthetic_image(128, 128, positive=True, seed=3), return_maps=True)
    d = result_to_dict(r)
    assert np.asarray(d["attention_mean_maps"]).shape == (2, 128, 128)
    np.testing.assert_array_equal(np.asarray(d["attention_std_maps"], np.float32),
                                  r.attention_std_maps)
    assert json.loads(json.dumps(d)) == d

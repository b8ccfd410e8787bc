"""Serving: raw mammogram in, uncertainty-aware prediction out.

Counterpart of ``montecarlo_gated_mil_tpu/serve.py::MCDOPredictor``: on-device
preprocessing (``data/pipeline.py``, tile gather kernel), one feature pass
(the f32 backbone, or with ``quantized=True`` the int8 embed of
``ops/quantized.py``),
T Monte Carlo head samples in one kernel launch, the uncertainty
reductions and, on request, the mean/std attention maps
(``viz/attention.py``) on the device, behind one warm predictor.

With a device mesh (``mesh=``, by default every visible CUDA device when
there are several) an oversized request shards its instances over the
mesh's devices (``parallel/instance.py``) and ``predict_many`` spreads its
requests over them (``parallel/dp.py``), as JAX's predictor does over its
devices.

    predictor = MCDOPredictor.from_config(cfg, state_dict)
    result = predictor.predict(image, laterality="R", seed=7, return_maps=True)
    result.prediction, result.stats.mean, result.attention_mean_maps
"""

from __future__ import annotations

import threading
import warnings
from dataclasses import dataclass, replace

import numpy as np
import torch

from montecarlo_gated_mil_tpu_torch.core.bag import BucketSpec
from montecarlo_gated_mil_tpu_torch.core.config import Config
from montecarlo_gated_mil_tpu_torch.data.pipeline import (
    ESTIMATE_MARGIN_HI,
    PipelineConfig,
    estimate_valid_tiles,
    image_to_bag,
)
from montecarlo_gated_mil_tpu_torch.mcdo.sampling import (
    AttentionStats,
    PredictiveStats,
    attention_stats,
    make_embed_fn,
    mc_head,
    predictive_stats,
)
from montecarlo_gated_mil_tpu_torch.ops.gated_attention import (
    GatedAttentionParams,
    kernel_on,
    use_pallas_from,
)
from montecarlo_gated_mil_tpu_torch.ops.patching import compute_tile_grid
from montecarlo_gated_mil_tpu_torch.parallel.mesh import (
    Mesh,
    instance_mesh,
    make_mesh,
    replicated,
    shard_mesh_for,
)
from montecarlo_gated_mil_tpu_torch.viz.attention import attention_map_stats


def _prepare_image(image, pixel_max: float | None) -> tuple[np.ndarray, float]:
    """(host array to ship, device-side 1/max scale).

    Integer arrays ship as they are (1-2 bytes/px) and are normalized on the
    device by ``pixel_max`` (default: the dtype's max; pass
    ``2**bits_stored - 1`` for raw DICOM pixels).  Float arrays are taken to
    be in [0, 1] unless ``pixel_max`` says otherwise.
    """
    arr = np.asarray(image)
    if arr.dtype.kind in "ui":
        mx = float(np.iinfo(arr.dtype).max) if pixel_max is None else float(pixel_max)
        return arr, float(np.float32(1.0 / mx))
    arr = np.asarray(arr, np.float32)
    return arr, float(np.float32(1.0 if pixel_max is None else 1.0 / float(pixel_max)))


@dataclass(frozen=True)
class PredictionResult:
    """One bag's uncertainty-aware prediction (tensors on the CPU)."""

    prediction: int  # argmax of MC-mean class probabilities
    stats: PredictiveStats
    attention: AttentionStats  # per instance, over T samples
    num_instances: int
    bucket: int
    attention_mean_maps: np.ndarray | None = None  # (C, H', W') if requested
    attention_std_maps: np.ndarray | None = None


def _host(x):
    """Dataclass of device tensors -> the same dataclass on the CPU."""
    return type(x)(**{k: v.cpu() for k, v in vars(x).items()})


class MCDOPredictor:
    """Warm end-to-end MCDO inference for one pipeline configuration.

    Thread-safe.  Host-side prep (pixel normalization, the subsampled bucket
    estimate) and the image upload run concurrently across caller threads;
    device execution goes through a bounded gate (``max_inflight``, default
    1), so at most that many requests run on the device at once, and at
    most ``2 * max_inflight`` hold an uploaded image there (running or
    queued for the gate).

    With a ``bucket_spec`` each request embeds at the smallest sufficient
    bucket; an oversized request (more valid tiles than the cap bucket)
    extends past the cap under ``oversized='extend'`` and keeps every tile.

    ``mesh``: the devices the predictor spreads over (default: every visible
    CUDA device when the predictor is on a card and there are several, else
    none).  With k devices an extended bucket is a multiple of k, an
    oversized request embeds and samples with its instances sharded over
    all k on the float embed (``parallel/instance.py``), and
    ``predict_many`` runs its requests k at a time, one per device.  The
    model must live on the mesh's first device.

    ``quantized=True`` embeds through the int8 PTQ path (static k-sigma
    scales, ``ops/quantized.py``); its plan is built once, here.

    ``use_pallas``: ``None`` (the default) and ``True`` run the head kernel
    (K1, K2 for a shared gate) on the card, ``False`` the plain head there
    (``ops/gated_attention.py::mc_head_reference``, full f32).  On the CPU
    all three run the plain head.  JAX's ``None`` turns its kernel on on a
    TPU only; the port's kernel runs on every card.  An oversized request's
    instance-sharded head is plain either way, as in JAX.
    """

    def __init__(
        self,
        model,
        pipeline: PipelineConfig,
        *,
        num_samples: int = 30,
        use_pallas: bool | None = None,
        quantized: bool = False,
        bucket_spec: BucketSpec | None = None,
        oversized: str = "extend",
        max_inflight: int = 1,
        device: str | torch.device = "cuda",
        mesh: Mesh | None = None,
    ):
        if oversized not in ("extend", "truncate"):
            raise ValueError(f"oversized must be 'extend' or 'truncate', got {oversized!r}")
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.pipeline = pipeline
        self.num_samples = num_samples
        self.use_pallas = use_pallas
        self._kernel = kernel_on(use_pallas)
        self.quantized = quantized
        self.bucket_spec = bucket_spec
        self.oversized = oversized
        self.truncated_requests = 0
        self._warned_truncation = False
        self._lock = threading.Lock()  # truncation counter, warm buckets
        self._execute_gate = threading.BoundedSemaphore(max_inflight)
        # Held from before a request's upload until its device tensors are
        # released: the requests in the gate plus as many queued for it, so
        # a burst of callers cannot stack their images on the device.
        self._upload_slots = threading.BoundedSemaphore(2 * max_inflight)
        # Buckets whose shapes have run once (cuDNN setup, kernel loading,
        # allocator growth), replaced whole under ``_lock``; read while a
        # background warmup runs (``warmup``).
        self._warm: frozenset[int] = frozenset()
        self._warming = False
        self._grid = pipeline.grid()
        self._starts_np = self._grid.tiles_array()[:, :2]
        self._starts = torch.as_tensor(self._starts_np, dtype=torch.int64, device=self.device)
        # Head weights in kernel layout, converted once.
        self._head_params = GatedAttentionParams.from_module(self.model).to(self.device)
        # The f32 backbone, or the int8 embed with its plan built once.
        self._embed = make_embed_fn(self.model, quantized)
        if mesh is None and self.device.type == "cuda":
            mesh = instance_mesh()
        self.mesh = mesh
        # Built at first use: the model on each of the mesh's devices, shared
        # by the instance-sharded route and predict_many's data-parallel step.
        self._replicas = None
        self._dp_eval = None

    @classmethod
    def from_config(
        cls,
        cfg: Config,
        weights,
        *,
        train_overlap: bool = False,
        **kw,
    ) -> "MCDOPredictor":
        """Predictor for ``cfg`` with ``weights``, a state_dict in the
        port's (reference) schema, e.g. from ``weights.from_jax_params``."""
        from montecarlo_gated_mil_tpu_torch.experiment import build_model

        d = cfg.data
        overlap = d.overlap_train if train_overlap else d.overlap_val_test
        grid = compute_tile_grid(d.H, d.W, d.patch_size, overlap)
        pipeline = PipelineConfig(
            height=d.H,
            width=d.W,
            patch_size=d.patch_size,
            overlap=overlap,
            empty_threshold=d.empty_threshold,
            bag_size=d.bag_size_val_test,
            bucket=BucketSpec(cfg.tpu.buckets).bucket_for(grid.num_tiles),
            augment=False,
            dtype=cfg.tpu.compute_dtype,
        )
        kw.setdefault("num_samples", cfg.N)
        kw["use_pallas"] = use_pallas_from(cfg, kw.get("use_pallas"))
        kw.setdefault("quantized", cfg.tpu.quantized_inference)
        kw.setdefault("oversized", cfg.tpu.oversized_bags)
        if len(cfg.tpu.buckets) > 1:
            kw.setdefault("bucket_spec", BucketSpec(cfg.tpu.buckets))
        model = build_model(cfg)
        model.load_state_dict({k: torch.as_tensor(v) for k, v in weights.items()})
        return cls(model, pipeline, **kw)

    def _pick_bucket(self, arr: np.ndarray, laterality: str) -> int:
        """Smallest sufficient bucket for a request, from the host-side
        subsampled fill estimate (no device work).  When the decision flips
        inside the estimator's uncertainty band the request takes the larger
        bucket: rounding up costs padding, never tiles."""
        cap = self.pipeline.bucket
        may_overflow = self._grid.num_tiles > cap and (
            self.pipeline.bag_size <= 0 or self.pipeline.bag_size > cap
        )
        if self.bucket_spec is None and not may_overflow:
            return cap
        est = estimate_valid_tiles(
            arr, laterality == "R", self._starts_np, self.pipeline,
            margin_hi=ESTIMATE_MARGIN_HI,
        )
        if est is None:
            return cap
        n, n_hi = est
        bucket_lo, over_lo = self._decide_bucket(n, may_overflow)
        bucket_hi, _ = self._decide_bucket(n_hi, may_overflow)
        if over_lo and self.oversized != "extend":
            with self._lock:
                self.truncated_requests += 1
                warn_now = not self._warned_truncation
                self._warned_truncation = True
            if warn_now:
                warnings.warn(
                    f"request with ~{n} valid tiles truncated to bucket {cap} "
                    "(lowest-fill tiles dropped; oversized='truncate'); use "
                    "oversized='extend' to keep every tile",
                    stacklevel=3,
                )
        return max(bucket_lo, bucket_hi)

    def _mesh_size(self) -> int:
        return self._mesh().size

    def _decide_bucket(self, n: int, may_overflow: bool) -> tuple[int, bool]:
        """Map a valid-tile count to ``(bucket, overflowed)``.  An extended
        bucket is a multiple of the cap bucket and of the mesh's device
        count, so an oversized bag divides over the devices."""
        cap = self.pipeline.bucket
        if may_overflow and n > cap:
            if self.oversized == "extend":
                spec = self.bucket_spec or BucketSpec((cap,))
                return spec.extended_bucket(n, multiple_of=self._mesh_size()), True
            return cap, True
        if self.bucket_spec is None:
            return cap, False
        return min(self.bucket_spec.bucket_for(n), cap), False

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device, non_blocking=True)

    def _bag(self, image: torch.Tensor, flip: bool, inv_max: float, bucket: int):
        image = image.to(torch.float32) * inv_max
        return image_to_bag(
            image, flip, 0, self._starts, replace(self.pipeline, bucket=bucket),
            device=self.device,
        )

    def _mesh(self) -> Mesh:
        return self.mesh or make_mesh(devices=[self.device])

    def _mesh_replicas(self) -> list:
        """The model on each of the mesh's devices, in order, copied once."""
        with self._lock:
            if self._replicas is None:
                self._replicas = replicated(self._mesh().flat("inst"), self.model, "inst")
            return self._replicas

    def _infer(self, image: torch.Tensor, flip: bool, seed: int, inv_max: float, bucket: int):
        """The request on the device: bag, features, T head samples, stats.
        An oversized bucket runs instance-sharded where the mesh allows."""
        bag = self._bag(image, flip, inv_max, bucket)
        shard_mesh = shard_mesh_for(bucket, self.pipeline.bucket, self._mesh())
        if shard_mesh is not None:
            from montecarlo_gated_mil_tpu_torch.parallel.instance import mc_inference_sharded

            y, a = mc_inference_sharded(self.model, bag.patches, bag.mask, self.num_samples,
                                        seed, shard_mesh, params=self._head_params,
                                        replicas=self._mesh_replicas())
            y, a = y.to(self.device), a.to(self.device)
        else:
            H = self._embed(bag.patches, bag.mask)
            out = mc_head(self.model, H, bag.mask, self.num_samples, seed, self._head_params,
                          kernel=self._kernel)
            y, a = out.predictions, out.attention
        return bag, y, a, predictive_stats(y), attention_stats(a, bag.mask)

    def _mark_warm(self, bucket: int) -> None:
        with self._lock:
            self._warm = self._warm | {bucket}

    def _route(self, bucket: int) -> int:
        """While a background warmup runs, a bucket that is not warm yet
        gives way to the smallest warm bucket that holds it: the same
        result with more padding, without this request paying the cold
        start of its own bucket."""
        if not self._warming or bucket in self._warm:
            return bucket
        warm = sorted(b for b in self._warm if b >= bucket)
        return warm[0] if warm else bucket

    def warmup(self, dtypes=(np.float32, np.uint16), *, background: bool = False):
        """Run one dummy request per registry bucket and input dtype, so the
        first real request pays no kernel build, cuDNN setup or allocator
        growth.

        ``background=True`` warms the cap bucket for the first dtype before
        it returns (any request can run there, with more padding) and the
        rest in a daemon thread, which it returns; meanwhile a request whose
        bucket is not warm yet runs at the smallest warm bucket that holds
        it.  A failure in that thread is reported by ``threading``'s hook
        and leaves the remaining buckets cold.
        """
        hw = (self.pipeline.height, self.pipeline.width)
        buckets = [self.pipeline.bucket]
        if self.bucket_spec is not None:
            buckets += [b for b in self.bucket_spec.sizes if b <= self.pipeline.bucket]
        combos = [(d, b) for d in dtypes for b in dict.fromkeys(buckets)]

        def warm(dtype, bucket):
            zero, inv_max = _prepare_image(np.zeros(hw, dtype), None)
            with self._upload_slots:
                self._run(zero, False, 0, inv_max, bucket, None)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._mark_warm(bucket)

        if not background:
            for d, b in combos:
                warm(d, b)
            return None
        warm(*combos[0])
        self._warming = True

        def rest():
            try:
                for d, b in combos[1:]:
                    warm(d, b)
            finally:
                self._warming = False

        thread = threading.Thread(target=rest, daemon=True, name="mcdo-warmup")
        thread.start()
        return thread

    def predict(
        self,
        image: np.ndarray,
        laterality: str = "L",
        *,
        seed: int = 0,
        return_maps: bool = False,
        map_downsample: int = 1,
        pixel_max: float | None = None,
    ) -> PredictionResult:
        """Classify one grayscale mammogram.

        ``image`` is float in [0, 1], or raw integer pixels (uint8/uint16)
        normalized on the device by ``pixel_max`` (default: the dtype's max),
        which halves the upload.  ``return_maps`` adds the per-class mean and
        std attention maps over T (``viz.attention.attention_map_stats``,
        computed on the device); ``map_downsample=k`` returns their exact
        k-fold box mean instead of full resolution (2 x 79 MB f32 at the
        shipped 7036x2800; k=8 is 1/64 of that).
        """
        if map_downsample < 1:
            raise ValueError(f"map_downsample must be >= 1, got {map_downsample}")
        arr, inv_max = _prepare_image(image, pixel_max)
        bucket = self._route(self._pick_bucket(arr, laterality))
        with self._upload_slots:
            result = self._run(arr, laterality == "R", seed, inv_max, bucket,
                               map_downsample if return_maps else None)
        self._mark_warm(bucket)
        return result

    def _run(self, arr, flip: bool, seed: int, inv_max: float, bucket: int,
             map_downsample: int | None) -> PredictionResult:
        """Upload, then the request on the device behind the execute gate.
        Returns host results only, so the request's device tensors are
        released when it returns (the caller holds an upload slot until
        then)."""
        dev = self._upload(arr)
        with self._execute_gate, torch.inference_mode():
            bag, _, a, stats, att = self._infer(dev, flip, seed, inv_max, bucket)
            maps = (None, None)
            if map_downsample is not None:
                maps = tuple(
                    m.cpu().numpy() for m in attention_map_stats(
                        a, bag.tile_indices, bag.mask, self._grid, downsample=map_downsample,
                    )
                )
            n_inst = int(bag.num_instances)
            stats, att = _host(stats), _host(att)
        return PredictionResult(
            prediction=int(stats.prediction),
            stats=stats,
            attention=att,
            num_instances=n_inst,
            bucket=bucket,
            attention_mean_maps=maps[0],
            attention_std_maps=maps[1],
        )

    def predict_many(
        self,
        images,
        lateralities=None,
        *,
        seed: int = 0,
        seeds: list[int] | None = None,
        pixel_maxes: list[float | None] | None = None,
        dp: bool | None = None,
    ) -> list[PredictionResult]:
        """Batch prediction; request i is seeded ``seed + i`` unless
        ``seeds`` gives each its own.

        With ``dp`` (default: when the predictor has a mesh of several
        devices and there is more than one request) the requests run data-
        parallel over the mesh's devices: each request's bag is built at
        the bucket ``predict`` would give it, bags of one bucket group into
        batches of the device count (``parallel/dp.py::BucketBatcher``),
        and bag ``b`` of a batch runs on device ``b`` with its own seed, so
        each result equals ``predict``'s.  An oversized request leaves the
        batch for ``predict``'s own route (instance-sharded or whole).
        Without ``dp``, one ``predict`` after another."""
        lateralities = lateralities or ["L"] * len(images)
        if seeds is None:
            seeds = [seed + i for i in range(len(images))]
        if len(seeds) != len(images):
            raise ValueError(f"{len(seeds)} seeds for {len(images)} images")
        pixel_maxes = pixel_maxes or [None] * len(images)
        if len(pixel_maxes) != len(images):
            raise ValueError(f"{len(pixel_maxes)} pixel_maxes for {len(images)} images")
        if dp is None:
            dp = self._mesh_size() > 1 and len(images) > 1
        if not dp:
            return [
                self.predict(img, lat, seed=s, pixel_max=pm)
                for img, lat, s, pm in zip(images, lateralities, seeds, pixel_maxes)
            ]
        return self._predict_many_dp(images, lateralities, seeds, pixel_maxes)

    def _predict_many_dp(self, images, lateralities, seeds, pixel_maxes):
        from montecarlo_gated_mil_tpu_torch.parallel.dp import (
            BucketBatcher,
            make_dp_mc_eval,
            pad_group_to_batch,
        )

        mesh = self._mesh().flat("data")
        replicas = self._mesh_replicas()
        with self._lock:
            if self._dp_eval is None:
                self._dp_eval = make_dp_mc_eval(self.model, mesh, self.num_samples,
                                                self.quantized, replicas=replicas,
                                                kernel=self._kernel)
        results: list[PredictionResult | None] = [None] * len(images)

        def flush(group):
            with self._execute_gate, torch.inference_mode():
                shards, group_seeds, _ = pad_group_to_batch(
                    mesh, [b for b, _ in group], [seeds[j] for _, j in group])
                ys, atts = self._dp_eval(shards, group_seeds)
                for b, (bag, j) in enumerate(group):
                    stats = _host(predictive_stats(ys[b]))
                    att = _host(attention_stats(atts[b], bag.mask.to(atts.device)))
                    results[j] = PredictionResult(
                        prediction=int(stats.prediction), stats=stats, attention=att,
                        num_instances=int(bag.num_instances), bucket=bag.bucket,
                    )

        batcher = BucketBatcher(mesh.shape["data"])
        for j, (img, lat, pm) in enumerate(zip(images, lateralities, pixel_maxes)):
            arr, inv_max = _prepare_image(img, pm)
            bucket = self._route(self._pick_bucket(arr, lat))
            if bucket > self.pipeline.bucket:
                with self._upload_slots:
                    results[j] = self._run(arr, lat == "R", seeds[j], inv_max, bucket, None)
                self._mark_warm(bucket)
                continue
            with self._execute_gate, torch.inference_mode():
                bag = self._bag(self._upload(arr), lat == "R", inv_max, bucket)
            for group in batcher.add(bag, j):
                flush(group)
        for group in batcher.drain():
            flush(group)
        return results

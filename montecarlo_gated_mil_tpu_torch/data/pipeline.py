"""Image -> Bag preprocessing, on the device, and the bag loader.

Counterpart of ``montecarlo_gated_mil_tpu/data/pipeline.py``: mirror
right-laterality images to left, translate by -20 px in x, resize to the
configured H x W, score every candidate tile through a summed-area table,
select the filled tiles into a bucket, gather only those, flip them at
random for training, and normalize with the ImageNet statistics.
Everything after the raw pixel upload runs on the device the image lives
on.  :class:`BagLoader` feeds training and evaluation.
"""

from __future__ import annotations

import math
import queue
import threading
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, replace
from typing import Callable, Iterator, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from montecarlo_gated_mil_tpu_torch.core import rng
from montecarlo_gated_mil_tpu_torch.core.bag import Bag, BucketSpec
from montecarlo_gated_mil_tpu_torch.data.records import BagRecord, PixelData
from montecarlo_gated_mil_tpu_torch.data.splits import weighted_sample_order
from montecarlo_gated_mil_tpu_torch.ops.patching import (
    TileGrid,
    compute_tile_grid,
    gather_selected,
    sat_block_size,
    select_tiles,
    tile_fill_scores_sat,
)

# ImageNet statistics (reference transforms, utils.py:48).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BORDER_TRANSLATE_PX = 20  # reference dataset.py:66

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype for a config dtype name."""
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; expected one of {sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclass(frozen=True)
class PipelineConfig:
    """Static preprocessing parameters."""

    height: int
    width: int
    patch_size: int = 224
    overlap: float = 0.5
    empty_threshold: float = 0.75
    bag_size: int = -1
    bucket: int = 256
    augment: bool = False  # train-time random per-patch H/V flips
    dtype: str = "float32"  # dtype of the emitted patches

    def grid(self) -> TileGrid:
        return compute_tile_grid(self.height, self.width, self.patch_size, self.overlap)


def _resize_taps(n_in: int, n_out: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Input taps ``(n_out, K)`` and their weights for one axis of
    ``jax.image.resize(..., "bilinear", antialias=True)``.

    The float32 arithmetic of ``jax._src.image.scale.compute_weight_mat`` as
    XLA compiles it: a triangle kernel at sample ``(j + 0.5) / scale - 0.5``
    (rounded once, as the fused multiply-add computes it: at row 500 of a
    mammogram the unfused form moves the sample by half an ulp, 3e-5 of a
    weight), widened by ``1 / scale`` when downsampling, normalized per
    output pixel, zero where the sample leaves the input.  Only the
    ``K = ceil(2 * width) + 2`` taps around each sample are kept (the rest of
    a dense row is zero), so a 7036-row axis needs no 7036 x 7036 matrix.
    """
    f32 = torch.float32
    inv_scale = torch.tensor(1.0 / (n_out / n_in), dtype=f32, device=device)
    width = torch.clamp(inv_scale, min=1.0)
    centers = torch.arange(n_out, dtype=f32, device=device) + 0.5
    sample = (centers.double() * inv_scale.double() - 0.5).to(f32)
    K = math.ceil(2 * float(width)) + 2
    first = torch.floor(sample - width).to(torch.int64) + 1
    taps = first[:, None] + torch.arange(K, device=device)
    inside = (taps >= 0) & (taps < n_in)
    w = torch.clamp(1.0 - (sample[:, None] - taps.to(f32)).abs() * (1.0 / width), min=0.0)
    w = torch.where(inside, w, torch.zeros((), dtype=f32, device=device))
    total = w.sum(1, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0), 0.0)
    w = torch.where(((sample >= -0.5) & (sample <= n_in - 0.5))[:, None], w, 0.0)
    return taps.clamp(0, n_in - 1), w


def resize_bilinear_antialias(image: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """``(H, W)`` float32 -> ``out_hw`` as ``jax.image.resize(bilinear,
    antialias=True)``: separable, each axis whose size changes is resampled
    by a gather over its few taps, one tap at a time."""
    img = image
    for axis, n_out in enumerate(out_hw):
        n_in = img.shape[axis]
        if n_in == n_out:
            continue
        taps, w = _resize_taps(n_in, n_out, img.device)
        out = None
        for k in range(taps.shape[1]):
            if axis == 0:
                term = img[taps[:, k]] * w[:, k, None]
            else:
                term = img[:, taps[:, k]] * w[None, :, k]
            out = term if out is None else out + term
        img = out
    return img


def canonicalize_image(
    image: torch.Tensor, flip_horizontal: bool, out_hw: tuple[int, int]
) -> torch.Tensor:
    """Laterality mirror + border translate + resize.

    ``image``: ``(H, W)`` grayscale in [0, 1].  The -20 px x-translate moves
    content left and zero-fills the right edge.  Resizing to the same size
    is the identity, which is the main path; an off-size image goes through
    :func:`resize_bilinear_antialias`, the weights of ``jax.image.resize``.
    """
    img = torch.flip(image, dims=(1,)) if flip_horizontal else image
    img = F.pad(img[:, BORDER_TRANSLATE_PX:], (0, BORDER_TRANSLATE_PX))
    if tuple(img.shape) != tuple(out_hw):
        img = resize_bilinear_antialias(img, tuple(out_hw))
    return img


def stack_multimodal(img_cc, img_mlo) -> np.ndarray:
    """Vertical MLO-over-CC composite of two host images (reference
    ``dataset.py:101``)."""
    return np.concatenate([np.asarray(img_mlo), np.asarray(img_cc)], axis=0)


def draw_flips(bucket: int, generator: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-patch horizontal and vertical flip masks, each with p = 0.5."""
    u = torch.rand((2, bucket), generator=generator)
    return u[0] < 0.5, u[1] < 0.5


def flip_patches(
    patches: torch.Tensor, flip_h: torch.Tensor, flip_v: torch.Tensor
) -> torch.Tensor:
    """``(K, p, p, ...)`` patches mirrored in x where ``flip_h`` and in y
    where ``flip_v`` (``(K,)`` bool each), as the JAX pipeline's augment."""
    fh = flip_h.to(patches.device)[:, None, None, None]
    fv = flip_v.to(patches.device)[:, None, None, None]
    patches = torch.where(fh, patches.flip(2), patches)
    return torch.where(fv, patches.flip(1), patches)


def image_to_bag(
    image,
    flip_horizontal: bool,
    label: int,
    starts: torch.Tensor,
    cfg: PipelineConfig,
    *,
    device: str | torch.device = "cuda",
    flips: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> Bag:
    """Grayscale image -> normalized, padded :class:`Bag` on ``device``.

    Fill scores are computed on raw pixels, before normalization, as in the
    reference.  With ``cfg.augment`` the selected patches are flipped by
    ``flips = (flip_h, flip_v)`` (``(bucket,)`` bool each, see
    :func:`draw_flips`) before normalization.
    """
    if cfg.augment and flips is None:
        raise ValueError("cfg.augment needs flips=(flip_h, flip_v); draw them with draw_flips")
    device = torch.device(device)
    img = torch.as_tensor(image, device=device).to(torch.float32)
    starts = torch.as_tensor(starts, device=device).to(torch.int64)
    img = canonicalize_image(img, flip_horizontal, (cfg.height, cfg.width))
    grid = cfg.grid()
    scores = tile_fill_scores_sat(img, starts, cfg.patch_size, block=sat_block_size(grid))
    idx, mask = select_tiles(scores, cfg.bucket, cfg.empty_threshold, cfg.bag_size)
    patches = gather_selected(img, starts[idx], cfg.patch_size)[..., None]
    if cfg.augment:
        patches = flip_patches(patches, *flips)
    mean = torch.tensor(IMAGENET_MEAN, dtype=patches.dtype, device=device)
    std = torch.tensor(IMAGENET_STD, dtype=patches.dtype, device=device)
    patches = (patches - mean) / std  # (bucket, p, p, 1) -> (bucket, p, p, 3)
    patches = torch.where(mask[:, None, None, None], patches, torch.zeros((), device=device))
    patches = patches.to(torch_dtype(cfg.dtype))
    return Bag(
        patches=patches,
        mask=mask,
        label=torch.tensor(label, dtype=torch.int64, device=device),
        tile_indices=torch.where(mask, idx, torch.zeros_like(idx)),
    )


def count_valid_tiles(
    image, flip_horizontal: bool, starts: torch.Tensor, cfg: PipelineConfig,
    *, device: str | torch.device = "cuda",
) -> int:
    """Number of tiles a bag would keep (fill > threshold, capped at
    ``bag_size``)."""
    img = torch.as_tensor(image, device=device).to(torch.float32)
    img = canonicalize_image(img, flip_horizontal, (cfg.height, cfg.width))
    starts = torch.as_tensor(starts, device=img.device).to(torch.int64)
    scores = tile_fill_scores_sat(img, starts, cfg.patch_size, block=sat_block_size(cfg.grid()))
    n = int((scores > torch.tensor(cfg.empty_threshold * 100.0, device=img.device)).sum())
    return min(n, cfg.bag_size) if cfg.bag_size > 0 else n


# Generous second margin for the estimator's uncertainty band: a bucket
# decision that flips between ``margin`` and ``margin_hi`` is borderline, and
# serving then takes the larger bucket (padding-only cost).
ESTIMATE_MARGIN_HI = 0.10


def estimate_valid_tiles(
    image: np.ndarray,
    flip: bool,
    starts: np.ndarray,
    cfg: PipelineConfig,
    *,
    subsample: int = 4,
    margin: float = 0.03,
    margin_hi: float | None = None,
) -> int | tuple[int, int] | None:
    """Host-side conservative estimate of :func:`count_valid_tiles` from a
    stride-``subsample`` pixel subsample, so the request path picks its
    bucket without a device readback.  Counts tiles whose estimated fill
    exceeds ``empty_threshold - margin``; with ``margin_hi`` also returns the
    generous-margin count as ``(n, n_hi)``.  Returns None when the image is
    off-size (the resize path, where the subsampled geometry does not map).
    Same numpy arithmetic as the JAX package's estimator, so both pick
    identical buckets.
    """
    arr = np.asarray(image)
    if arr.shape != (cfg.height, cfg.width):
        return None
    d = subsample
    while cfg.patch_size % d:
        d -= 1
    # canonical pixel (y, x) is view[y, x] with the right edge zero-filled
    view = arr[:, ::-1] if flip else arr
    view = view[:, BORDER_TRANSLATE_PX:]
    nz = view[::d, ::d] != 0
    sat = np.zeros((nz.shape[0] + 1, nz.shape[1] + 1), np.int32)
    sat[1:, 1:] = nz.cumsum(0, dtype=np.int32).cumsum(1)
    pb = cfg.patch_size // d
    starts = np.asarray(starts)
    y0 = np.minimum(np.round(starts[:, 0] / d).astype(np.int64), nz.shape[0])
    x0 = np.minimum(np.round(starts[:, 1] / d).astype(np.int64), nz.shape[1])
    y1 = np.minimum(y0 + pb, nz.shape[0])
    x1 = np.minimum(x0 + pb, nz.shape[1])
    counts = sat[y1, x1] - sat[y0, x1] - sat[y1, x0] + sat[y0, x0]
    fill = counts / float(pb * pb)
    n = int(np.sum(fill > max(cfg.empty_threshold - margin, 0.0)))
    if cfg.bag_size > 0:
        n = min(n, cfg.bag_size)
    if margin_hi is None:
        return n
    n_hi = int(np.sum(fill > max(cfg.empty_threshold - margin_hi, 0.0)))
    if cfg.bag_size > 0:
        n_hi = min(n_hi, cfg.bag_size)
    return n, n_hi


class BagLoader:
    """Host loop: read raw pixels, build each bag on the device, prefetch.

    Counterpart of the JAX package's ``BagLoader`` for one device: a
    background thread reads each record (``reader(record)`` gives a
    grayscale float image in [0, 1], or a ``(CC, MLO)`` pair when
    ``multimodal``), uploads it and runs :func:`image_to_bag`, keeping at
    most ``prefetch`` bags ahead of the consumer.  Bags come out in the
    epoch order, which is the JAX loader's: a fixed ``sample_order`` of
    record indices every epoch (``len`` follows it; indices may repeat),
    else a weighted draw with replacement (``sample_weights``; passing both
    raises), else record order, shuffled by ``np.random.default_rng(seed +
    epoch)`` with ``shuffle``.

    With ``bucket_spec`` each bag takes the smallest registry bucket its
    valid-tile count fits, picked from the host-side estimate (exact device
    count when the image is off-size or the decision falls inside the
    estimator's uncertainty band).  A bag with more valid tiles than
    ``cfg.bucket`` extends past it under ``oversized='extend'`` (every tile
    kept) or is cut to it under ``'truncate'`` (counted and warned once).
    Augmentation flips come from ``core/rng.generator(seed, "augment",
    epoch, index)``.

    A reader may return :class:`PixelData`: the header's ImageLaterality
    then supersedes the record's and its ``patient_id`` and ``age`` fill
    the yielded record (reference ``dataset.py:51-64``).  ``io_workers > 1``
    runs the raw reads (file IO and DICOM decode, C code that releases the
    GIL) in a pool of that many threads with exactly ``io_workers`` reads
    in flight, the counterpart of the reference's DataLoader
    ``num_workers``; uploads and bag building stay on the one producer
    thread, in record order, so the bags are the same for any
    ``io_workers``.
    """

    def __init__(
        self,
        records: Sequence[BagRecord],
        reader: Callable,
        cfg: PipelineConfig,
        *,
        multimodal: bool = False,
        seed: int = 0,
        shuffle: bool = False,
        sample_order: np.ndarray | None = None,
        sample_weights: Sequence[float] | None = None,
        prefetch: int = 2,
        io_workers: int = 1,
        bucket_spec: BucketSpec | None = None,
        oversized: str = "extend",
        device: str | torch.device = "cuda",
    ):
        if sample_order is not None and sample_weights is not None:
            raise ValueError("pass sample_order or sample_weights, not both")
        if io_workers < 1:
            raise ValueError(f"io_workers must be >= 1, got {io_workers}")
        if oversized not in ("extend", "truncate"):
            raise ValueError(f"oversized must be 'extend' or 'truncate', got {oversized!r}")
        self.records = list(records)
        self.reader = reader
        self.cfg = cfg
        self.multimodal = multimodal
        self.seed = seed
        self.shuffle = shuffle
        self.sample_order = sample_order
        self.sample_weights = sample_weights
        self.prefetch = prefetch
        self.io_workers = io_workers
        self.bucket_spec = bucket_spec
        self.oversized = oversized
        self.device = torch.device(device)
        self.truncated_bags = 0  # bags that lost tiles under 'truncate'
        self._warned_truncation = False
        self._starts_np = cfg.grid().tiles_array()[:, :2]
        self._starts = torch.as_tensor(self._starts_np, dtype=torch.int64, device=self.device)
        self._num_candidates = cfg.grid().num_tiles

    def __len__(self) -> int:
        if self.sample_order is not None:
            return len(self.sample_order)
        return len(self.records)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        if self.sample_order is not None:
            return np.asarray(self.sample_order)
        if self.sample_weights is not None:
            return weighted_sample_order(self.sample_weights, len(self.records), self.seed + epoch)
        order = np.arange(len(self.records))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        return order

    def _make_bag(self, i: int, epoch: int, raw=None) -> tuple[Bag, BagRecord]:
        rec = self.records[i]
        if raw is None:
            raw = self.reader(rec)
        if isinstance(raw, PixelData):
            meta = raw.meta
            if meta is not None:
                rec = replace(
                    rec,
                    laterality=getattr(meta, "laterality", "") or rec.laterality,
                    patient_id=getattr(meta, "patient_id", "") or rec.patient_id,
                    age=meta.age if getattr(meta, "age", -1) >= 0 else rec.age,
                )
            raw = raw.images if len(raw.images) > 1 else raw.images[0]
        if self.multimodal:
            image = stack_multimodal(*raw)
        else:
            image = np.asarray(raw)
        image = np.ascontiguousarray(image, dtype=np.float32)
        flip = rec.laterality == "R"
        img = torch.from_numpy(image).to(self.device)
        cfg = replace(self.cfg, bucket=self._pick_bucket(image, flip, img))
        flips = None
        if cfg.augment:
            flips = draw_flips(cfg.bucket, rng.generator(self.seed, "augment", epoch, i))
        bag = image_to_bag(img, flip, rec.label, self._starts, cfg, device=self.device, flips=flips)
        return bag, rec

    def _pick_bucket(self, image: np.ndarray, flip: bool, img: torch.Tensor) -> int:
        """Per-bag bucket from the host-side valid-tile estimate; the exact
        device count where the estimate cannot decide."""
        cfg = self.cfg
        may_overflow = self._num_candidates > cfg.bucket and (
            cfg.bag_size <= 0 or cfg.bag_size > cfg.bucket
        )
        if self.bucket_spec is None and not may_overflow:
            return cfg.bucket
        est = estimate_valid_tiles(
            image, flip, self._starts_np, cfg, margin_hi=ESTIMATE_MARGIN_HI
        )
        if est is None or self._decide(est[0], may_overflow) != self._decide(est[1], may_overflow):
            n = count_valid_tiles(img, flip, self._starts, cfg, device=self.device)
        else:
            n = est[0]
        bucket, overflowed = self._decide(n, may_overflow)
        if overflowed and self.oversized != "extend":
            self.truncated_bags += 1
            if not self._warned_truncation:
                self._warned_truncation = True
                warnings.warn(
                    f"bag with ~{n} valid tiles truncated to bucket {cfg.bucket} "
                    "(lowest-fill tiles dropped; oversized='truncate'); set "
                    "oversized='extend' to keep every tile",
                    stacklevel=3,
                )
        return bucket

    def _decide(self, n: int, may_overflow: bool) -> tuple[int, bool]:
        """``(bucket, overflowed)`` for a valid-tile count.  On one device an
        extended bucket is a multiple of the cap bucket alone."""
        cfg = self.cfg
        if may_overflow and n > cfg.bucket:
            if self.oversized == "extend":
                spec = self.bucket_spec or BucketSpec((cfg.bucket,))
                return spec.extended_bucket(n), True
            return cfg.bucket, True
        if self.bucket_spec is not None:
            return min(self.bucket_spec.bucket_for(n), cfg.bucket), False
        return cfg.bucket, False

    def _reads(self, order: np.ndarray, cancel: threading.Event) -> Iterator[tuple[int, object]]:
        """``(index, raw pixels)`` in ``order``: read here, or with
        ``io_workers > 1`` by a thread pool holding exactly ``io_workers``
        reads in flight (each a whole decoded image, so the window bounds
        the host memory)."""
        if self.io_workers == 1:
            for i in order:
                yield int(i), self.reader(self.records[int(i)])
            return
        with ThreadPoolExecutor(self.io_workers) as pool:
            pending: deque = deque()
            it = iter(order)

            def submit_next() -> None:
                i = next(it, None)
                if i is not None and not cancel.is_set():
                    pending.append((int(i), pool.submit(self.reader, self.records[int(i)])))

            for _ in range(self.io_workers):
                submit_next()
            while pending:
                i, fut = pending.popleft()
                raw = fut.result()
                submit_next()
                yield i, raw

    def epoch(self, epoch: int = 0) -> Iterator[tuple[Bag, BagRecord]]:
        """Yield ``(Bag, record)`` in the epoch's order, built one ahead by
        a producer thread.  A producer error is raised here; leaving the
        loop early stops the producer."""
        order = self._epoch_order(epoch)
        q: queue.Queue = queue.Queue(maxsize=max(1, self.prefetch))
        done = object()
        cancel = threading.Event()

        def put(item) -> bool:
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            reads = self._reads(order, cancel)
            try:
                for i, raw in reads:
                    if not put(self._make_bag(i, epoch, raw)):
                        return
            except Exception as e:  # handed to the consumer, which raises it
                put(e)
                return
            finally:
                reads.close()
            put(done)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            cancel.set()
            t.join()

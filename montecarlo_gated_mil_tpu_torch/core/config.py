"""Typed configuration schema (the port's own copy).

Same dataclasses, defaults and validation as
``montecarlo_gated_mil_tpu/core/config.py``, so one YAML file configures
both packages.  The ``tpu:`` section keeps its name for that reason.  The
port's predictor reads ``buckets``, ``compute_dtype``, ``oversized_bags``,
``quantized_inference`` (the int8 embed of ``ops/quantized.py``) and
``use_pallas_attention`` (``false``: the plain head on the card, not its
kernels, in serving, ``cli bench``, the training step, MC validation and the
MC test, ``ops/gated_attention.py::use_pallas_from``); training reads
``buckets``, ``adaptive_buckets``, ``compute_dtype``, ``oversized_bags``,
``checkpoint_every``,
``debug_nans`` / ``debug_infs`` (a NaN / Inf check of every step's loss and
gradients, ``train/state.py::make_train_step``), ``data_parallel_train``
(data-parallel training over several cards with one process,
``train/loops.py::train_epoch_dp``) and ``async_checkpointing`` (epoch
checkpoints written on a background thread, ``train/state.py::
Checkpointer``); the CLI reads ``coordinator_address``, ``num_processes``
and ``process_id`` (a multi-process run's ``gloo`` group, over which ``cv``
fans its folds out, ``parallel/distributed.py::initialize``; -1 takes
``WORLD_SIZE`` / ``RANK`` from a launcher where JAX detects them).  The
other knobs are parsed and validated only.  ``use_pallas_train`` in particular has
no effect in the port: on the card a training step's head runs the forward
kernel and its backward kernel (K1/K5, or K2/K4 for a shared gate) unless
``use_pallas_attention`` is ``false``, and on the CPU their plain version;
both compute the same function on the same Philox bits, so there is nothing
more to choose.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import yaml

_BACKBONES = ("r18", "r34", "r50")
_CRITERIA = ("ce", "bce")
_OPTIMIZERS = ("adam", "sgd")


@dataclass(frozen=True)
class DataConfig:
    """Schema of the ``data:`` block (``reference config.yml:16-37``)."""

    fraction_train_rest: float = 0.75
    fraction_val_test: float = 0.5
    root_path: str = ""
    metadata_path: str = ""
    view: tuple[str, ...] = ("CC", "MLO")
    size: tuple[int, int] = (7036, 2800)
    H: int = 7036
    W: int = 2800
    multimodal: bool = True
    # Parsed for YAML compatibility but deliberately unread, exactly like
    # the reference: config.yml:27 carries it, yet no reference code ever
    # reads config['class_names'] — reports hardcode Negative/Positive
    # (net_utils.py:180,218) and figures hardcode "Cancer" (infer.py).
    class_names: tuple[str, ...] = ("No cancer", "Cancer")
    patch_size: int = 224
    bag_size_train: int = -1
    empty_threshold: float = 0.75
    bag_size_val_test: int = -1
    overlap_train: float = 0.5
    overlap_val_test: float = 0.75
    cv_folds: int = 5
    fraction_test: float = 0.15
    # > 0: use the synthetic mammogram generator with this many records
    # instead of DICOM files (no reference counterpart).
    synthetic_count: int = 0

    def validate(self) -> None:
        if self.patch_size <= 0:
            raise ValueError(f"patch_size must be positive, got {self.patch_size}")
        for name in ("overlap_train", "overlap_val_test"):
            v = getattr(self, name)
            if not 0.0 <= v < 1.0:
                raise ValueError(f"{name} must be in [0, 1), got {v}")
        if not 0.0 <= self.empty_threshold <= 1.0:
            raise ValueError(
                f"empty_threshold must be in [0, 1], got {self.empty_threshold}"
            )
        for name in ("bag_size_train", "bag_size_val_test"):
            v = getattr(self, name)
            if v == 0 or v < -1:
                # The reference rejects sizes other than -1 / positive
                # (image_patcher.py:127-128 'Invalid bag size').
                raise ValueError(f"{name} must be -1 or positive, got {v}")
        if self.cv_folds < 2:
            raise ValueError(f"cv_folds must be >= 2, got {self.cv_folds}")


@dataclass(frozen=True)
class SchedulerConfig:
    """``training_plan.scheduler`` block (``reference config.yml:53-57``).

    Declared-but-unused in the reference; here it is actually wired into the
    optimizer factory (see ``train/optim.py``).  ``name='none'`` disables it.
    """

    name: str = "none"  # 'none' | 'lin' | 'step' | 'cosine'
    step_size: int = 100
    gamma: float = 0.9
    # Decay-point units.  'epoch' (default) matches torch StepLR — the
    # scheduler the reference declares steps per epoch — with decay points
    # landing exactly on epoch boundaries (train/optim.py converts via
    # steps-per-epoch).  'step' counts optimizer steps instead.
    unit: str = "epoch"


@dataclass(frozen=True)
class TrainingParameters:
    """``training_plan.parameters`` (``reference config.yml:41-48``)."""

    batch_size: int = 1
    num_workers: int = 8
    lr: float = 0.001
    wd: float = 0.001
    epochs: int = 1000
    patience: int = 50
    grad_acc_steps: int = 2


@dataclass(frozen=True)
class TrainingPlan:
    """``training_plan:`` block (``reference config.yml:39-57``)."""

    weighted_sampler: bool = True
    parameters: TrainingParameters = field(default_factory=TrainingParameters)
    criterion: str = "ce"
    optimizer: str = "sgd"
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)

    def validate(self) -> None:
        if self.criterion.lower() not in _CRITERIA:
            raise ValueError(f"criterion must be one of {_CRITERIA}")
        if self.optimizer.lower() not in _OPTIMIZERS:
            raise ValueError(f"optimizer must be one of {_OPTIMIZERS}")
        if self.scheduler.unit.lower() not in ("epoch", "step"):
            raise ValueError(
                f"scheduler.unit must be 'epoch' or 'step', "
                f"got {self.scheduler.unit!r}"
            )
        if self.parameters.batch_size != 1:
            # The reference trains one bag per step (config.yml:42 ships
            # batch_size: 1; its loop would crash for more, the bs=1
            # ``.item()`` at net_utils.py:20) and so does this rebuild:
            # refuse rather than silently ignore the knob.  k bags per
            # optimizer step = grad_acc_steps; multi-bag SPMD steps =
            # tpu.data_parallel_train.
            raise ValueError(
                "batch_size must be 1 (per-bag training; use "
                "parameters.grad_acc_steps for accumulation or "
                "tpu.data_parallel_train for multi-bag SPMD steps), got "
                f"{self.parameters.batch_size}"
            )


@dataclass(frozen=True)
class TpuConfig:
    """TPU-native knobs (no reference counterpart).

    - ``buckets``: allowed padded bag sizes; each bag is padded to the smallest
      bucket >= its instance count so XLA compiles one program per bucket
      instead of one per bag size.
    - ``compute_dtype``: activations dtype for the backbone ('bfloat16' feeds
      the MXU at full rate; 'float32' for parity tests).
    - ``donate_buffers``: train steps donate the incoming TrainState so XLA
      reuses its HBM in place (params + opt_state + grad accumulator would
      otherwise be live twice per step).  EarlyStopping copies the params it
      stashes, so save-best survives donation.
    """

    buckets: tuple[int, ...] = (64, 128, 256, 512, 1024)
    compute_dtype: str = "float32"
    param_dtype: str = "float32"
    donate_buffers: bool = True
    use_pallas_attention: bool = True
    # The JAX package's choice of the fused kernel for the training step's
    # head.  Parsed only: the port's head runs its kernels on the card
    # unless use_pallas_attention is false (module docstring).
    use_pallas_train: bool = False
    # Opt-in quantized embedding for serving (post-training quantization
    # with static k-sigma activation scales, ops/quantized.py).
    quantized_inference: bool = False
    # Debug toggles (SURVEY.md §5: the JAX analogue of the reference's
    # deterministic-algorithms enforcement is explicit-key purity; these add
    # the NaN/inf tripwires).
    debug_nans: bool = False
    debug_infs: bool = False
    # Checkpoint the full training state every k epochs (0 = best-only, the
    # reference behavior of keeping the best model in RAM until the end).
    checkpoint_every: int = 1
    # Orbax writes checkpoints in the background (the epoch loop never
    # blocks on IO); restore/resume synchronize automatically.
    async_checkpointing: bool = False
    # Shard MC test evaluation over all devices (bags data-parallel); falls
    # back to the sequential path on a single device.
    data_parallel_eval: bool = True
    # Shard TRAINING over all devices: bags group per bucket into mesh-sized
    # batches and one SPMD step computes all per-bag gradients (a mesh batch
    # of B bags counts as B grad-accumulation microbatches).  Off by
    # default: the sequential bs=1 path is the reference-exact trajectory;
    # this one is statistically equivalent (parallel/dp.py docstring).
    # Falls back to sequential on a single device or multi-process runs.
    data_parallel_train: bool = False
    # Loaders pick the smallest registry bucket per bag (sparse bags skip
    # padded embedding compute); data-parallel eval groups bags per bucket
    # before stacking, so this composes with sharded evaluation.
    adaptive_buckets: bool = True
    # What to do with a bag whose valid-tile count exceeds the largest
    # bucket (possible at dense high-overlap eval geometries; the reference
    # keeps EVERY above-threshold tile when bag_size is -1,
    # reference image_patcher.py:115-131 + config.yml:30-32):
    #  - 'extend' (default): pad to a max_size-quantized extended bucket and
    #    keep every tile; evaluation routes such bags to the instance-
    #    sharded path (parallel/instance.py) when a multi-device mesh is
    #    available, else runs them whole on the single device.
    #  - 'truncate': cap at the largest bucket, dropping the LOWEST-fill
    #    tiles — with a loud warning and a loader-side truncated-bag count
    #    (never silent).
    oversized_bags: str = "extend"
    # Multi-process execution: when coordinator_address (host:port of
    # process 0) is set, the CLI joins a gloo process group before anything
    # else runs and CV folds fan out round-robin over processes
    # (parallel/distributed.py).  num_processes/process_id of -1 take
    # WORLD_SIZE/RANK from the environment, as a launcher sets them.
    coordinator_address: str = ""
    num_processes: int = -1
    process_id: int = -1

    def validate(self) -> None:
        if not self.buckets or any(b <= 0 for b in self.buckets):
            raise ValueError(f"buckets must be positive, got {self.buckets}")
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"buckets must be strictly increasing, got {self.buckets}")
        # The Pallas kernels (fused MC attention, DMA tile gather) require
        # bucket sizes that are multiples of the 8-row sublane tile; catching
        # it here fails a bad config at load time instead of deep inside the
        # first kernel trace on TPU.
        bad = [b for b in self.buckets if b % 8]
        if bad:
            raise ValueError(
                f"buckets must be multiples of 8 (TPU sublane tiling; "
                f"required by the Pallas attention kernel), got {bad}"
            )
        if self.oversized_bags not in ("extend", "truncate"):
            raise ValueError(
                f"oversized_bags must be 'extend' or 'truncate', "
                f"got {self.oversized_bags!r}"
            )


@dataclass(frozen=True)
class Config:
    """Top-level config; field-for-field superset of the reference YAML."""

    neptune: bool = False  # enables the experiment-tracking sink
    seed: int = 42
    device: str = "tpu"
    model_path: str = "/tmp/mcgmil_models"
    model: str = "r18"
    # Name under which run_training saves the best model (the reference's
    # config.yml:7 holds exactly such a uuid hex); empty -> fresh uuid4.
    model_id: str = ""
    # Path to a torch state_dict (.pth) whose backbone weights initialize the
    # feature extractor — the reference builds its ResNet ImageNet-pretrained
    # by default (reference model.py:41-50).  Keys may be bare
    # torchvision names or carry the reference's ``feature_extractor.``
    # prefix.  Empty -> random init.
    backbone_weights: str = ""
    shared_att: bool = False
    is_mcdo_val: bool = False
    is_mcdo_test: bool = True
    N: int = 50  # number of Monte-Carlo dropout samples (T)
    feature_dropout: float = 0.1
    attention_dropout: float = 0.1
    data: DataConfig = field(default_factory=DataConfig)
    training_plan: TrainingPlan = field(default_factory=TrainingPlan)
    tpu: TpuConfig = field(default_factory=TpuConfig)

    def validate(self) -> "Config":
        if self.model not in _BACKBONES:
            raise ValueError(f"model must be one of {_BACKBONES}, got {self.model!r}")
        if self.N <= 0:
            raise ValueError(f"N (MC samples) must be positive, got {self.N}")
        for name in ("feature_dropout", "attention_dropout"):
            v = getattr(self, name)
            if not 0.0 <= v < 1.0:
                raise ValueError(f"{name} must be in [0, 1), got {v}")
        self.data.validate()
        self.training_plan.validate()
        self.tpu.validate()
        return self


def _coerce(cls: type, raw: dict[str, Any]) -> Any:
    """Build a dataclass from a raw dict, recursing into nested dataclasses."""
    kwargs: dict[str, Any] = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(raw) - set(fields)
    if unknown:
        raise ValueError(f"Unknown {cls.__name__} keys: {sorted(unknown)}")
    for name in fields:
        if name not in raw:
            continue
        value = raw[name]
        target = _NESTED.get((cls, name))
        if target is not None and isinstance(value, dict):
            value = _coerce(target, value)
        elif isinstance(value, list):
            value = tuple(value)
        kwargs[name] = value
    return cls(**kwargs)


_NESTED: dict[tuple[type, str], type] = {
    (Config, "data"): DataConfig,
    (Config, "training_plan"): TrainingPlan,
    (Config, "tpu"): TpuConfig,
    (TrainingPlan, "parameters"): TrainingParameters,
    (TrainingPlan, "scheduler"): SchedulerConfig,
}

# Reference YAML uses dash-keys (config.yml:10-11); map them to field names.
_KEY_ALIASES = {
    "is_MCDO-val": "is_mcdo_val",
    "is_MCDO-test": "is_mcdo_test",
}


def config_from_dict(raw: dict[str, Any]) -> Config:
    """Build a validated :class:`Config` from a raw (reference-style) dict."""
    raw = {_KEY_ALIASES.get(k, k): v for k, v in raw.items()}
    return _coerce(Config, raw).validate()


def load_config(path: str) -> Config:
    """Load and validate a YAML config file (reference schema accepted verbatim)."""
    with open(path) as f:
        raw = yaml.safe_load(f)
    if not isinstance(raw, dict):
        raise ValueError(f"Config file {path} did not parse to a mapping")
    return config_from_dict(raw)


def config_to_dict(cfg: Config) -> dict[str, Any]:
    """Round-trip a Config back to a plain dict (for logging sinks, or a
    YAML file that :func:`load_config` reads back)."""
    return dataclasses.asdict(cfg)

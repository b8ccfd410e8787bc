"""BENCHMARK.json and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix; the
configuration's file is the one its ``configs`` entry gives, the traffic
mix is ``benchmark/traffic/<traffic>.json``, the network its ``backbone``
names is described by ``benchmark/backbones/<backbone>.json`` and a
per-layer metric is read by ``benchmark/metrics/<name>.py``.  Nothing here
knows any cell, so a new cell needs only new files and new entries.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class SpecError(ValueError):
    """BENCHMARK.json, or a file it names, breaks the benchmark's rules."""


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise SpecError(f"{what} {name!r}: a name is 1-64 letters a-z A-Z, digits, '_', '.' "
                        "and '-', starting with a letter, a digit or '_'")
    return name


def check_unit(unit: str, what: str) -> str:
    if not isinstance(unit, str) or not UNIT_RE.match(unit):
        raise SpecError(f"{what}: unit {unit!r} is not 1-16 of a-z A-Z 0-9 _ / % . -")
    return unit


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: tuple[str, ...] | None
    moves: str | None = None  # per-layer metrics: the end-to-end metric it moves
    layer: str | None = None


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple[Metric, ...]
    per_layer: tuple[Metric, ...]


SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _metric(raw: dict, per_layer: bool) -> Metric:
    name = check_name(raw["name"], "metric")
    better = raw["better"]
    if better not in ("lower", "higher"):
        raise SpecError(f"metric {name}: better is 'lower' or 'higher', got {better!r}")
    sources = SOURCES if per_layer else ("host_clock", "device_trace")
    if raw["source"] not in sources:
        raise SpecError(f"metric {name}: source {raw['source']!r} is not one of {sources}")
    wl = raw.get("workloads")
    return Metric(name, check_unit(raw["unit"], f"metric {name}"), better, raw["source"],
                  None if wl is None else tuple(check_name(w, "workload") for w in wl),
                  raw.get("moves") if per_layer else None, raw.get("layer"))


def load_json(path: Path) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError as e:
        raise SpecError(f"missing file {path}") from e


def traffic_path(name: str) -> Path:
    return BENCH_DIR / "traffic" / f"{check_name(name, 'traffic')}.json"


def metric_path(name: str) -> Path:
    return BENCH_DIR / "metrics" / f"{check_name(name, 'metric')}.py"


def backbone_path(name: str) -> Path:
    return BENCH_DIR / "backbones" / f"{check_name(name, 'backbone')}.json"


@dataclass(frozen=True)
class ConvBN:
    """A convolution (weight ``<conv>.weight``, no bias) and the BN after it
    (``<bn>.weight``, ``<bn>.bias``), names with the block's prefix."""
    conv: str
    bn: str
    cin: int
    cout: int
    kernel: int
    stride: int
    pad: int


@dataclass(frozen=True)
class Block:
    """A residual block: ``convs`` in order, each followed by its BN; a ReLU
    after every BN but the last; the last BN's output plus the shortcut (the
    downsample's BN output, or else the block's input), then a ReLU."""
    prefix: str
    convs: tuple[ConvBN, ...]
    downsample: ConvBN | None


@dataclass(frozen=True)
class Backbone:
    """A ResNet without its classifier: the stem (convolution, BN, ReLU,
    max pool of ``pool = (kernel, stride, pad)``), the blocks, and the
    global average pool to ``features``."""
    features: int
    stem: ConvBN
    pool: tuple[int, int, int]
    blocks: tuple[Block, ...]


def _conv_bn(raw: dict, prefix: str = "") -> ConvBN:
    return ConvBN(prefix + raw["conv"], prefix + raw["bn"], int(raw["cin"]), int(raw["cout"]),
                  int(raw["kernel"]), int(raw["stride"]), int(raw["pad"]))


def load_backbone(name: str) -> Backbone:
    """``benchmark/backbones/<name>.json``, its channels checked to chain
    from the stem through every block to ``features``."""
    path = backbone_path(name)
    raw = load_json(path)
    stem = _conv_bn(raw["stem"])
    pool = raw["stem"]["pool"]
    blocks = tuple(Block(b["prefix"], tuple(_conv_bn(c, b["prefix"]) for c in b["convs"]),
                         None if b["downsample"] is None
                         else _conv_bn(b["downsample"], b["prefix"])) for b in raw["blocks"])
    net = Backbone(int(raw["features"]), stem,
                   (int(pool["kernel"]), int(pool["stride"]), int(pool["pad"])), blocks)
    width = stem.cout
    for b in blocks:
        if not b.convs or [c.cin for c in b.convs] != [width] + [c.cout for c in b.convs[:-1]]:
            raise SpecError(f"{path}: block {b.prefix} does not chain from {width} channels")
        ds = b.downsample
        if ds is None and width != b.convs[-1].cout:
            raise SpecError(f"{path}: block {b.prefix} changes width without a downsample")
        if ds is not None and (ds.cin, ds.cout) != (width, b.convs[-1].cout):
            raise SpecError(f"{path}: block {b.prefix}'s downsample is not {width} to "
                            f"{b.convs[-1].cout} channels")
        width = b.convs[-1].cout
    if width != net.features:
        raise SpecError(f"{path}: the last block yields {width} features, not {net.features}")
    return net


def validate_config(cfg: dict, what: str = "configuration") -> None:
    """The backbone a configuration names is described, yields its ``L``,
    and is the model the port is told to build."""
    name = cfg["backbone"]
    features = load_backbone(name).features
    if features != cfg["L"]:
        raise SpecError(f"{what}: backbone {name} yields {features} features, L is {cfg['L']}")
    model = cfg["port_config"]["model"]
    if model != name:
        raise SpecError(f"{what}: port_config.model is {model!r}, backbone is {name!r}")


def load_cell(workload: str, bench_file: Path | None = None) -> Cell:
    """The cell ``workload`` of BENCHMARK.json with its configuration,
    traffic and the metrics it reports."""
    spec = load_json(bench_file or ROOT / "BENCHMARK.json")
    entries = {w["name"]: w for w in spec["workloads"]}
    if workload not in entries:
        raise SpecError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(entries)}")
    w = entries[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg_entry = configs[check_name(w["config"], "config")]
    cfg_file = (bench_file.parent if bench_file else ROOT) / cfg_entry["file"]
    config = load_json(cfg_file)
    validate_config(config, str(cfg_file))
    traffic = load_json(traffic_path(w["traffic"]))
    e2e = tuple(_metric(m, False) for m in spec["end_to_end"])
    e2e = tuple(m for m in e2e if m.workloads is None or workload in m.workloads)
    reported = {m.name for m in e2e}
    layers = []
    for raw in spec["per_layer"]:
        m = _metric(raw, True)
        listed = m.workloads is None or workload in m.workloads
        if listed and m.moves in reported:
            layers.append(m)
    return Cell(workload, int(w["chips"]), config, traffic, e2e, tuple(layers))


def load_metric_reader(name: str):
    """``read(ctx)`` of ``benchmark/metrics/<name>.py``."""
    path = metric_path(name)
    mod_name = "benchmark_metric_" + re.sub(r"[^A-Za-z0-9_]", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.exists():
        raise SpecError(f"no reader {path} for per-layer metric {name}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def validate(spec: dict) -> None:
    """Names, units and cross-references of a BENCHMARK.json document, and
    each configuration's file against its backbone's."""
    names = set()
    for c in spec["configs"]:
        check_name(c["name"], "config")
        for k in c.get("reduced", []):
            check_name(k, "reduced key")
        validate_config(load_json(BENCH_DIR.parent / c["file"]), f"config {c['name']}")
    cfg_names = {c["name"] for c in spec["configs"]}
    cells = set()
    for w in spec["workloads"]:
        check_name(w["name"], "workload")
        check_name(w["traffic"], "traffic")
        if w["config"] not in cfg_names:
            raise SpecError(f"workload {w['name']}: unknown config {w['config']}")
        if w["chips"] not in (1, 4):
            raise SpecError(f"workload {w['name']}: chips is 1 or 4")
        cells.add(w["name"])
    e2e = set()
    for m in spec["end_to_end"]:
        _metric(m, False)
        e2e.add(m["name"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in names:
            raise SpecError(f"metric {m['name']} named twice")
        names.add(m["name"])
        for wl in m.get("workloads", []):
            if wl not in cells:
                raise SpecError(f"metric {m['name']}: unknown workload {wl}")
    for m in spec["per_layer"]:
        _metric(m, True)
        if m["moves"] not in e2e:
            raise SpecError(f"metric {m['name']}: moves unknown metric {m['moves']}")
        layer = m.get("layer", "")
        if not 0 < len(layer) <= 200 or "\n" in layer or "\t" in layer:
            raise SpecError(f"metric {m['name']}: layer is 1-200 characters on one line")

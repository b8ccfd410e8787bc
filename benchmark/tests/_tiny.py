"""A cell of the benchmark cut to a CPU test's size: the same files, with
the image, the patch, T and the buckets made small."""

from __future__ import annotations

import copy
from argparse import Namespace
from dataclasses import replace

from benchmark import spec

H, W, PATCH, T = 448, 256, 64, 4


def tiny_cell(workload: str, **traffic) -> spec.Cell:
    """The cell ``workload`` with its sizes cut and ``traffic`` overridden."""
    cell = spec.load_cell(workload)
    cfg = copy.deepcopy(cell.config)
    cfg.update(H=H, W=W, patch=PATCH, T=T)
    pc = cfg["port_config"]
    pc["N"] = T
    pc["data"].update(H=H, W=W, size=[H, W], patch_size=PATCH)
    pc["tpu"]["buckets"] = cfg["buckets"] = [8, 16, 32]
    pc["training_plan"]["parameters"]["num_workers"] = 2
    cfg["train"] = dict(cfg.get("train", {}), io_workers=2)
    return replace(cell, config=cfg, traffic=dict(cell.traffic, **traffic))


def args(seed: int = 7, seconds: float = 1.0, trace: int = 0, control: int = 0) -> Namespace:
    return Namespace(workload="tiny", seed=seed, seconds=seconds, trace=trace, control=control)


def with_backbone(cell: spec.Cell, backbone: str) -> spec.Cell:
    """``cell`` with its ResNet swapped for ``backbone``: the reference's,
    the port's and L, as a configuration naming it states them."""
    cfg = copy.deepcopy(cell.config)
    cfg.update(backbone=backbone, L=spec.load_backbone(backbone).features)
    cfg["port_config"]["model"] = backbone
    spec.validate_config(cfg)
    return replace(cell, config=cfg)

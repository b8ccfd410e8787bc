"""The card a run uses: its name, power limit, peaks and memory."""

from __future__ import annotations

import subprocess

import torch

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit.
PEAK_FP32_FLOPS = 67e12  # FP32 cores
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12  # HBM3


class NoCard(RuntimeError):
    """The run asks for more cards than the machine has."""


def require_cards(n: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark runs on a CUDA card only")
    have = torch.cuda.device_count()
    if have < n:
        raise NoCard(f"the cell needs {n} CUDA devices, torch.cuda.device_count() is {have}")


def query_power(index: int = 0):
    """Start ``nvidia-smi`` for the card's name and power limit; read it
    with :func:`power_line` (it runs beside the set-up)."""
    try:
        return subprocess.Popen(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    except OSError:
        return None


def power_line(proc, index: int = 0) -> str:
    """``name, power limit`` as nvidia-smi printed them."""
    if proc is not None:
        try:
            out, _ = proc.communicate(timeout=60)
            if proc.returncode == 0 and out.strip():
                return out.strip().splitlines()[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
    return f"{torch.cuda.get_device_name(index)}, power limit not read"


def device_record(count: int, peak_bytes: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak_bytes)}


def sync() -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()

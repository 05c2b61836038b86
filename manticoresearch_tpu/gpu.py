"""The accelerator a measurement or smoke run is made on.

Runs that report device behaviour refuse to start anywhere but on NVIDIA
GPUs: a number taken on JAX's CPU backend is not a device number.
"""
from __future__ import annotations

import subprocess

import jax


class NoGpuError(RuntimeError):
    pass


def require_gpus(count: int = 1) -> list:
    """The first `count` JAX devices, which must be GPUs."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise NoGpuError(f"JAX found no GPU (platform {devs[0].platform!r})")
    if len(devs) < count:
        raise NoGpuError(f"need {count} GPUs, JAX found {len(devs)}")
    return devs[:count]


def card_lines() -> list[str]:
    """One `name, power limit` line per card, as nvidia-smi reports them
    (the power limit bounds the clocks a card holds under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]

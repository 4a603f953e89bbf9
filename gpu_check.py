"""The GPU that chip_smoke.py and bench.py report on.

``require_gpu`` raises unless JAX's default device is a GPU, so neither
script ever falls back to the CPU; ``nvidia_smi_cards`` reads each
card's name and power limit from a child process that never imports
JAX.
"""

from __future__ import annotations

import subprocess
from typing import Dict, List

import jax


def require_gpu(count: int = 1) -> Dict[str, object]:
    """{"platform", "kind", "count"} of JAX's devices; raises unless the
    first is a GPU and there are at least ``count``."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default device is {devs[0].platform!r}")
    if len(devs) < count:
        raise RuntimeError(f"{count} GPUs needed, JAX sees {len(devs)}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def nvidia_smi_cards() -> List[str]:
    """One "name, power.limit" line per card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]

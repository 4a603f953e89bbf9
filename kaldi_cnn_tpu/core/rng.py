"""RNG discipline.

Kaldi uses a global srand() seed (ref: src/base/kaldi-math.{h,cc}
``RandInt``/``RandGauss``); JAX uses splittable functional PRNG keys.
We centralize the convention: every stochastic stage derives its key
from (base_seed, stage_name, index) so runs are exactly reproducible
and independent of execution order — which is what makes per-iteration
checkpoint/resume deterministic (SURVEY.md §5.3).
"""

from __future__ import annotations

import hashlib

import jax
import numpy as np


def stage_seed(base_seed: int, stage: str, index: int = 0) -> int:
    h = hashlib.sha256(f"{base_seed}/{stage}/{index}".encode()).digest()
    return int.from_bytes(h[:8], "little") & 0x7FFFFFFF


def stage_key(base_seed: int, stage: str, index: int = 0) -> np.ndarray:
    """A threefry key as a host numpy uint32[2] (PRNGKey layout).

    Constructed WITHOUT any device op, so key derivation never costs a
    dispatch; jax.random.* accepts these directly and the key
    materializes on-device only inside jitted code.
    """
    s = stage_seed(base_seed, stage, index)
    return np.array([s >> 32, s & 0xFFFFFFFF], dtype=np.uint32)


def np_rng(base_seed: int, stage: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(stage_seed(base_seed, stage, index))

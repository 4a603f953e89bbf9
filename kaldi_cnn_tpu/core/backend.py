"""Backend policy and the persistent compile cache, decided in one place.

``backend_policy`` is the only code that looks at which backend runs the
program.  On an accelerator the train step stores inter-component
activations and derivatives in bfloat16 and traces its matmuls at the
``"bfloat16"`` precision setting; the convergence-parity test in
tests/test_nnet_train.py pins that program against float32.  On the CPU
it keeps float32 storage and the default precision, so the CPU test
oracle and gradient checks stay exact.

``setup_compile_cache`` points JAX's persistent compilation cache at one
fixed directory inside the checkout unless ``JAX_COMPILATION_CACHE_DIR``
already names one; entry points (chip_smoke.py, bench.py, ``cli.main``,
each recipe's ``__main__``) call it before anything compiles.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import jax
import jax.numpy as jnp

# <checkout>/.jax_cache — fixed, so a cache filled by one run is found by
# the next (the path is part of the cache key); listed in .gitignore
REPO_CACHE_DIR = str(Path(__file__).resolve().parents[2] / ".jax_cache")


@dataclass(frozen=True)
class BackendPolicy:
    # dtype the train step stores between components; None = float32
    train_storage_dtype: Optional[object]
    # jax.default_matmul_precision value for the train step; None = no
    # override
    train_matmul_precision: Optional[str]


def backend_policy() -> BackendPolicy:
    """The numeric policy for JAX's default backend."""
    if jax.default_backend() == "cpu":
        return BackendPolicy(None, None)
    return BackendPolicy(jnp.bfloat16, "bfloat16")


def matmul_precision_scope(precision: Optional[str] = None):
    """Context for tracing a train step: ``precision`` if given, else
    the backend policy's train-step precision (a no-op on the CPU)."""
    prec = precision or backend_policy().train_matmul_precision
    if prec is None:
        return contextlib.nullcontext()
    return jax.default_matmul_precision(prec)


def compile_cache_dir() -> Optional[str]:
    """The directory ``setup_compile_cache`` sets, or None when
    ``JAX_COMPILATION_CACHE_DIR`` is set (JAX then reads it itself)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return REPO_CACHE_DIR


def setup_compile_cache() -> str:
    """Enable the persistent compile cache; returns the directory in
    use.  Call before the first compilation."""
    d = compile_cache_dir()
    if d is None:
        return os.environ["JAX_COMPILATION_CACHE_DIR"]
    jax.config.update("jax_compilation_cache_dir", d)
    return d


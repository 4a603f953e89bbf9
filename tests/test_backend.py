"""The backend policy and the persistent compile cache helper
(kaldi_cnn_tpu.core.backend)."""

from pathlib import Path

import jax
import jax.numpy as jnp

from kaldi_cnn_tpu.core import backend
from kaldi_cnn_tpu.models.components import AffineComponent, \
    SoftmaxComponent
from kaldi_cnn_tpu.models.nnet import Nnet

REPO = Path(__file__).resolve().parents[1]


def _net():
    return Nnet([AffineComponent(4, 3), SoftmaxComponent(3)])


def test_backend_policy_cpu_keeps_float32():
    assert jax.default_backend() == "cpu"
    pol = backend.backend_policy()
    assert pol.train_storage_dtype is None
    assert pol.train_matmul_precision is None
    assert _net()._storage_dtype() is None
    assert jax.config.jax_default_matmul_precision is None
    with backend.matmul_precision_scope():
        assert jax.config.jax_default_matmul_precision is None


def test_backend_policy_gpu_is_bf16(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    pol = backend.backend_policy()
    assert pol.train_storage_dtype == jnp.bfloat16
    assert pol.train_matmul_precision == "bfloat16"
    assert _net()._storage_dtype() == jnp.bfloat16
    # an explicit setting still wins over the policy
    net = _net()
    net.train_storage_dtype = "float32"
    assert net._storage_dtype() is None
    with backend.matmul_precision_scope():
        assert jax.config.jax_default_matmul_precision == "bfloat16"
    with backend.matmul_precision_scope("highest"):
        assert jax.config.jax_default_matmul_precision == "highest"


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert backend.compile_cache_dir() is None
    assert backend.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # untouched


def test_compile_cache_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    a, b = backend.compile_cache_dir(), backend.compile_cache_dir()
    assert a == b == str(REPO / ".jax_cache")
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored, ".jax_cache must be git-ignored"
    before = jax.config.jax_compilation_cache_dir
    try:
        assert backend.setup_compile_cache() == a
        assert jax.config.jax_compilation_cache_dir == a
    finally:
        jax.config.update("jax_compilation_cache_dir", before)

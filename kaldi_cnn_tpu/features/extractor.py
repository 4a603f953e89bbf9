"""Batched/bucketed feature extraction with a jit cache.

XLA compiles per shape; utterances have arbitrary lengths.  The
reference never hits this (CPU, frame-at-a-time loops:
src/featbin/compute-mfcc-feats.cc), but per-shape compilation of an
eager pipeline costs seconds per utterance.  The answer (SURVEY.md §1
'static shapes'): pad every waveform up to a bucket
boundary, jit ONE function per (bucket length), slice the valid frames
off the result.  A handful of buckets covers a corpus; everything after
warmup is a cache hit.

Extraction runs on JAX's default device; ``device='cpu'`` pins it to
the host CPU.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_cnn_tpu.features import functional as F


class FeatureExtractor:
    def __init__(
        self,
        kind: str = "mfcc",                # mfcc | fbank
        opts=None,
        bucket_seconds: float = 1.0,
        device: Optional[str] = None,      # None=default backend, or 'cpu'
        deltas_order: int = 0,
        deltas_window: int = 2,
    ):
        if opts is None:
            opts = F.MfccOptions() if kind == "mfcc" else F.FbankOptions()
        self.kind = kind
        self.opts = opts
        self.bucket = max(1, int(bucket_seconds * opts.frame_opts.samp_freq))
        self.deltas_order = deltas_order
        self.deltas_window = deltas_window
        self._device = jax.devices(device)[0] if device else None
        self._fn = F.compute_mfcc if kind == "mfcc" else F.compute_fbank
        self._jitted: Dict[int, Callable] = {}

    def _compiled(self, padded_len: int) -> Callable:
        if padded_len not in self._jitted:
            fn = self._fn
            opts = self.opts
            order, window = self.deltas_order, self.deltas_window

            def run(wave, key):
                feats = fn(wave, opts, key)
                if order > 0:
                    feats = F.compute_deltas(feats, order, window)
                return feats

            self._jitted[padded_len] = jax.jit(run)
        return self._jitted[padded_len]

    def __call__(self, wave: np.ndarray,
                 key: Optional[jax.Array] = None) -> np.ndarray:
        wave = np.asarray(wave, np.float32).reshape(-1)
        n = len(wave)
        fo = self.opts.frame_opts
        T = F.num_frames(n, fo)
        padded = -(-max(n, fo.window_size) // self.bucket) * self.bucket
        buf = np.zeros(padded, np.float32)
        buf[:n] = wave
        if key is None:
            key = np.zeros(2, np.uint32)
        key = np.asarray(key)  # host key; moves to device inside jit only
        x = buf
        if self._device is not None:
            x = jax.device_put(x, self._device)
            key = jax.device_put(key, self._device)
        feats = self._compiled(padded)(x, key)
        return np.asarray(feats[:T])

    def extract_corpus(self, waves: Dict[str, np.ndarray],
                       base_key: Optional[np.ndarray] = None,
                       ) -> Dict[str, np.ndarray]:
        out = {}
        base = (np.zeros(2, np.uint32) if base_key is None
                else np.asarray(base_key, np.uint32))
        for i, (utt, wave) in enumerate(sorted(waves.items())):
            # host-side fold_in: cheap and deterministic
            k = np.array([base[0] ^ np.uint32(0x9E3779B9 * (i + 1)
                                              & 0xFFFFFFFF),
                          base[1] + np.uint32(i)], dtype=np.uint32)
            out[utt] = self(wave, k)
        return out

"""compute_fbank / compute_mfcc against an independent float64 numpy
implementation of Kaldi's feature pipeline (feature-window.cc,
mel-computations.cc, feature-fbank.cc, feature-mfcc.cc) built on
numpy's rfft."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kaldi_cnn_tpu.features import functional as F

EPS = np.finfo(np.float32).eps


def _speech_like(seconds=1.0, sr=16000, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    wave = sum(np.sin(2 * np.pi * 140.0 * k * t) / k for k in range(1, 9))
    return (wave * 2000.0 + rng.normal(0, 200.0, t.shape)).astype(
        np.float32)


def _np_mel(num_bins, sr, pad, low=20.0):
    mel = lambda f: 1127.0 * np.log(1.0 + f / 700.0)
    nyq = sr / 2.0
    lo, hi = mel(low), mel(nyq)
    delta = (hi - lo) / (num_bins + 1)
    fm = mel(np.arange(pad // 2 + 1) * sr / pad)
    w = np.zeros((num_bins, pad // 2 + 1))
    for b in range(num_bins):
        left, center, right = lo + b * delta, lo + (b + 1) * delta, \
            lo + (b + 2) * delta
        up = (fm - left) / (center - left)
        down = (right - fm) / (right - center)
        w[b] = np.maximum(0.0, np.minimum(up, down))
    return w


def _np_features(wave, fo, num_bins, key=None, use_energy=False,
                 mfcc_ceps=0, lifter=22.0):
    ws, sh, pad = fo.window_size, fo.window_shift, fo.padded_window_size
    T = 1 + (len(wave) - ws) // sh
    x = wave.astype(np.float64)[np.arange(T)[:, None] * sh
                                + np.arange(ws)[None, :]]
    if key is not None:
        x = x + fo.dither * np.asarray(
            jax.random.normal(key, (T, ws), jnp.float32), np.float64)
    x = x - x.mean(axis=1, keepdims=True)
    log_e = np.log(np.maximum((x * x).sum(axis=1), EPS))
    x = x - fo.preemph_coeff * np.concatenate([x[:, :1], x[:, :-1]], 1)
    i = np.arange(ws)
    x = x * (0.5 - 0.5 * np.cos(2 * np.pi * i / (ws - 1))) ** 0.85
    power = np.abs(np.fft.rfft(x, n=pad, axis=1)) ** 2
    logmel = np.log(np.maximum(power @ _np_mel(num_bins, fo.samp_freq,
                                               pad).T, EPS))
    if mfcc_ceps:
        k = np.arange(mfcc_ceps)[:, None]
        dct = np.sqrt(2.0 / num_bins) * np.cos(
            math.pi / num_bins * (np.arange(num_bins)[None] + 0.5) * k)
        dct[0] = np.sqrt(1.0 / num_bins)
        c = logmel @ dct.T
        c = c * (1.0 + 0.5 * lifter * np.sin(math.pi * np.arange(
            mfcc_ceps) / lifter))
        c[:, 0] = log_e
        return c
    if use_energy:
        return np.concatenate([log_e[:, None], logmel], axis=1)
    return logmel


@pytest.mark.parametrize("case", ["fbank23", "fbank40", "fbank_energy",
                                  "fbank_dither", "mfcc"])
def test_features_match_float64_reference(case):
    wave = _speech_like()
    key = None
    if case == "mfcc":
        opts = F.MfccOptions()
    else:
        opts = F.FbankOptions()
        opts.mel_opts.num_bins = 40 if case == "fbank40" else 23
        opts.use_energy = case == "fbank_energy"
    if case == "fbank_dither":
        key = jax.random.PRNGKey(7)
    else:
        opts.frame_opts.dither = 0.0
    nb = opts.mel_opts.num_bins
    if case == "mfcc":
        got = F.compute_mfcc(jnp.asarray(wave), opts, key)
        ref = _np_features(wave, opts.frame_opts, nb, key,
                           mfcc_ceps=opts.num_ceps,
                           lifter=opts.cepstral_lifter)
    else:
        got = F.compute_fbank(jnp.asarray(wave), opts, key)
        ref = _np_features(wave, opts.frame_opts, nb, key,
                           use_energy=opts.use_energy)
    got = np.asarray(got, np.float64)
    assert got.shape == ref.shape
    # float32 pipeline vs float64: log-domain values agree to ~1e-4
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=2e-3)

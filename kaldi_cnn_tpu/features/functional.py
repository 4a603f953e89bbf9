"""jnp reference implementation of Kaldi-semantics feature extraction.

Reference behavior being reproduced (symbol citations per SURVEY.md):
  - framing/windowing: src/feat/feature-window.{h,cc}
    (FrameExtractionOptions: 25 ms / 10 ms, dither, DC removal,
    preemphasis 0.97, povey window, snip_edges)
  - mel filterbank:    src/feat/mel-computations.{h,cc} (MelBanks)
  - fbank:             src/feat/feature-fbank.{h,cc} (Fbank::Compute)
  - MFCC:              src/feat/feature-mfcc.{h,cc} (Mfcc::Compute),
                       DCT matrix from src/matrix/matrix-functions.cc
                       (ComputeDctMatrix), cepstral liftering
  - CMVN/deltas/splice: src/feat/feature-functions.{h,cc}
    (SlidingWindowCmn, ComputeDeltas, SpliceFrames), src/transform/cmvn.cc

Design notes (not a port):
  * All per-frame work is expressed as batched elementwise ops + matmuls
    over a [num_frames, padded_window] array, so XLA fuses the windowing
    chain and the mel/DCT projections are matrix products.
  * The power spectrum is jnp.fft.rfft (the backend's FFT library);
    ``dft_matrices`` gives the same DFT as two matmuls for
    cross-checking.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_cnn_tpu.core.config import configclass

EPSILON = 1.1920928955078125e-07  # FLT_EPSILON, Kaldi's log floor


# --------------------------------------------------------------------------
# Options (names match the reference's ParseOptions registrations)
# --------------------------------------------------------------------------

@configclass
class FrameExtractionOptions:
    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    dither: float = 1.0
    preemph_coeff: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "povey"  # povey|hamming|hanning|rectangular|blackman
    round_to_power_of_two: bool = True
    snip_edges: bool = True

    @property
    def window_size(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_length_ms)

    @property
    def window_shift(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_shift_ms)

    @property
    def padded_window_size(self) -> int:
        if not self.round_to_power_of_two:
            return self.window_size
        n = 1
        while n < self.window_size:
            n *= 2
        return n


@configclass
class MelBanksOptions:
    num_bins: int = 23
    low_freq: float = 20.0
    high_freq: float = 0.0  # <= 0 means nyquist + high_freq


@configclass
class FbankOptions:
    frame_opts: FrameExtractionOptions = None  # type: ignore
    mel_opts: MelBanksOptions = None  # type: ignore
    use_energy: bool = False
    energy_floor: float = 0.0
    raw_energy: bool = True
    use_log_fbank: bool = True

    def __post_init__(self):
        if self.frame_opts is None:
            self.frame_opts = FrameExtractionOptions()
        if self.mel_opts is None:
            self.mel_opts = MelBanksOptions()


@configclass
class MfccOptions:
    frame_opts: FrameExtractionOptions = None  # type: ignore
    mel_opts: MelBanksOptions = None  # type: ignore
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    cepstral_lifter: float = 22.0

    def __post_init__(self):
        if self.frame_opts is None:
            self.frame_opts = FrameExtractionOptions()
        if self.mel_opts is None:
            self.mel_opts = MelBanksOptions()


# --------------------------------------------------------------------------
# Windows / framing
# --------------------------------------------------------------------------

def feature_window(opts: FrameExtractionOptions) -> np.ndarray:
    """The analysis window (ref: feature-window.cc FeatureWindowFunction)."""
    n = opts.window_size
    a = 2.0 * math.pi / (n - 1)
    i = np.arange(n, dtype=np.float64)
    if opts.window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a * i)
    elif opts.window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * i)
    elif opts.window_type == "povey":
        w = (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    elif opts.window_type == "rectangular":
        w = np.ones(n)
    elif opts.window_type == "blackman":
        w = 0.42 - 0.5 * np.cos(a * i) + 0.08 * np.cos(2 * a * i)
    else:
        raise ValueError(f"unknown window type {opts.window_type!r}")
    return w.astype(np.float32)


def num_frames(num_samples: int, opts: FrameExtractionOptions) -> int:
    """Frame count (snip_edges semantics of feature-window.h NumFrames)."""
    if opts.snip_edges:
        if num_samples < opts.window_size:
            return 0
        return 1 + (num_samples - opts.window_size) // opts.window_shift
    return (num_samples + opts.window_shift // 2) // opts.window_shift


def extract_frames(wave: jnp.ndarray, opts: FrameExtractionOptions) -> jnp.ndarray:
    """Slice the waveform into [T, window_size] raw frames.

    snip_edges=True semantics (frame t covers samples
    [t*shift, t*shift + window_size)); for snip_edges=False frames are
    centered with reflection at the edges (feature-window.cc).
    """
    n = wave.shape[0]
    T = num_frames(n, opts)
    ws, sh = opts.window_size, opts.window_shift
    if T == 0:
        return jnp.zeros((0, ws), wave.dtype)
    if opts.snip_edges:
        # gather-free framing: chop the wave into gcd(ws, sh)-sample
        # blocks; frame t is then `span` consecutive blocks starting at
        # block t*step, i.e. `span` strided row-slices concatenated —
        # a [T, ws] gather from the wave can read ~size(wave) bytes PER
        # ROW; slices+concat stream the wave once.
        import math as _math
        g = _math.gcd(ws, sh)
        step, span = sh // g, ws // g
        nb = (T - 1) * step + span
        blocks = jnp.asarray(wave)[: nb * g].reshape(nb, g)
        cols = [jax.lax.slice(blocks, (j, 0),
                              (j + (T - 1) * step + 1, g), (step, 1))
                for j in range(span)]
        return jnp.concatenate(cols, axis=1)
    # centered frames with mirrored edges
    starts = np.arange(T) * sh + sh // 2 - ws // 2
    idx = starts[:, None] + np.arange(ws)[None, :]
    idx = np.where(idx < 0, -idx - 1, idx)
    idx = np.where(idx >= n, 2 * n - 1 - idx, idx)
    idx = np.clip(idx, 0, n - 1)
    return wave[idx]


def process_window(
    frames: jnp.ndarray,
    opts: FrameExtractionOptions,
    key: Optional[jax.Array] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """dither -> DC removal -> raw log-energy -> preemphasis -> window.

    ref: feature-window.cc ProcessWindow/ExtractWindow.  Returns
    (windowed [T, window_size], raw log energy [T]).
    """
    x = frames.astype(jnp.float32)
    if opts.dither != 0.0 and key is not None:
        x = x + opts.dither * jax.random.normal(key, x.shape, x.dtype)
    if opts.remove_dc_offset:
        x = x - jnp.mean(x, axis=-1, keepdims=True)
    raw_energy = jnp.log(jnp.maximum(jnp.sum(x * x, axis=-1), EPSILON))
    if opts.preemph_coeff != 0.0:
        prev = jnp.concatenate([x[:, :1], x[:, :-1]], axis=1)
        x = x - opts.preemph_coeff * prev
    x = x * jnp.asarray(feature_window(opts))
    return x, raw_energy


def frame_signal(
    wave: jnp.ndarray,
    opts: FrameExtractionOptions,
    key: Optional[jax.Array] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """wave [N] -> (windowed, zero-padded frames [T, padded], log-energy [T])."""
    frames = extract_frames(wave, opts)
    win, energy = process_window(frames, opts, key)
    pad = opts.padded_window_size - opts.window_size
    if pad > 0:
        win = jnp.pad(win, ((0, 0), (0, pad)))
    return win, energy


# --------------------------------------------------------------------------
# Mel filterbank / DCT matrices (precomputed on host)
# --------------------------------------------------------------------------

def mel_scale(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq) / 700.0)


def inverse_mel_scale(mel):
    return 700.0 * (np.exp(np.asarray(mel) / 1127.0) - 1.0)


@lru_cache(maxsize=None)
def _mel_banks_cached(num_bins, low_freq, high_freq, samp_freq, padded_window_size):
    nyquist = 0.5 * samp_freq
    high = high_freq if high_freq > 0 else nyquist + high_freq
    if not (0 <= low_freq < high <= nyquist):
        raise ValueError(f"bad mel range [{low_freq}, {high}] vs nyquist {nyquist}")
    num_fft_bins = padded_window_size // 2 + 1
    fft_bin_width = samp_freq / padded_window_size
    mel_low, mel_high = mel_scale(low_freq), mel_scale(high)
    delta = (mel_high - mel_low) / (num_bins + 1)
    centers = mel_low + delta * np.arange(num_bins + 2)  # [left, c0..cN-1, right]
    freqs = fft_bin_width * np.arange(num_fft_bins)
    mels = mel_scale(freqs)[None, :]  # [1, F]
    left = centers[:-2, None]
    center = centers[1:-1, None]
    right = centers[2:, None]
    up = (mels - left) / (center - left)
    down = (right - mels) / (right - center)
    weights = np.maximum(0.0, np.minimum(up, down))
    return weights.astype(np.float32)  # [num_bins, num_fft_bins]


def mel_banks(opts: MelBanksOptions, frame_opts: FrameExtractionOptions) -> np.ndarray:
    """[num_bins, num_fft_bins] triangular filters
    (ref: mel-computations.cc MelBanks::MelBanks)."""
    return _mel_banks_cached(
        opts.num_bins, opts.low_freq, opts.high_freq,
        frame_opts.samp_freq, frame_opts.padded_window_size)


def dct_matrix(num_rows: int, num_cols: int) -> np.ndarray:
    """Orthonormal DCT-II matrix [num_rows, num_cols]
    (ref: matrix/matrix-functions.cc ComputeDctMatrix)."""
    m = np.zeros((num_rows, num_cols))
    m[0, :] = math.sqrt(1.0 / num_cols)
    scale = math.sqrt(2.0 / num_cols)
    for k in range(1, num_rows):
        m[k, :] = scale * np.cos(math.pi / num_cols * (np.arange(num_cols) + 0.5) * k)
    return m.astype(np.float32)


def lifter_coeffs(num_ceps: int, q: float) -> np.ndarray:
    """Cepstral liftering coefficients (ref: feature-mfcc.cc ComputeLifterCoeffs)."""
    i = np.arange(num_ceps)
    return (1.0 + 0.5 * q * np.sin(math.pi * i / q)).astype(np.float32)


def dft_matrices(padded_window_size: int):
    """Real-DFT as two matmul operands: cos/sin matrices [N, F].

    power[t, f] = (frames @ C)[t,f]^2 + (frames @ S)[t,f]^2 — the DFT
    of src/matrix/srfft.cc SplitRadixRealFft, written as matmuls.
    """
    n = padded_window_size
    f = n // 2 + 1
    k = np.arange(n)[:, None]
    j = np.arange(f)[None, :]
    ang = 2.0 * np.pi * k * j / n
    cos = np.cos(ang)
    sin = -np.sin(ang)
    return cos.astype(np.float32), sin.astype(np.float32)


# --------------------------------------------------------------------------
# fbank / MFCC
# --------------------------------------------------------------------------

def power_spectrum(windowed: jnp.ndarray) -> jnp.ndarray:
    """[T, padded] -> [T, padded//2+1] |rfft|^2 (srfft.cc equivalent)."""
    spec = jnp.fft.rfft(windowed, axis=-1)
    return (spec.real ** 2 + spec.imag ** 2).astype(jnp.float32)


def compute_fbank(
    wave: jnp.ndarray,
    opts: Optional[FbankOptions] = None,
    key: Optional[jax.Array] = None,
) -> jnp.ndarray:
    """wave [N] -> log-mel filterbank [T, num_bins(+1 if use_energy)].

    ref: feature-fbank.cc Fbank::Compute; energy (if used) goes in
    column 0 like the reference.
    """
    opts = opts or FbankOptions()
    windowed, log_energy = frame_signal(wave, opts.frame_opts, key)
    power = power_spectrum(windowed)
    mel = jnp.asarray(mel_banks(opts.mel_opts, opts.frame_opts))
    mel_energies = power @ mel.T
    feats = mel_energies
    if opts.use_log_fbank:
        feats = jnp.log(jnp.maximum(mel_energies, EPSILON))
    if opts.use_energy:
        energy = log_energy if opts.raw_energy else jnp.log(
            jnp.maximum(jnp.sum(windowed**2, axis=-1), EPSILON))
        if opts.energy_floor > 0.0:
            energy = jnp.maximum(energy, math.log(opts.energy_floor))
        feats = jnp.concatenate([energy[:, None], feats], axis=1)
    return feats


def compute_mfcc(
    wave: jnp.ndarray,
    opts: Optional[MfccOptions] = None,
    key: Optional[jax.Array] = None,
) -> jnp.ndarray:
    """wave [N] -> MFCC [T, num_ceps] (ref: feature-mfcc.cc Mfcc::Compute)."""
    opts = opts or MfccOptions()
    windowed, log_energy = frame_signal(wave, opts.frame_opts, key)
    power = power_spectrum(windowed)
    mel = jnp.asarray(mel_banks(opts.mel_opts, opts.frame_opts))
    log_mel = jnp.log(jnp.maximum(power @ mel.T, EPSILON))
    dct = jnp.asarray(dct_matrix(opts.num_ceps, opts.mel_opts.num_bins))
    feats = log_mel @ dct.T
    if opts.cepstral_lifter != 0.0:
        feats = feats * jnp.asarray(lifter_coeffs(opts.num_ceps, opts.cepstral_lifter))
    if opts.use_energy:
        energy = log_energy
        if opts.energy_floor > 0.0:
            energy = jnp.maximum(energy, math.log(opts.energy_floor))
        feats = feats.at[:, 0].set(energy)
    return feats


# --------------------------------------------------------------------------
# Post-processing: CMVN, deltas, splicing
# --------------------------------------------------------------------------

def apply_cmvn(feats: jnp.ndarray, norm_vars: bool = False) -> jnp.ndarray:
    """Per-utterance cepstral mean (and optionally variance) normalization
    (ref: transform/cmvn.cc ApplyCmvn with per-utt stats)."""
    mean = jnp.mean(feats, axis=0, keepdims=True)
    out = feats - mean
    if norm_vars:
        std = jnp.sqrt(jnp.var(feats, axis=0, keepdims=True) + 1e-10)
        out = out / std
    return out


def cmvn_stats(feats: np.ndarray) -> np.ndarray:
    """Kaldi-layout CMVN stats [2, dim+1]: row0 = sum,count; row1 = sumsq.
    (ref: transform/cmvn.cc AccCmvnStats)."""
    dim = feats.shape[1]
    stats = np.zeros((2, dim + 1), dtype=np.float64)
    stats[0, :dim] = feats.sum(axis=0)
    stats[0, dim] = feats.shape[0]
    stats[1, :dim] = (feats ** 2).sum(axis=0)
    return stats


def apply_cmvn_stats(feats: jnp.ndarray, stats: np.ndarray,
                     norm_vars: bool = False) -> jnp.ndarray:
    count = stats[0, -1]
    mean = stats[0, :-1] / count
    out = feats - jnp.asarray(mean, dtype=feats.dtype)
    if norm_vars:
        var = stats[1, :-1] / count - mean ** 2
        out = out / jnp.asarray(np.sqrt(np.maximum(var, 1e-10)), feats.dtype)
    return out


def sliding_window_cmn(feats: jnp.ndarray, window: int = 600,
                       center: bool = True) -> jnp.ndarray:
    """Sliding-window cepstral mean normalization
    (ref: feature-functions.cc SlidingWindowCmn, cmn_window=600, center)."""
    T = feats.shape[0]
    cum = jnp.cumsum(jnp.pad(feats, ((1, 0), (0, 0))), axis=0)  # [T+1, D]
    t = jnp.arange(T)
    if center:
        lo = jnp.clip(t - window // 2, 0, T)
        hi = jnp.clip(t + (window + 1) // 2, 0, T)
        # widen clipped edge windows to `window` frames where possible
        lo = jnp.where(hi - lo < window, jnp.maximum(0, hi - window), lo)
        hi = jnp.where(hi - lo < window, jnp.minimum(T, lo + window), hi)
    else:
        lo = jnp.clip(t + 1 - window, 0, T)
        hi = jnp.maximum(t + 1, jnp.minimum(window, T))
    mean = (cum[hi] - cum[lo]) / (hi - lo)[:, None]
    return feats - mean


def compute_deltas(feats: jnp.ndarray, order: int = 2,
                   window: int = 2) -> jnp.ndarray:
    """Append delta features (ref: feature-functions.cc DeltaFeatures).

    Same regression formula as the reference: scales [-w..w] * i,
    normalized by sum(i^2); edges replicate.
    """
    outs = [feats]
    cur = feats
    denom = sum(i * i for i in range(1, window + 1)) * 2
    offsets = np.arange(-window, window + 1)
    scales = offsets / denom
    T = feats.shape[0]
    t = np.arange(T)
    idx = np.clip(t[:, None] + offsets[None, :], 0, T - 1)  # [T, 2w+1]
    for _ in range(order):
        cur = jnp.einsum("twd,w->td", cur[idx], jnp.asarray(scales, feats.dtype))
        outs.append(cur)
    return jnp.concatenate(outs, axis=1)


def splice_frames(feats: jnp.ndarray, left_context: int,
                  right_context: int) -> jnp.ndarray:
    """[T, D] -> [T, (l+r+1)*D] with edge replication
    (ref: feature-functions.cc SpliceFrames; nnet2 SpliceComponent)."""
    T = feats.shape[0]
    offsets = np.arange(-left_context, right_context + 1)
    idx = np.clip(np.arange(T)[:, None] + offsets[None, :], 0, T - 1)
    return feats[idx].reshape(T, -1)

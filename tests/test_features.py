"""Feature-extraction tests, modeled on the reference's
feat/feature-test.cc invariants (windowing, energy, mel geometry) plus
golden checks of the jnp pipeline's internal consistency."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kaldi_cnn_tpu.features import functional as F


def _tone(sr=16000, dur=0.5, freq=440.0, amp=1000.0):
    t = np.arange(int(sr * dur)) / sr
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def test_num_frames_snip_edges():
    opts = F.FrameExtractionOptions()
    assert opts.window_size == 400
    assert opts.window_shift == 160
    assert opts.padded_window_size == 512
    assert F.num_frames(400, opts) == 1
    assert F.num_frames(399, opts) == 0
    assert F.num_frames(560, opts) == 2
    assert F.num_frames(16000, opts) == 98


def test_povey_window_shape():
    opts = F.FrameExtractionOptions(window_type="povey")
    w = F.feature_window(opts)
    assert w.shape == (400,)
    assert w[0] == pytest.approx(0.0, abs=1e-6)
    assert np.max(w) == pytest.approx(1.0, abs=1e-4)
    # povey = hanning^0.85 >= hanning on (0,1)
    hann = F.feature_window(F.FrameExtractionOptions(window_type="hanning"))
    assert np.all(w + 1e-7 >= hann)


def test_mel_banks_partition_of_unity_interior():
    fo = F.FrameExtractionOptions()
    mo = F.MelBanksOptions(num_bins=23)
    m = F.mel_banks(mo, fo)
    assert m.shape == (23, 257)
    # interior FFT bins covered by the filterbank sum to ~1 (triangles overlap)
    colsums = m.sum(axis=0)
    interior = colsums[30:200]
    assert np.all(interior > 0.9) and np.all(interior < 1.1)
    # each filter is contiguous and unimodal
    for row in m:
        nz = np.nonzero(row)[0]
        assert len(nz) > 0
        assert nz[-1] - nz[0] == len(nz) - 1


def test_dct_matrix_orthonormal():
    d = F.dct_matrix(23, 23)
    np.testing.assert_allclose(d @ d.T, np.eye(23), atol=1e-5)


def test_power_spectrum_matches_matmul_dft():
    """The DFT-as-matmul form (dft_matrices) must equal rfft."""
    opts = F.FrameExtractionOptions(dither=0.0)
    wave = jnp.asarray(_tone())
    windowed, _ = F.frame_signal(wave, opts)
    p_fft = F.power_spectrum(windowed)
    cos, sin = F.dft_matrices(opts.padded_window_size)
    p_mm = (windowed @ cos) ** 2 + (windowed @ sin) ** 2
    np.testing.assert_allclose(np.asarray(p_fft), np.asarray(p_mm),
                               rtol=1e-3, atol=1e-1)


def test_fbank_shape_and_tone_peak():
    opts = F.FbankOptions()
    opts.frame_opts.dither = 0.0
    wave = jnp.asarray(_tone(freq=1000.0))
    feats = F.compute_fbank(wave, opts)
    assert feats.shape == (F.num_frames(8000, opts.frame_opts), 23)
    # the mel bin containing 1 kHz should dominate
    m = F.mel_banks(opts.mel_opts, opts.frame_opts)
    bin_1k = int(np.argmax(m[:, int(1000 / (16000 / 512))]))
    mean_feats = np.asarray(feats).mean(axis=0)
    assert np.argmax(mean_feats) in range(bin_1k - 1, bin_1k + 2)


def test_fbank_energy_column():
    opts = F.FbankOptions(use_energy=True)
    opts.frame_opts.dither = 0.0
    feats = F.compute_fbank(jnp.asarray(_tone()), opts)
    assert feats.shape[1] == 24
    # energy of a 1000-amp sine: log(sum x^2) ~ log(400 * 1000^2 / 2)
    expected = np.log(400 * 1000.0**2 / 2)
    assert np.allclose(np.asarray(feats[2:-2, 0]), expected, atol=0.5)


def test_mfcc_shape_and_c0():
    opts = F.MfccOptions(use_energy=False, cepstral_lifter=22.0)
    opts.frame_opts.dither = 0.0
    feats = F.compute_mfcc(jnp.asarray(_tone()), opts)
    assert feats.shape[1] == 13
    assert np.all(np.isfinite(np.asarray(feats)))


def test_dither_reproducible():
    opts = F.FbankOptions()
    key = jax.random.PRNGKey(0)
    w = jnp.asarray(_tone())
    f1 = F.compute_fbank(w, opts, key)
    f2 = F.compute_fbank(w, opts, key)
    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))


def test_deltas_shape_and_constant_signal():
    feats = jnp.ones((20, 5))
    out = F.compute_deltas(feats, order=2, window=2)
    assert out.shape == (20, 15)
    np.testing.assert_allclose(np.asarray(out[:, 5:]), 0.0, atol=1e-6)


def test_deltas_linear_ramp():
    # d/dt of a unit-slope ramp is 1 (away from edges)
    feats = jnp.arange(30, dtype=jnp.float32)[:, None]
    out = F.compute_deltas(feats, order=1, window=2)
    np.testing.assert_allclose(np.asarray(out[3:-3, 1]), 1.0, atol=1e-5)


def test_splice_frames():
    feats = jnp.arange(12, dtype=jnp.float32).reshape(4, 3)
    out = F.splice_frames(feats, 1, 1)
    assert out.shape == (4, 9)
    np.testing.assert_array_equal(np.asarray(out[0, :3]), np.asarray(feats[0]))
    np.testing.assert_array_equal(np.asarray(out[1, :3]), np.asarray(feats[0]))
    np.testing.assert_array_equal(np.asarray(out[1, 3:6]), np.asarray(feats[1]))


def test_cmvn():
    x = jnp.asarray(np.random.default_rng(0).normal(5.0, 2.0, (100, 8)),
                    dtype=jnp.float32)
    y = F.apply_cmvn(x, norm_vars=True)
    np.testing.assert_allclose(np.asarray(y.mean(0)), 0.0, atol=1e-4)
    np.testing.assert_allclose(np.asarray(y.var(0)), 1.0, atol=1e-3)
    stats = F.cmvn_stats(np.asarray(x))
    y2 = F.apply_cmvn_stats(x, stats, norm_vars=True)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y2), atol=1e-3)


def test_sliding_window_cmn_long_window_equals_global():
    x = jnp.asarray(np.random.default_rng(0).normal(3.0, 1.0, (50, 4)),
                    dtype=jnp.float32)
    y = F.sliding_window_cmn(x, window=1000, center=True)
    np.testing.assert_allclose(np.asarray(y), np.asarray(F.apply_cmvn(x)),
                               atol=1e-4)

"""Feature extraction: framing, STFT, mel, fbank/MFCC, CMVN, deltas,
splicing.

JAX replacement for Kaldi's ``src/feat/`` (feature-window.cc,
feature-fbank.cc, feature-mfcc.cc, mel-computations.cc,
feature-functions.cc).  The jnp pipeline in ``functional.py`` runs on
every backend (rfft via the backend's FFT) and is golden-tested against
a float64 numpy reference.
"""

from kaldi_cnn_tpu.features.functional import (
    FrameExtractionOptions,
    MelBanksOptions,
    FbankOptions,
    MfccOptions,
    frame_signal,
    mel_banks,
    dct_matrix,
    compute_fbank,
    compute_mfcc,
    apply_cmvn,
    sliding_window_cmn,
    compute_deltas,
    splice_frames,
)

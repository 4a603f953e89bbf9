"""Diagonal-GMM acoustic models for the bootstrap training stages
(flat-start mono -> deltas -> LDA+MLLT -> SAT), which produce the
alignments the neural AM trains on.

JAX re-design of src/gmm/ (DiagGmm, AmDiagGmm, AccumAmDiagGmm,
MleAmDiagGmmUpdate): scoring is one batched matmul over ALL Gaussians
of ALL pdfs per utterance (jnp, one large matmul) instead of the
reference's per-frame GEMV hot loop (ref: src/gmm/diag-gmm.cc
DiagGmm::LogLikelihoods); accumulation/update stay on host in numpy
(offline, small).
"""

from kaldi_cnn_tpu.gmm.diag_gmm import DiagGmm
from kaldi_cnn_tpu.gmm.am_gmm import AmDiagGmm, AmDiagGmmAccs
from kaldi_cnn_tpu.gmm.train import (
    train_mono, align_equal, MonoTrainOptions)

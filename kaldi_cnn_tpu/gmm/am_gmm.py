"""Acoustic model = one DiagGmm per pdf
(ref: src/gmm/am-diag-gmm.{h,cc} AmDiagGmm;
src/gmm/mle-am-diag-gmm.{h,cc} AccumAmDiagGmm).

Utterance scoring packs every Gaussian of every pdf into one [G, D]
bank and computes all frame-vs-Gaussian log-likelihoods with a single
matmul, then segment-logsumexps per pdf — replacing the reference's
per-frame, per-pdf GEMV (decodable-am-diag-gmm.cc LogLikelihood) with
one matmul-shaped batch (SURVEY.md §2 disposition for gmm/).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from kaldi_cnn_tpu.gmm.diag_gmm import DiagGmm, DiagGmmAccs


class AmDiagGmm:
    def __init__(self, gmms: List[DiagGmm]):
        self.gmms = gmms

    @property
    def num_pdfs(self) -> int:
        return len(self.gmms)

    @property
    def dim(self) -> int:
        return self.gmms[0].dim

    @staticmethod
    def flat_start(num_pdfs: int, mean: np.ndarray,
                   var: np.ndarray) -> "AmDiagGmm":
        """All pdfs share the global Gaussian (ref: gmm-init-mono)."""
        return AmDiagGmm([DiagGmm.from_stats(mean, var)
                          for _ in range(num_pdfs)])

    def _bank(self):
        """Pack all components: returns (lin [G,D], quad [G,D],
        gconst [G], seg_ids [G])."""
        lins, quads, gcs, segs = [], [], [], []
        for p, g in enumerate(self.gmms):
            inv = 1.0 / g.vars
            lins.append(g.means * inv)
            quads.append(0.5 * inv)
            gcs.append(g.gconsts())
            segs.append(np.full(g.num_gauss, p))
        return (np.concatenate(lins), np.concatenate(quads),
                np.concatenate(gcs), np.concatenate(segs))

    def loglikes(self, feats: np.ndarray) -> np.ndarray:
        """[T, D] -> [T, num_pdfs] log-likelihood matrix for a whole
        utterance (two matmuls + segmented logsumexp)."""
        lin, quad, gc, seg = self._bank()
        comp = feats @ lin.T - (feats ** 2) @ quad.T + gc[None, :]  # [T, G]
        T = feats.shape[0]
        out = np.full((T, self.num_pdfs), -np.inf)
        # segmented logsumexp (few pdfs; loop over pdfs is fine on host;
        # the jnp path in models/ uses segment_max/segment_sum)
        for p in range(self.num_pdfs):
            cols = comp[:, seg == p]
            m = cols.max(axis=1)
            out[:, p] = m + np.log(np.exp(cols - m[:, None]).sum(axis=1))
        return out

    def total_gauss(self) -> int:
        return sum(g.num_gauss for g in self.gmms)

    def split_to_total(self, target_total: int,
                       occs: np.ndarray, rng: np.random.Generator) -> None:
        """Distribute new Gaussians proportionally to pdf occupancy
        (ref: am-diag-gmm.cc SplitByCount power rule, simplified)."""
        share = np.maximum(occs, 1.0) ** 0.2
        counts = np.array([g.num_gauss for g in self.gmms], float)
        targets = counts.copy()
        # greedy exact allocation: give each extra Gaussian to the pdf
        # with the highest share-to-count ratio
        for _ in range(int(target_total - counts.sum())):
            p = int(np.argmax(share / targets))
            targets[p] += 1
        for p, g in enumerate(self.gmms):
            if targets[p] > g.num_gauss:
                self.gmms[p] = g.split(int(targets[p]), rng)


class AmDiagGmmAccs:
    """(ref: mle-am-diag-gmm.cc AccumAmDiagGmm)."""

    def __init__(self, am: AmDiagGmm):
        self.accs = [DiagGmmAccs(g.num_gauss, g.dim) for g in am.gmms]

    def accumulate(self, am: AmDiagGmm, feats: np.ndarray,
                   alignment: np.ndarray) -> None:
        """alignment: [T] pdf-ids (hard Viterbi occupancy)."""
        for p in np.unique(alignment):
            sel = alignment == p
            self.accs[int(p)].accumulate(
                am.gmms[int(p)], feats[sel], np.ones(int(sel.sum())))

    def pdf_occs(self) -> np.ndarray:
        return np.array([a.occ.sum() for a in self.accs])

    def update(self, am: AmDiagGmm, min_occ: float = 3.0,
               var_floor: float = 1e-3) -> AmDiagGmm:
        return AmDiagGmm([acc.update(g, min_occ, var_floor)
                          for g, acc in zip(am.gmms, self.accs)])

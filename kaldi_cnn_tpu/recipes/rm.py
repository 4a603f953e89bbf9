"""The RM-style recipe: full GMM bootstrap chain + p-norm DNN on fMLLR
features (ref: egs/rm/s5/run.sh -> local/nnet2/run_5c-ish p-norm
config; BASELINE.json config "nnet2 p-norm DNN hybrid on fMLLR feats").

Stages (mirroring steps/*):
  mono     train_mono on MFCC+deltas            (steps/train_mono.sh)
  tri1     train_deltas on a triphone tree      (steps/train_deltas.sh)
  tri2b    LDA+MLLT                             (steps/train_lda_mllt.sh)
  tri3b    SAT / per-speaker fMLLR              (steps/train_sat.sh)
  nnet     p-norm DNN on fMLLR feats + NG-SGD   (steps/nnet2/train_pnorm_simple.sh)
  decode   lattice decode + two-pass fMLLR      (steps/decode_fmllr.sh)
  score    lattice rescoring sweep              (local/score.sh)

Run: ``python -m kaldi_cnn_tpu.recipes.rm``
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from kaldi_cnn_tpu.core.logging import MetricsWriter, Timer, get_logger
from kaldi_cnn_tpu.decode.decoder import lattice_decode, viterbi_align
from kaldi_cnn_tpu.decode.graph import CompiledGraph
from kaldi_cnn_tpu.decode.lattice import shortest_path
from kaldi_cnn_tpu.decode.score import wer_details
from kaldi_cnn_tpu.features.functional import splice_frames
from kaldi_cnn_tpu.gmm.train import (
    DeltasTrainOptions, LdaMlltTrainOptions, MonoTrainOptions,
    SatTrainOptions, train_deltas, train_lda_mllt, train_mono, train_sat)
from kaldi_cnn_tpu.lang.arpa import make_unigram_arpa
from kaldi_cnn_tpu.lang.hclg import Lang, make_hclg_from_arpa
from kaldi_cnn_tpu.recipes import synthetic
from kaldi_cnn_tpu.recipes.yesno import compute_features
from kaldi_cnn_tpu.transform import FmllrAccs, apply_affine

logger = get_logger(__name__)


def score_sweep(lats: Dict[str, "object"], refs, word_table,
                scales=(0.02, 0.05, 0.1, 0.2),
                wips=(-2.0, -1.0, -0.5, 0.0, 0.5)
                ) -> Tuple[float, Tuple[float, float], Dict]:
    """Lattice rescoring sweep (ref: local/score.sh LMWT x WIP grid):
    decode once, rescore the lattices per operating point."""
    best = (np.inf, (0.1, 0.0), None)
    for s in scales:
        for wip in wips:
            hyps = {}
            for utt, lat in lats.items():
                _, wids, _ = shortest_path(lat, 1.0, s, wip)
                hyps[utt] = [word_table.sym(int(w)) for w in wids]
            r = wer_details(refs, hyps)
            if r["wer"] < best[0]:
                best = (r["wer"], (s, wip), r)
    return best


def fmllr_feats(raw: Dict[str, np.ndarray], transform: np.ndarray,
                spk_transforms: Dict[str, np.ndarray],
                spk_of_utt: Dict[str, str],
                splice: Tuple[int, int] = (3, 3)
                ) -> Dict[str, np.ndarray]:
    """splice -> LDA+MLLT -> per-speaker fMLLR
    (ref: the final feature pipeline of steps/train_sat.sh)."""
    out = {}
    for utt, f in raw.items():
        g = apply_affine(np.asarray(splice_frames(f, *splice)), transform)
        W = spk_transforms.get(spk_of_utt.get(utt, utt))
        if W is not None:
            g = g @ W[:, :-1].T + W[:, -1]
        out[utt] = g.astype(np.float32)
    return out


def estimate_test_fmllr(am, hclg: CompiledGraph, lang: Lang,
                        feats: Dict[str, np.ndarray],
                        acoustic_scale: float = 0.1,
                        silence_weight: float = 0.01,
                        min_count: float = 50.0
                        ) -> Dict[str, np.ndarray]:
    """Unsupervised per-utterance fMLLR from a first-pass decode
    (ref: steps/decode_fmllr.sh: si decode -> weight-silence-post ->
    gmm-est-fmllr)."""
    tm = lang.trans_model
    tid2pdf = tm.trans_id_to_pdf_array()
    sil_id = lang.phone_table.id(lang.lexicon.silence_phone)
    out = {}
    for utt, f in feats.items():
        lat = lattice_decode(hclg, am.loglikes(f),
                             acoustic_scale=acoustic_scale,
                             beam=60.0, lattice_beam=8.0, max_active=2000)
        tids, _, _ = shortest_path(lat, 1.0, acoustic_scale)
        if len(tids) != f.shape[0]:
            continue
        w = np.ones(len(tids), np.float32)
        phones = np.asarray([tm.id_to_phone(int(t)) for t in tids])
        w[phones == sil_id] = silence_weight
        acc = FmllrAccs(f.shape[1])
        acc.accumulate_am(am, f, tid2pdf[tids], frame_weights=w)
        W = acc.update(min_count=min_count)
        if W is not None:
            out[utt] = W.astype(np.float32)
    return out


def run(
    num_utts: int = 140,
    seed: int = 29,
    nnet_epochs: int = 25,
    metrics: Optional[MetricsWriter] = None,
    corpus=None,
    exp_dir: Optional[str] = None,
    stage: int = 0,
    eval_utts: int = 0,
) -> Dict:
    """exp_dir/stage: stage-guarded execution (ref: the reference
    recipes' --stage resume; SURVEY.md §5.3) — see recipes/wsj.py.
    eval_utts > 0: dev/test come from a dedicated eval corpus of that
    many utterances (disjoint seed) and the whole main corpus trains —
    the statistically-sized ledger configuration (see wsj.py)."""
    import jax
    from kaldi_cnn_tpu.core.stages import make_runner
    from kaldi_cnn_tpu.models.factory import PnormDnnConfig, make_pnorm_dnn
    from kaldi_cnn_tpu.train.egs import Egs, EgsConfig, make_egs
    from kaldi_cnn_tpu.train.trainer import TrainConfig, train_nnet
    from kaldi_cnn_tpu.models.nnet import AmNnet

    sr = make_runner(exp_dir, stage)
    synthetic_corpus = corpus is None
    if corpus is None:
        lex = synthetic.digits_lexicon()
        wp = {w: 1.0 / len(lex.entries) for w in lex.entries}
        corpus = synthetic.make_corpus(lex, wp, num_utts, 1, 4, seed)
    else:
        lex, wp = corpus.lexicon, corpus.word_probs
    if eval_utts > 0 and synthetic_corpus:
        eval_corpus = synthetic.make_corpus(lex, wp, eval_utts, 1, 4,
                                            seed + 9001)
        dev, test = eval_corpus.split(0.5)
        train = corpus
    else:
        traindev, test = corpus.split(0.2)
        train, dev = traindev.split(0.15)
    logger.info("corpus: %d train / %d dev / %d test",
                len(train.waves), len(dev.waves), len(test.waves))
    timer = Timer()
    feats_tr, feats_dev, feats_te = sr.stage("features", lambda: (
        compute_features(train, seed),
        compute_features(dev, seed + 1),
        compute_features(test, seed + 2)))
    raw_tr = {u: f[:, :13] for u, f in feats_tr.items()}
    raw_dev = {u: f[:, :13] for u, f in feats_dev.items()}
    raw_te = {u: f[:, :13] for u, f in feats_te.items()}
    logger.info("features in %.1fs", timer.elapsed())

    # --- GMM bootstrap chain ---------------------------------------------
    lang = Lang.create(lex)
    timer.reset()
    am0, ali0 = sr.stage("mono", lambda: train_mono(
        feats_tr, train.transcripts, lang,
        MonoTrainOptions(num_iters=20, totgauss=300)))
    logger.info("mono in %.1fs", timer.elapsed())
    timer.reset()
    am1, ali1, tri1 = sr.stage("tri1", lambda: train_deltas(
        feats_tr, train.transcripts, lang, ali0, lang.trans_model,
        DeltasTrainOptions(num_iters=15, totgauss=600, max_leaves=200)))
    logger.info("tri1 (deltas) in %.1fs", timer.elapsed())
    timer.reset()
    am2, ali2, tri2, lda_mllt = sr.stage("tri2b", lambda: train_lda_mllt(
        raw_tr, train.transcripts, lang, ali1, tri1.trans_model,
        LdaMlltTrainOptions(num_iters=15, totgauss=800, max_leaves=250,
                            lda_dim=20)))
    logger.info("tri2b (LDA+MLLT) in %.1fs", timer.elapsed())
    lda_tr = {u: apply_affine(np.asarray(splice_frames(f, 3, 3)),
                              lda_mllt).astype(np.float32)
              for u, f in raw_tr.items()}
    timer.reset()
    am3, ali3, spk_xforms = sr.stage("tri3b_sat", lambda: train_sat(
        lda_tr, train.transcripts, tri2, ali2,
        opts=SatTrainOptions(num_iters=12, totgauss=900,
                             fmllr_min_count=50.0)))
    logger.info("tri3b (SAT) in %.1fs", timer.elapsed())

    arpa = make_unigram_arpa(wp)
    tid2pdf2 = tri2.trans_model.trans_id_to_pdf_array()
    hclg2 = CompiledGraph(make_hclg_from_arpa(tri2, arpa), tid2pdf2)

    # GMM-SAT decode on dev (two-pass fMLLR) for the baseline number
    def gmm_decode(raw_set, refs):
        lda_f = {u: apply_affine(np.asarray(splice_frames(f, 3, 3)),
                                 lda_mllt).astype(np.float32)
                 for u, f in raw_set.items()}
        xf = estimate_test_fmllr(am2, hclg2, tri2, lda_f)
        lats = {}
        for utt, f in lda_f.items():
            W = xf.get(utt)
            g = f if W is None else (f @ W[:, :-1].T + W[:, -1])
            lats[utt] = lattice_decode(
                hclg2, am3.loglikes(g), acoustic_scale=0.1,
                beam=60.0, lattice_beam=8.0, max_active=2000)
        return lats, {u: (f if (W := xf.get(u)) is None
                          else (f @ W[:, :-1].T + W[:, -1]).astype(
                              np.float32))
                      for u, f in lda_f.items()}

    timer.reset()
    dev_lats, dev_fmllr = gmm_decode(raw_dev, dev.transcripts)
    gmm_wer, gmm_pt, _ = score_sweep(dev_lats, dev.transcripts,
                                     tri2.word_table)
    logger.info("tri3b dev WER %.2f%% at %s (%.1fs)", gmm_wer, gmm_pt,
                timer.elapsed())

    # --- p-norm DNN on fMLLR feats ---------------------------------------
    train_fmllr = fmllr_feats(raw_tr, lda_mllt, spk_xforms,
                              {u: u for u in raw_tr})
    egs_cfg = EgsConfig(left_context=4, right_context=4)
    egs_all = make_egs(train_fmllr, ali3,
                       tri2.trans_model.trans_id_to_pdf_array(), egs_cfg)
    n_valid = max(len(egs_all) // 20, 256)
    egs_valid = Egs(egs_all.x[:n_valid], egs_all.y[:n_valid],
                    egs_all.weights[:n_valid])
    egs_train = Egs(egs_all.x[n_valid:], egs_all.y[n_valid:],
                    egs_all.weights[n_valid:])
    dim = egs_train.x.shape[1]
    num_pdfs = tri2.trans_model.num_pdfs
    net = make_pnorm_dnn(PnormDnnConfig(
        input_dim=dim, num_hidden_layers=2, pnorm_input_dim=800,
        pnorm_output_dim=160, num_pdfs=num_pdfs))
    timer.reset()
    params = sr.stage("dnn_train", lambda: jax.device_get(train_nnet(
        net, egs_train, egs_valid,
        TrainConfig(num_epochs=nnet_epochs, minibatch_size=256,
                    initial_learning_rate=0.08,
                    final_learning_rate=0.008, seed=seed))[0]))
    logger.info("p-norm DNN trained in %.1fs", timer.elapsed())
    am_nnet = AmNnet(net, num_pdfs)
    counts = np.bincount(egs_train.y, minlength=num_pdfs)
    am_nnet.set_priors_from_counts(counts)

    # --- DNN decode (features: fMLLR from the GMM first pass) ------------
    # through the production batched on-device lattice decoder
    def nnet_decode(raw_set, fmllr_set):
        from kaldi_cnn_tpu.decode.topk_decoder import decode_utterances
        lls = {}
        for utt, g in fmllr_set.items():
            spliced = np.asarray(splice_frames(
                g, egs_cfg.left_context, egs_cfg.right_context))
            lls[utt] = np.asarray(am_nnet.loglikes(params, spliced))
        return decode_utterances(hclg2, lls, acoustic_scale=0.1,
                                 beam=60.0, lattice_beam=8.0,
                                 max_active=2000,
                                 lattice_arcs_per_frame=None)

    timer.reset()
    dev_nlats = nnet_decode(raw_dev, dev_fmllr)
    dnn_dev_wer, dnn_pt, _ = score_sweep(dev_nlats, dev.transcripts,
                                         tri2.word_table)
    logger.info("DNN dev WER %.2f%% at %s", dnn_dev_wer, dnn_pt)

    test_lats, test_fmllr = gmm_decode(raw_te, test.transcripts)
    test_nlats = nnet_decode(raw_te, test_fmllr)
    hyps = {}
    s, wip = dnn_pt
    for utt, lat in test_nlats.items():
        _, wids, _ = shortest_path(lat, 1.0, s, wip)
        hyps[utt] = [tri2.word_table.sym(int(w)) for w in wids]
    result = wer_details(test.transcripts, hyps)
    decode_t = timer.elapsed()
    gmm_test = score_sweep(test_lats, test.transcripts, tri2.word_table,
                           scales=(gmm_pt[0],), wips=(gmm_pt[1],))[2]
    result.update(gmm_dev_wer=gmm_wer, dnn_dev_wer=dnn_dev_wer,
                  gmm_test_wer=gmm_test["wer"])
    logger.info("RM results: tri3b test WER %.2f%%, DNN test WER %.2f%% "
                "(%d err / %d words)", gmm_test["wer"], result["wer"],
                result["errors"], result["words"])
    if metrics:
        metrics.write("rm_result",
                      **{k: v for k, v in result.items()
                         if not isinstance(v, dict)})
    return result


if __name__ == "__main__":
    import argparse
    import sys
    from kaldi_cnn_tpu.core.backend import setup_compile_cache
    setup_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--eval-utts", type=int, default=0,
                    help="dedicated eval corpus size (ledger runs: 800)")
    a = ap.parse_args()
    res = run(eval_utts=a.eval_utts)
    sys.exit(0 if res["wer"] <= max(res["gmm_test_wer"], 2.0) else 1)

"""The Switchboard-style recipe: CNN acoustic model + speaker iVectors
(ref: BASELINE.json config "CNN + online iVector speaker adaptation
(Switchboard)"; upstream egs/swbd/s5b local/online convnet scripts,
SURVEY.md §3.5 pipeline).

The synthetic corpus gets real per-speaker variation (vocal-tract-
length formant scaling), a diag UBM + total-variability extractor
produces per-utterance iVectors, and the CNN consumes
[fbank (t,f,c) volume | iVector] through SliceParallelComponent.

Run: ``python -m kaldi_cnn_tpu.recipes.swbd``
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from kaldi_cnn_tpu.core.logging import MetricsWriter, Timer, get_logger
from kaldi_cnn_tpu.decode.graph import CompiledGraph
from kaldi_cnn_tpu.decode.lattice import shortest_path
from kaldi_cnn_tpu.decode.score import wer_details
from kaldi_cnn_tpu.gmm.train import (
    DeltasTrainOptions, MonoTrainOptions, train_deltas, train_mono)
from kaldi_cnn_tpu.ivector import (
    IvectorExtractor, length_normalize, train_ubm)
from kaldi_cnn_tpu.lang.arpa import make_unigram_arpa
from kaldi_cnn_tpu.lang.hclg import Lang, make_hclg_from_arpa
from kaldi_cnn_tpu.recipes import synthetic
from kaldi_cnn_tpu.recipes.rm import score_sweep
from kaldi_cnn_tpu.recipes.wsj import (
    compute_fbank_volumes, make_cnn_egs, splice_volume)
from kaldi_cnn_tpu.recipes.yesno import compute_features

logger = get_logger(__name__)


def run(
    num_speakers: int = 24,
    utts_per_speaker: int = 7,
    seed: int = 43,
    nnet_epochs: int = 25,
    num_filters: int = 48,
    ivector_dim: int = 12,
    metrics: Optional[MetricsWriter] = None,
    exp_dir: Optional[str] = None,
    stage: int = 0,
    eval_utts_per_speaker: int = 0,
    use_pitch: bool = False,
) -> Dict:
    """exp_dir/stage: stage-guarded execution (ref: the reference
    recipes' --stage resume; SURVEY.md §5.3) — see recipes/wsj.py.
    eval_utts_per_speaker > 0: each speaker contributes that many
    EXTRA utterances used only for dev/test (split evenly), so the
    eval sets scale without touching training cost — the
    statistically-sized ledger configuration (see wsj.py).
    use_pitch: append the processed 3-column Kaldi-pitch stream
    (pov, normalized log pitch, delta pitch — features/pitch.py) to
    every frame's auxiliary input alongside the iVector, bypassing the
    conv front end (ref: the swbd pitch recipes' fbank+pitch inputs,
    process-kaldi-pitch-feats | paste-feats)."""
    import jax
    from kaldi_cnn_tpu.core.stages import make_runner
    from kaldi_cnn_tpu.models.factory import (
        ConvnetConfig, make_convnet_ivector)
    from kaldi_cnn_tpu.models.nnet import AmNnet
    from kaldi_cnn_tpu.train.egs import Egs
    from kaldi_cnn_tpu.train.trainer import TrainConfig, train_nnet

    sr = make_runner(exp_dir, stage)
    lex = synthetic.digits_lexicon()
    wp = {w: 1.0 / len(lex.entries) for w in lex.entries}
    corpus, spk_of = synthetic.make_speaker_corpus(
        lex, wp, num_speakers,
        utts_per_speaker + eval_utts_per_speaker, 1, 4, seed)
    if eval_utts_per_speaker > 0:
        def _j(u):
            return int(u.rsplit("_utt", 1)[1])
        train = corpus.subset(
            [u for u in corpus.waves if _j(u) < utts_per_speaker])
        evalc = [u for u in corpus.waves if _j(u) >= utts_per_speaker]
        dev = corpus.subset([u for u in evalc if _j(u) % 2 == 0])
        test = corpus.subset([u for u in evalc if _j(u) % 2 == 1])
    else:
        train, test = corpus.split(0.2)
        train, dev = train.split(0.15)
    logger.info("corpus: %d train / %d dev / %d test over %d speakers",
                len(train.waves), len(dev.waves), len(test.waves),
                num_speakers)
    timer = Timer()
    mfcc_tr = sr.stage("mfcc", lambda: compute_features(train, seed=seed))
    lang = Lang.create(lex)

    def _bootstrap():
        am0, ali0 = train_mono(
            mfcc_tr, train.transcripts, lang,
            MonoTrainOptions(num_iters=18, totgauss=300))
        return train_deltas(
            mfcc_tr, train.transcripts, lang, ali0, lang.trans_model,
            DeltasTrainOptions(num_iters=12, totgauss=700,
                               max_leaves=250))

    am1, ali1, tri = sr.stage("gmm_bootstrap", _bootstrap)
    logger.info("GMM bootstrap in %.1fs", timer.elapsed())

    # --- iVector system (ref: steps/online/nnet2/train_diag_ubm.sh +
    # train_ivector_extractor.sh + extract_ivectors_online.sh) --------
    timer.reset()
    raw13 = {u: f[:, :13] for u, f in mfcc_tr.items()}

    def _ivector_system():
        ubm = train_ubm(list(raw13.values()), 16, num_iters=4, seed=seed)
        ext = IvectorExtractor(ubm, ivector_dim, seed=seed)
        ext.train(list(raw13.values()), num_iters=4)
        return ubm, ext

    ubm, ext = sr.stage("ivector_extractor", _ivector_system)

    def ivectors_for(corpus_set, seed_off):
        f = compute_features(corpus_set, seed=seed + seed_off)
        return {u: length_normalize(ext.extract(ff[:, :13])).astype(
            np.float32) for u, ff in f.items()}

    iv_tr = {u: length_normalize(ext.extract(f)).astype(np.float32)
             for u, f in raw13.items()}
    iv_dev = ivectors_for(dev, 101)
    iv_te = ivectors_for(test, 102)
    logger.info("iVectors in %.1fs", timer.elapsed())

    num_bins = 36
    left, right = 5, 5
    vol_tr = compute_fbank_volumes(train, num_bins, seed)
    vol_dev = compute_fbank_volumes(dev, num_bins, seed + 1)
    vol_te = compute_fbank_volumes(test, num_bins, seed + 2)

    aux_dim = ivector_dim + (3 if use_pitch else 0)

    def aux_rows(corpus_set, vols, ivs):
        """Per-utterance [T, aux_dim] auxiliary rows: the utterance
        iVector repeated per frame (ref: the online pipeline appends
        the current iVector estimate per chunk) + the per-frame
        processed pitch stream when use_pitch."""
        from kaldi_cnn_tpu.features.pitch import (
            compute_and_process_pitch)
        out = {}
        for utt, v in vols.items():
            T = v.shape[0]
            a = np.repeat(ivs[utt][None, :], T, axis=0)
            if use_pitch:
                pf = compute_and_process_pitch(
                    np.asarray(corpus_set.waves[utt], np.float64))
                if len(pf) < T:
                    pf = np.pad(pf, ((0, T - len(pf)), (0, 0)),
                                mode="edge")
                a = np.concatenate([a, pf[:T]], axis=1)
            out[utt] = a.astype(np.float32)
        return out

    aux_tr = aux_rows(train, vol_tr, iv_tr)
    aux_dev = aux_rows(dev, vol_dev, iv_dev)
    aux_te = aux_rows(test, vol_te, iv_te)

    tid2pdf = tri.trans_model.trans_id_to_pdf_array()
    num_pdfs = tri.trans_model.num_pdfs
    egs_vol = make_cnn_egs(vol_tr, ali1, tid2pdf, left, right, seed)
    ivec_rows = np.concatenate([
        aux_tr[u] for u in sorted(vol_tr) if u in ali1
        and len(ali1[u]) == vol_tr[u].shape[0]])
    from kaldi_cnn_tpu.core.rng import np_rng
    perm = np_rng(seed, "cnn_egs_shuffle").permutation(len(egs_vol.y))
    # make_cnn_egs shuffled with the same seed: apply same perm to ivecs
    ivec_rows = ivec_rows[perm]
    x = np.concatenate([egs_vol.x, ivec_rows], axis=1)
    egs_all = Egs(x, egs_vol.y, egs_vol.weights)
    n_valid = max(len(egs_all) // 20, 256)
    egs_valid = Egs(egs_all.x[:n_valid], egs_all.y[:n_valid],
                    egs_all.weights[:n_valid])
    egs_train = Egs(egs_all.x[n_valid:], egs_all.y[n_valid:],
                    egs_all.weights[n_valid:])

    cfg = ConvnetConfig(
        in_t=left + 1 + right, in_f=num_bins, in_c=3,
        filt_t=4, filt_f=7, num_filters=num_filters,
        pool_t=2, pool_f=3, pool_c=1,
        num_hidden_layers=2, pnorm_input_dim=800, pnorm_output_dim=160,
        num_pdfs=num_pdfs)
    net = make_convnet_ivector(cfg, ivector_dim=aux_dim)
    assert net.input_dim == egs_train.x.shape[1]
    timer.reset()
    params = sr.stage("nnet_train", lambda: jax.device_get(train_nnet(
        net, egs_train, egs_valid,
        TrainConfig(num_epochs=nnet_epochs, minibatch_size=256,
                    initial_learning_rate=0.08,
                    final_learning_rate=0.008, seed=seed))[0]))
    train_t = timer.elapsed()
    logger.info("CNN+ivec trained in %.1fs", train_t)
    am_nnet = AmNnet(net, num_pdfs)
    am_nnet.set_priors_from_counts(
        np.bincount(egs_train.y, minlength=num_pdfs))

    hclg = CompiledGraph(make_hclg_from_arpa(tri, make_unigram_arpa(wp)),
                         tid2pdf)

    def nnet_decode(vols, aux):
        from kaldi_cnn_tpu.decode.topk_decoder import decode_utterances
        xs = {}
        for utt, v in vols.items():
            x = splice_volume(v, left, right)
            xs[utt] = np.concatenate([x, aux[utt][:x.shape[0]]], axis=1)
        lls = am_nnet.loglikes_batch(params, xs)
        # production path: batched on-device top-K lattice decode
        return decode_utterances(hclg, lls, acoustic_scale=0.1,
                                 beam=60.0, lattice_beam=8.0,
                                 max_active=2000,
                                 lattice_arcs_per_frame=None)

    dev_lats = nnet_decode(vol_dev, aux_dev)
    dev_wer, pt, _ = score_sweep(dev_lats, dev.transcripts,
                                 tri.word_table)
    logger.info("CNN+ivec dev WER %.2f%% at %s", dev_wer, pt)
    test_lats = nnet_decode(vol_te, aux_te)
    hyps = {}
    for utt, lat in test_lats.items():
        _, wids, _ = shortest_path(lat, 1.0, pt[0], pt[1])
        hyps[utt] = [tri.word_table.sym(int(w)) for w in wids]
    result = wer_details(test.transcripts, hyps)
    result.update(dev_wer=dev_wer, use_pitch=use_pitch)
    logger.info("swbd CNN+ivec test WER %.2f%% (%d err / %d words)",
                result["wer"], result["errors"], result["words"])
    if metrics:
        metrics.write("swbd_result",
                      **{k: v for k, v in result.items()
                         if not isinstance(v, dict)})
    return result


if __name__ == "__main__":
    import argparse
    import sys
    from kaldi_cnn_tpu.core.backend import setup_compile_cache
    setup_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--eval-utts-per-speaker", type=int, default=0,
                    help="extra eval utts per speaker (ledger runs: 34)")
    ap.add_argument("--pitch", action="store_true",
                    help="append the processed Kaldi-pitch stream")
    a = ap.parse_args()
    res = run(eval_utts_per_speaker=a.eval_utts_per_speaker,
              use_pitch=a.pitch)
    sys.exit(0 if res["wer"] < 20.0 else 1)

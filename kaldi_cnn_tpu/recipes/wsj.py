"""The WSJ-style CNN recipe — the fork's headline configuration
(ref: BASELINE.json config "nnet2 CNN (Conv2D + maxpool over fbank)
hybrid AM (WSJ)"; upstream analogue steps/nnet2/train_convnet_accel2.sh
driven from egs/wsj/s5/run.sh).

Pipeline:
  MFCC GMM bootstrap (mono -> tri deltas)        for alignments
  fbank (36 mel bins) + deltas as (t, f, c) volumes
  Conv2D + Maxpool3D + p-norm stack CNN AM        (the fork's layers)
  NG-SGD training, prior adjustment
  lattice decode + rescoring sweep; batched on-device decode for RTF

Run: ``python -m kaldi_cnn_tpu.recipes.wsj``
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from kaldi_cnn_tpu.core.logging import MetricsWriter, Timer, get_logger
from kaldi_cnn_tpu.core.rng import stage_key
from kaldi_cnn_tpu.decode.decoder import lattice_decode
from kaldi_cnn_tpu.decode.graph import CompiledGraph
from kaldi_cnn_tpu.decode.lattice import shortest_path
from kaldi_cnn_tpu.decode.score import wer_details
from kaldi_cnn_tpu.features import functional as F
from kaldi_cnn_tpu.features.extractor import FeatureExtractor
from kaldi_cnn_tpu.gmm.train import (
    DeltasTrainOptions, MonoTrainOptions, train_deltas, train_mono)
from kaldi_cnn_tpu.lang.arpa import make_unigram_arpa
from kaldi_cnn_tpu.lang.hclg import Lang, make_hclg_from_arpa
from kaldi_cnn_tpu.recipes import synthetic
from kaldi_cnn_tpu.recipes.rm import score_sweep
from kaldi_cnn_tpu.recipes.yesno import compute_features

logger = get_logger(__name__)


def compute_fbank_volumes(corpus, num_bins: int = 36, seed: int = 0,
                          device: Optional[str] = None
                          ) -> Dict[str, np.ndarray]:
    """Per-utterance [T, num_bins, 3] volumes: static + delta + delta2
    channels over mel filterbanks (ref: conf/fbank.conf 36 bins + the
    convnet scripts' --delta-order=2), extracted on the default device
    (``device='cpu'`` pins the host)."""
    opts = F.FbankOptions()
    opts.frame_opts.samp_freq = float(corpus.sample_rate)
    opts.frame_opts.dither = 1.0
    opts.mel_opts.num_bins = num_bins
    ex = FeatureExtractor("fbank", opts, bucket_seconds=1.0,
                          device=device, deltas_order=2)
    flat = ex.extract_corpus(corpus.waves, stage_key(seed, "fbank_dither"))
    out = {}
    for utt, f in flat.items():
        # deltas concatenate channel blocks: [static | d1 | d2],
        # i.e. dim index = c * num_bins + fbin -> reshape to (c, f)
        T = f.shape[0]
        v = f.reshape(T, 3, num_bins).transpose(0, 2, 1)  # [T, f, c]
        out[utt] = np.ascontiguousarray(v, np.float32)
    return out


def make_cnn_egs(volumes: Dict[str, np.ndarray],
                 alignments: Dict[str, np.ndarray],
                 tid_to_pdf: np.ndarray,
                 left_context: int = 5, right_context: int = 5,
                 seed: int = 0):
    """Spliced (t, f, c) volumes flattened in the Conv2DComponent row
    layout: index = (t * in_f + f) * in_c + c
    (ref: nnet-get-egs + the fork's patch layout)."""
    from kaldi_cnn_tpu.core.rng import np_rng
    from kaldi_cnn_tpu.train.egs import Egs
    xs, ys = [], []
    n_no_ali = n_len = 0
    w = left_context + 1 + right_context
    for utt in sorted(volumes):
        if utt not in alignments:
            n_no_ali += 1
            continue
        v = volumes[utt]                       # [T, f, c]
        ali = np.asarray(alignments[utt])
        T = v.shape[0]
        if len(ali) != T:
            n_len += 1
            continue
        idx = np.clip(np.arange(T)[:, None]
                      + np.arange(-left_context, right_context + 1)[None],
                      0, T - 1)
        sp = v[idx]                            # [T, w, f, c]
        xs.append(sp.reshape(T, -1))
        ys.append(tid_to_pdf[ali])
    if n_no_ali or n_len:
        logger.warning(
            "make_cnn_egs skipped %d/%d utterances (%d missing "
            "alignment, %d feature/alignment length mismatch)",
            n_no_ali + n_len, len(volumes), n_no_ali, n_len)
    if not xs:
        raise ValueError(
            f"no usable egs: all {len(volumes)} utterances skipped "
            f"({n_no_ali} missing alignment, {n_len} length mismatch) — "
            "were the alignments produced on the same corpus/features?")
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.int32)
    rng = np_rng(seed, "cnn_egs_shuffle")
    perm = rng.permutation(len(y))
    return Egs(x[perm], y[perm], np.ones(len(y), np.float32))


def write_cnn_egs_sharded(out_dir: str, volumes: Dict[str, np.ndarray],
                          alignments: Dict[str, np.ndarray],
                          tid_to_pdf: np.ndarray,
                          left_context: int = 5, right_context: int = 5,
                          num_shards: int = 8, seed: int = 0):
    """Streaming variant of make_cnn_egs: per-utterance spliced blocks
    go straight to an on-disk sharded store — peak memory is one
    utterance + one shard, never the corpus (ref: steps/nnet2/get_egs.sh
    sharding + nnet-shuffle-egs; the scalable path for the 960h-style
    config)."""
    from kaldi_cnn_tpu.train.sharded_egs import ShardedEgsWriter
    w = ShardedEgsWriter(out_dir, num_shards, seed)
    for utt in sorted(volumes):
        if utt not in alignments:
            continue
        v = volumes[utt]
        ali = np.asarray(alignments[utt])
        if len(ali) != v.shape[0]:
            continue
        T = v.shape[0]
        idx = np.clip(np.arange(T)[:, None]
                      + np.arange(-left_context,
                                  right_context + 1)[None], 0, T - 1)
        w.add(v[idx].reshape(T, -1), tid_to_pdf[ali])
    return w.finalize()


def splice_volume(v: np.ndarray, left: int, right: int) -> np.ndarray:
    T = v.shape[0]
    idx = np.clip(np.arange(T)[:, None]
                  + np.arange(-left, right + 1)[None], 0, T - 1)
    return v[idx].reshape(T, -1)


def run(
    num_utts: int = 160,
    seed: int = 37,
    nnet_epochs: int = 25,
    num_filters: int = 64,
    metrics: Optional[MetricsWriter] = None,
    corpus=None,
    ext_alignments: Optional[Dict[str, np.ndarray]] = None,
    ext_ali_mdl: Optional[str] = None,
    device_decode: bool = True,
    exp_dir: Optional[str] = None,
    stage: int = 0,
    noise_std: float = 250.0,
    formant_jitter: float = 0.08,
    eval_dnn: bool = False,
    decode_beam: float = 60.0,
    decode_max_active: int = 2000,
    # None: derive the lattice record capacity from max_active
    # (TpuTopKDecoder._derive_lattice_arcs) — zero auto-grow re-decodes
    decode_arcs_per_frame: Optional[int] = None,
    # >0: dev/test come from a DEDICATED eval corpus of this many
    # utterances (same lexicon/noise hardening, disjoint seed) and the
    # whole main corpus trains — the ledger runs use 600 so the test
    # set holds >=1000 words and the CNN-vs-DNN delta clears its own
    # binomial noise (paired_sign_test); 0 keeps the historical
    # 160-utt 80/20 split for cheap smoke runs
    eval_utts: int = 0,
) -> Dict:
    """corpus: any object with the SyntheticCorpus shape (e.g. from
    recipes.datadir.corpus_from_data_dir); defaults to the synthetic
    digits corpus.  ext_alignments: externally produced transition-id
    alignments (e.g. the reference's ali ark via
    datadir.load_alignments_ark) used instead of the GMM bootstrap for
    differential testing; ``ext_ali_mdl`` must then name the .mdl that
    produced them — its transition model supplies the tid->pdf map and
    num_pdfs (the reference pairs --alidir with its model the same way,
    ref: steps/nnet2/get_egs.sh).  Without it the external ark must
    share this run's transition model, which is only true when it was
    produced by an identical bootstrap; max(tid) is validated either
    way.  device_decode: decode dev/test through the batched TpuTopKDecoder
    (the production path); False falls back to the host lattice
    decoder.  exp_dir/stage: stage-guarded execution — per-stage
    artifacts land under exp_dir and re-running with ``stage=K`` skips
    (loads) completed stages, the reference's crash-recovery model
    (ref: steps/nnet2/train_*.sh --stage; SURVEY.md §5.3).
    noise_std/formant_jitter: default-corpus hardening (additive noise
    + per-utterance spectral shift) so test WER is non-zero and
    config-discriminative.  eval_dnn: additionally train a p-norm DNN
    of matched size on the SAME egs and decode it — the CNN-vs-DNN
    ledger delta (the fork's headline claim)."""
    import jax
    import jax.numpy as jnp
    from kaldi_cnn_tpu.models.factory import ConvnetConfig, make_convnet
    from kaldi_cnn_tpu.models.nnet import AmNnet
    from kaldi_cnn_tpu.train.egs import Egs
    from kaldi_cnn_tpu.train.trainer import TrainConfig, train_nnet

    synthetic_corpus = corpus is None
    if corpus is None:
        lex = synthetic.digits_lexicon()
        wp = {w: 1.0 / len(lex.entries) for w in lex.entries}
        corpus = synthetic.make_noisy_corpus(
            lex, wp, num_utts, 2, 5, seed, noise_std=noise_std,
            formant_jitter=formant_jitter)
    else:
        lex, wp = corpus.lexicon, corpus.word_probs
    if eval_utts > 0 and synthetic_corpus:
        # dedicated large eval corpus: all of `corpus` trains, dev and
        # test are fresh draws from the same distribution
        eval_corpus = synthetic.make_noisy_corpus(
            lex, wp, eval_utts, 2, 5, seed + 9001,
            noise_std=noise_std, formant_jitter=formant_jitter)
        dev, test = eval_corpus.split(0.5)
        train = corpus
    else:
        traindev, test = corpus.split(0.2)
        train, dev = traindev.split(0.15)
    logger.info("corpus: %d train / %d dev / %d test",
                len(train.waves), len(dev.waves), len(test.waves))

    from kaldi_cnn_tpu.core.stages import make_runner
    sr = make_runner(exp_dir, stage)

    timer = Timer()
    mfcc_tr = sr.stage("mfcc", lambda: compute_features(train, seed=seed))
    logger.info("mfcc in %.1fs", timer.elapsed())

    # GMM bootstrap for alignments (ref: wsj tri2 alignments feed the
    # convnet's egs)
    lang = Lang.create(lex)
    timer.reset()

    def _bootstrap():
        am0, ali0 = train_mono(
            mfcc_tr, train.transcripts, lang,
            MonoTrainOptions(num_iters=18, totgauss=300))
        return train_deltas(
            mfcc_tr, train.transcripts, lang, ali0, lang.trans_model,
            DeltasTrainOptions(num_iters=12, totgauss=700, max_leaves=250))

    am1, ali1, tri = sr.stage("gmm_bootstrap", _bootstrap)
    logger.info("GMM bootstrap in %.1fs", timer.elapsed())

    num_bins = 36
    left, right = 5, 5
    timer.reset()
    vol_tr, vol_dev, vol_te = sr.stage("fbank", lambda: (
        compute_fbank_volumes(train, num_bins, seed),
        compute_fbank_volumes(dev, num_bins, seed + 1),
        compute_fbank_volumes(test, num_bins, seed + 2)))
    logger.info("fbank volumes in %.1fs", timer.elapsed())

    tid2pdf = tri.trans_model.trans_id_to_pdf_array()
    num_pdfs = tri.trans_model.num_pdfs
    if ext_alignments is not None:
        # differential mode: external (reference-produced) alignments
        # replace the bootstrap's (ref: steps/nnet2/get_egs.sh --alidir,
        # which pairs the ali dir with the model that produced it)
        if ext_ali_mdl is not None:
            from kaldi_cnn_tpu.io.kaldi_model import read_gmm_model
            ext_tm, _ = read_gmm_model(ext_ali_mdl)
            tid2pdf = ext_tm.trans_id_to_pdf_array()
            num_pdfs = ext_tm.num_pdfs
        max_tid = max((int(np.max(a)) for a in ext_alignments.values()
                       if len(a)), default=0)
        if max_tid >= len(tid2pdf):
            raise ValueError(
                f"external alignment transition-id {max_tid} out of "
                f"range for the {'supplied' if ext_ali_mdl else 'bootstrap'}"
                f" transition model ({len(tid2pdf)} ids); pass the .mdl "
                f"that produced the ark via --ali-mdl")
        ali1 = ext_alignments
        logger.info("using %d external alignments", len(ali1))
    egs_all = sr.stage("egs", lambda: make_cnn_egs(
        vol_tr, ali1, tid2pdf, left, right, seed))
    n_valid = max(len(egs_all) // 20, 256)
    egs_valid = Egs(egs_all.x[:n_valid], egs_all.y[:n_valid],
                    egs_all.weights[:n_valid])
    egs_train = Egs(egs_all.x[n_valid:], egs_all.y[n_valid:],
                    egs_all.weights[n_valid:])
    logger.info("egs: %d train / %d valid, dim %d",
                len(egs_train), len(egs_valid), egs_train.x.shape[1])

    cfg = ConvnetConfig(
        in_t=left + 1 + right, in_f=num_bins, in_c=3,
        filt_t=4, filt_f=7, num_filters=num_filters,
        pool_t=2, pool_f=3, pool_c=1,
        num_hidden_layers=2, pnorm_input_dim=1000, pnorm_output_dim=200,
        num_pdfs=num_pdfs)
    net = make_convnet(cfg)
    assert net.input_dim == egs_train.x.shape[1]
    timer.reset()
    params = sr.stage("nnet_train", lambda: jax.device_get(train_nnet(
        net, egs_train, egs_valid,
        TrainConfig(num_epochs=nnet_epochs, minibatch_size=256,
                    initial_learning_rate=0.08,
                    final_learning_rate=0.008, seed=seed,
                    checkpoint_dir=(sr.exp_dir or "")))[0]))
    train_t = max(timer.elapsed(), 1e-9)
    frames = nnet_epochs * len(egs_train)
    logger.info("CNN trained in %.1fs (%.0f audio-s/s)", train_t,
                frames / 100.0 / train_t)
    am_nnet = AmNnet(net, num_pdfs)
    am_nnet.set_priors_from_counts(
        np.bincount(egs_train.y, minlength=num_pdfs))

    hclg = CompiledGraph(make_hclg_from_arpa(tri, make_unigram_arpa(wp)),
                         tid2pdf)

    def nnet_decode(vols, am, ps):
        # one padded stream over all utterances (AmNnet.loglikes_batch)
        lls = am.loglikes_batch(
            ps, {utt: splice_volume(v, left, right)
                 for utt, v in vols.items()})
        if device_decode:
            # production path: batched on-device top-K beam search with
            # on-device lattice emission + determinization
            from kaldi_cnn_tpu.decode.topk_decoder import decode_utterances
            return decode_utterances(
                hclg, lls, acoustic_scale=0.1, beam=decode_beam,
                lattice_beam=8.0, max_active=decode_max_active,
                lattice_arcs_per_frame=decode_arcs_per_frame)
        return {utt: lattice_decode(hclg, ll, acoustic_scale=0.1,
                                    beam=decode_beam, lattice_beam=8.0,
                                    max_active=decode_max_active)
                for utt, ll in lls.items()}

    def decode_and_score(am, ps, tag):
        dev_lats = nnet_decode(vol_dev, am, ps)
        dev_wer, pt, _ = score_sweep(dev_lats, dev.transcripts,
                                     tri.word_table)
        logger.info("%s dev WER %.2f%% at %s", tag, dev_wer, pt)
        test_lats = nnet_decode(vol_te, am, ps)
        hyps = {}
        for utt, lat in test_lats.items():
            _, wids, _ = shortest_path(lat, 1.0, pt[0], pt[1])
            hyps[utt] = [tri.word_table.sym(int(w)) for w in wids]
        res = wer_details(test.transcripts, hyps)
        res["dev_wer"] = dev_wer
        logger.info("%s test WER %.2f%% (%d err / %d words)",
                    tag, res["wer"], res["errors"], res["words"])
        return res

    def _valid_lp(netx, ps):
        n = min(len(egs_valid), 4096)
        return float(netx.objf(ps, jnp.asarray(egs_valid.x[:n]),
                               jnp.asarray(egs_valid.y[:n])))

    timer.reset()
    result = decode_and_score(am_nnet, params, "WSJ-CNN")
    result["valid_logprob"] = _valid_lp(net, params)
    decode_t = timer.elapsed()
    audio_s = sum(v.shape[0] for v in vol_te.values()) / 100.0
    result.update(train_audio_ss=frames / 100.0 / train_t)

    if eval_dnn:
        # matched-size p-norm DNN on the SAME egs — the ledger's
        # CNN-vs-DNN delta (ref: the fork's convnet-vs-pnorm RESULTS
        # comparison on identical features/alignments)
        from kaldi_cnn_tpu.models.factory import (
            PnormDnnConfig, make_pnorm_dnn)
        dnn = make_pnorm_dnn(PnormDnnConfig(
            input_dim=egs_train.x.shape[1], num_hidden_layers=2,
            pnorm_input_dim=1000, pnorm_output_dim=200,
            num_pdfs=num_pdfs))
        dnn_params = sr.stage("dnn_train", lambda: jax.device_get(
            train_nnet(dnn, egs_train, egs_valid,
                       TrainConfig(num_epochs=nnet_epochs,
                                   minibatch_size=256,
                                   initial_learning_rate=0.08,
                                   final_learning_rate=0.008,
                                   seed=seed))[0]))
        dnn_am = AmNnet(dnn, num_pdfs)
        dnn_am.set_priors_from_counts(
            np.bincount(egs_train.y, minlength=num_pdfs))
        dres = decode_and_score(dnn_am, dnn_params, "WSJ-DNN")
        result.update(dnn_wer=dres["wer"], dnn_dev_wer=dres["dev_wer"],
                      dnn_errors=dres["errors"],
                      dnn_valid_logprob=_valid_lp(dnn, dnn_params))
        # matched-pairs significance of the CNN-vs-DNN delta on the
        # shared test set (ref: sclite sig-test discipline on the
        # egs/*/RESULTS comparisons)
        from kaldi_cnn_tpu.decode.score import paired_sign_test
        sig = paired_sign_test(result["per_utt"], dres["per_utt"])
        result.update(cnn_better_utts=sig["a_better"],
                      dnn_better_utts=sig["b_better"],
                      cnn_vs_dnn_p=sig["p_value"])
        logger.info(
            "CNN vs DNN matched pairs: CNN better on %d utts, DNN on "
            "%d, two-sided sign-test p=%.4f", sig["a_better"],
            sig["b_better"], sig["p_value"])
    if metrics:
        metrics.write("wsj_cnn_result",
                      **{k: v for k, v in result.items()
                         if not isinstance(v, dict)})
    return result


if __name__ == "__main__":
    import argparse
    from kaldi_cnn_tpu.core.backend import setup_compile_cache
    setup_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", default=None,
                    help="Kaldi data dir (wav.scp/text/utt2spk); "
                         "default: synthetic corpus")
    ap.add_argument("--lexicon", default=None)
    ap.add_argument("--ali-ark", default=None,
                    help="external transition-id alignments ark")
    ap.add_argument("--ali-mdl", default=None,
                    help=".mdl that produced --ali-ark (its transition "
                         "model maps the ark's tids to pdfs)")
    ap.add_argument("--exp-dir", default=None,
                    help="experiment dir for per-stage artifacts "
                         "(enables --stage resume)")
    ap.add_argument("--eval-utts", type=int, default=0,
                    help="dedicated eval corpus size (ledger runs: 600)")
    ap.add_argument("--eval-dnn", action="store_true",
                    help="also train/decode the matched p-norm DNN")
    ap.add_argument("--stage", default="0",
                    help="resume from this stage index; 'auto' resumes "
                         "after the last completed stage")
    a = ap.parse_args()
    corpus = None
    if a.data_dir:
        from kaldi_cnn_tpu.recipes.datadir import corpus_from_data_dir
        corpus = corpus_from_data_dir(a.data_dir, a.lexicon)
    ext = None
    if a.ali_ark:
        from kaldi_cnn_tpu.recipes.datadir import load_alignments_ark
        ext = load_alignments_ark(a.ali_ark)
    stage = 0
    if a.exp_dir:
        from kaldi_cnn_tpu.core.stages import auto_stage
        stage = (auto_stage(a.exp_dir) if a.stage == "auto"
                 else int(a.stage))
    res = run(corpus=corpus, ext_alignments=ext,
              ext_ali_mdl=a.ali_mdl, exp_dir=a.exp_dir, stage=stage,
              eval_utts=a.eval_utts, eval_dnn=a.eval_dnn)
    import sys
    sys.exit(0 if res["wer"] < 10.0 else 1)

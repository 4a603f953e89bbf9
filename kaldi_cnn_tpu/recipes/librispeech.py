"""The Librispeech-960h-style configuration: CNN acoustic model trained
data-parallel over a device mesh with periodic model averaging
(ref: BASELINE.json config "Librispeech 960h CNN, multi-host
data-parallel + model averaging"; upstream egs/librispeech/s5 driven
through queue.pl — here the parallel/multihost driver).

This recipe is the scaling configuration: same pipeline as recipes/wsj
but the train step runs over a jax.sharding.Mesh (all local devices, or
the virtual 8-device CPU mesh in tests), with utterance-list sharding
per host and optional reference-semantics averaging cadence.

Run: ``python -m kaldi_cnn_tpu.recipes.librispeech``
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
from kaldi_cnn_tpu.lang.arpa import make_unigram_arpa
from kaldi_cnn_tpu.lang.hclg import Lang, make_hclg_from_arpa
from kaldi_cnn_tpu.parallel.multihost import (
    MultihostConfig, initialize, shard_utterances, train_multihost)
from kaldi_cnn_tpu.recipes import synthetic
from kaldi_cnn_tpu.recipes.rm import score_sweep
from kaldi_cnn_tpu.recipes.wsj import (
    compute_fbank_volumes, make_cnn_egs, splice_volume)
from kaldi_cnn_tpu.recipes.yesno import compute_features

logger = get_logger(__name__)


def run(
    num_utts: int = 200,
    seed: int = 53,
    nnet_epochs: int = 25,
    num_filters: int = 48,
    average_every: int = 0,
    mh: Optional[MultihostConfig] = None,
    metrics: Optional[MetricsWriter] = None,
    corpus=None,
    egs_dir: Optional[str] = None,
    exp_dir: Optional[str] = None,
    stage: int = 0,
    eval_utts: int = 0,
) -> Dict:
    """egs_dir: directory for the on-disk sharded egs store the
    training streams from (ref: steps/nnet2/get_egs.sh — at 960h the
    spliced egs cannot live in RAM); a temp dir when not given.
    exp_dir/stage: stage-guarded execution (ref: --stage resume,
    SURVEY.md §5.3) — see recipes/wsj.py.  eval_utts > 0: dev/test
    come from a dedicated eval corpus of that many utterances
    (disjoint seed) while the whole main corpus trains — the
    statistically-sized ledger configuration (see wsj.py)."""
    import jax
    from kaldi_cnn_tpu.core.stages import make_runner
    from kaldi_cnn_tpu.models.factory import ConvnetConfig, make_convnet
    from kaldi_cnn_tpu.models.nnet import AmNnet
    from kaldi_cnn_tpu.train.trainer import TrainConfig

    sr = make_runner(exp_dir, stage)

    mh = mh or MultihostConfig(average_every=average_every)
    mesh = initialize(mh)
    logger.info("mesh: %d devices, process %d/%d",
                len(mesh.devices.flatten()), mh.process_id,
                mh.num_processes)

    synthetic_corpus = corpus is None
    if corpus is None:
        lex = synthetic.digits_lexicon()
        wp = {w: 1.0 / len(lex.entries) for w in lex.entries}
        corpus = synthetic.make_corpus(lex, wp, num_utts, 2, 5, seed)
    else:
        lex, wp = corpus.lexicon, corpus.word_probs
    if eval_utts > 0 and synthetic_corpus:
        eval_corpus = synthetic.make_corpus(lex, wp, eval_utts, 2, 5,
                                            seed + 9001)
        dev, test = eval_corpus.split(0.5)
        train = corpus
    else:
        train, test = corpus.split(0.15)
        train, dev = train.split(0.1)

    # per-host utterance shard (ref: utils/split_data.sh)
    local_utts = set(shard_utterances(list(train.waves), mh))
    train_local = synthetic.SyntheticCorpus(
        lex, wp, {u: train.waves[u] for u in local_utts},
        {u: train.transcripts[u] for u in local_utts},
        train.sample_rate)
    logger.info("corpus: %d local train / %d dev / %d test",
                len(train_local.waves), len(dev.waves), len(test.waves))

    lang = Lang.create(lex)
    timer = Timer()

    def _bootstrap():
        mfcc = compute_features(train_local, seed=seed)
        am0, ali0 = train_mono(
            mfcc, train_local.transcripts, lang,
            MonoTrainOptions(num_iters=18, totgauss=300))
        return train_deltas(
            mfcc, train_local.transcripts, lang, ali0, lang.trans_model,
            DeltasTrainOptions(num_iters=12, totgauss=800,
                               max_leaves=300))

    am1, ali1, tri = sr.stage("gmm_bootstrap", _bootstrap)
    logger.info("GMM bootstrap in %.1fs", timer.elapsed())

    num_bins, left, right = 36, 5, 5
    vol_tr = compute_fbank_volumes(train_local, num_bins, seed)
    vol_dev = compute_fbank_volumes(dev, num_bins, seed + 1)
    vol_te = compute_fbank_volumes(test, num_bins, seed + 2)
    tid2pdf = tri.trans_model.trans_id_to_pdf_array()
    num_pdfs = tri.trans_model.num_pdfs
    # streaming sharded egs (the scalable path): held-out utterances
    # form the in-memory validation set, everything else streams from
    # disk shards during training
    import tempfile
    from kaldi_cnn_tpu.recipes.wsj import write_cnn_egs_sharded
    from kaldi_cnn_tpu.train.sharded_egs import StreamingEgsBatcher
    egs_dir = egs_dir or tempfile.mkdtemp(prefix="kct_egs_")
    usable = sorted(u for u in vol_tr if u in ali1
                    and len(ali1[u]) == vol_tr[u].shape[0])
    n_valid_utts = max(len(usable) // 20, 2)
    valid_utts = set(usable[:n_valid_utts])
    store = sr.stage("egs_store", lambda: write_cnn_egs_sharded(
        egs_dir, {u: vol_tr[u] for u in usable if u not in valid_utts},
        ali1, tid2pdf, left, right, num_shards=8, seed=seed))
    egs_valid = make_cnn_egs({u: vol_tr[u] for u in valid_utts}, ali1,
                             tid2pdf, left, right, seed)
    logger.info("egs: %d train (streamed from %d shards in %s) / "
                "%d valid", len(store), store.num_shards, egs_dir,
                len(egs_valid))

    cfg = ConvnetConfig(
        in_t=left + 1 + right, in_f=num_bins, in_c=3,
        filt_t=4, filt_f=7, num_filters=num_filters,
        pool_t=2, pool_f=3, pool_c=1,
        num_hidden_layers=2, pnorm_input_dim=800, pnorm_output_dim=160,
        num_pdfs=num_pdfs)
    net = make_convnet(cfg)
    timer.reset()
    tcfg = TrainConfig(num_epochs=nnet_epochs, minibatch_size=256,
                       initial_learning_rate=0.08,
                       final_learning_rate=0.008, seed=seed)
    params, _ = train_multihost(
        net, None, egs_valid, tcfg, mh, mesh=mesh, metrics=metrics,
        batcher=StreamingEgsBatcher(store, tcfg.minibatch_size, seed))
    train_t = timer.elapsed()
    frames = nnet_epochs * len(store)
    logger.info("CNN trained in %.1fs over the mesh (%.0f audio-s/s)",
                train_t, frames / 100.0 / train_t)
    am_nnet = AmNnet(net, num_pdfs)
    # pdf priors from the label counts across the on-disk shards
    counts = np.zeros(num_pdfs, np.int64)
    for i in range(store.num_shards):
        _, ys, _ = store.load_shard(i)
        counts += np.bincount(ys, minlength=num_pdfs)
    am_nnet.set_priors_from_counts(counts)

    hclg = CompiledGraph(make_hclg_from_arpa(tri, make_unigram_arpa(wp)),
                         tid2pdf)

    def nnet_decode(vols):
        # production path: batched on-device top-K lattice decode,
        # utterance batch sharded over the mesh's data axis (decoder-state
        # parallelism)
        from kaldi_cnn_tpu.decode.topk_decoder import decode_utterances
        lls = am_nnet.loglikes_batch(
            params, {utt: splice_volume(v, left, right)
                     for utt, v in vols.items()})
        return decode_utterances(hclg, lls, acoustic_scale=0.1,
                                 beam=60.0, lattice_beam=8.0,
                                 max_active=2000,
                                 lattice_arcs_per_frame=None,
                                 batch_size=max(
                                     8, len(mesh.devices.flatten())),
                                 mesh=mesh)

    dev_wer, pt, _ = score_sweep(nnet_decode(vol_dev), dev.transcripts,
                                 tri.word_table)
    logger.info("dev WER %.2f%% at %s", dev_wer, pt)
    hyps = {}
    for utt, lat in nnet_decode(vol_te).items():
        _, wids, _ = shortest_path(lat, 1.0, pt[0], pt[1])
        hyps[utt] = [tri.word_table.sym(int(w)) for w in wids]
    result = wer_details(test.transcripts, hyps)
    result.update(dev_wer=dev_wer,
                  train_audio_ss=frames / 100.0 / train_t,
                  num_devices=len(mesh.devices.flatten()))
    logger.info("librispeech-style test WER %.2f%% (%d err / %d words)",
                result["wer"], result["errors"], result["words"])
    if metrics:
        metrics.write("librispeech_result",
                      **{k: v for k, v in result.items()
                         if not isinstance(v, dict)})
    return result


if __name__ == "__main__":
    import sys
    from kaldi_cnn_tpu.core.backend import setup_compile_cache
    setup_compile_cache()
    res = run()
    sys.exit(0 if res["wer"] < 15.0 else 1)

"""The yesno recipe: the minimum end-to-end slice (SURVEY.md §7
milestone 1; ref: egs/yesno/s5/run.sh).

wave -> MFCC+deltas -> flat-start mono GMM EM -> HCLG (unigram LM) ->
Viterbi decode -> WER.  Expected WER: 0.0 like the reference's yesno.

Run: ``python -m kaldi_cnn_tpu.recipes.yesno``
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import numpy as np

from kaldi_cnn_tpu.core.logging import MetricsWriter, Timer, get_logger
from kaldi_cnn_tpu.core.rng import stage_key
from kaldi_cnn_tpu.decode.decoder import viterbi_decode
from kaldi_cnn_tpu.decode.graph import CompiledGraph
from kaldi_cnn_tpu.decode.score import wer_details
from kaldi_cnn_tpu.features import functional as F
from kaldi_cnn_tpu.gmm.train import MonoTrainOptions, train_mono
from kaldi_cnn_tpu.lang.arpa import make_unigram_arpa
from kaldi_cnn_tpu.lang.hclg import Lang, make_hclg_from_arpa
from kaldi_cnn_tpu.recipes import synthetic

logger = get_logger(__name__)


def compute_features(corpus, seed: int = 0,
                     device: Optional[str] = None
                     ) -> Dict[str, np.ndarray]:
    """MFCC + deltas per utterance (ref: steps/make_mfcc.sh +
    add-deltas in train_mono).  Extraction is bucketed+jitted on the
    default device; ``device='cpu'`` pins it to the host."""
    from kaldi_cnn_tpu.features.extractor import FeatureExtractor
    opts = F.MfccOptions()
    opts.frame_opts.samp_freq = float(corpus.sample_rate)
    opts.frame_opts.dither = 1.0
    ex = FeatureExtractor("mfcc", opts, bucket_seconds=1.0,
                          device=device, deltas_order=2)
    return ex.extract_corpus(corpus.waves, stage_key(seed, "mfcc_dither"))


def run(
    num_utts: int = 100,
    num_iters: int = 25,
    totgauss: int = 400,
    seed: int = 17,
    metrics: Optional[MetricsWriter] = None,
    corpus=None,
) -> Dict:
    if corpus is None:
        lex = synthetic.yesno_lexicon()
        word_probs = {"yes": 0.5, "no": 0.5}
        corpus = synthetic.make_corpus(lex, word_probs, num_utts, 1, 3,
                                       seed)
    else:
        lex, word_probs = corpus.lexicon, corpus.word_probs
    traindev, test = corpus.split(0.25)
    train, dev = traindev.split(0.2)
    logger.info("corpus: %d train / %d dev / %d test utts",
                len(train.waves), len(dev.waves), len(test.waves))

    timer = Timer()
    train_feats = compute_features(train, seed)
    dev_feats = compute_features(dev, seed + 2)
    test_feats = compute_features(test, seed + 1)
    logger.info("features in %.1fs", timer.elapsed())

    lang = Lang.create(lex)
    opts = MonoTrainOptions(num_iters=num_iters, totgauss=totgauss)
    timer.reset()
    am, _ = train_mono(train_feats, train.transcripts, lang, opts)
    logger.info("mono training in %.1fs", timer.elapsed())

    arpa = make_unigram_arpa(word_probs)
    hclg = CompiledGraph(make_hclg_from_arpa(lang, arpa),
                         lang.trans_model.trans_id_to_pdf_array())

    def decode_set(feats, scale, wip):
        hyps = {}
        for utt, f in feats.items():
            ll = am.loglikes(f)
            # wide beam: the synthetic tones have a much larger per-frame
            # loglike dynamic range than real speech, so Kaldi's beam=16
            # would prune the correct path at word boundaries
            _, word_ids, _ = viterbi_decode(
                hclg, ll, acoustic_scale=scale, beam=np.inf, max_active=0,
                word_ins_penalty=wip)
            hyps[utt] = [lang.word_table.sym(w) for w in word_ids]
        return hyps

    # tune acoustic scale + word insertion penalty on dev
    # (ref: local/score.sh LM-weight/WIP sweep)
    best = (0.1, 0.0)
    best_wer = np.inf
    for scale in (0.05, 0.1, 0.2, 0.5):
        for wip in (-1.0, -0.5, 0.0, 0.5):
            r = wer_details(dev.transcripts, decode_set(dev_feats, scale, wip))
            if r["wer"] < best_wer:
                best_wer, best = r["wer"], (scale, wip)
    logger.info("dev sweep: best scale=%.2f wip=%.1f (dev WER %.2f%%)",
                best[0], best[1], best_wer)

    timer.reset()
    hyps = decode_set(test_feats, *best)
    decode_t = timer.elapsed()
    result = wer_details(test.transcripts, hyps)
    audio_s = sum(len(w) for w in test.waves.values()) / corpus.sample_rate
    result["decode_rtf"] = decode_t / audio_s
    logger.info("yesno WER: %.2f%% (%d err / %d words), decode RTF %.3f",
                result["wer"], result["errors"], result["words"],
                result["decode_rtf"])
    if metrics:
        metrics.write("yesno_wer",
                      **{k: v for k, v in result.items()
                         if not isinstance(v, dict)})
    return result


if __name__ == "__main__":
    import argparse
    import sys
    from kaldi_cnn_tpu.core.backend import setup_compile_cache
    setup_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--lexicon", default=None)
    a = ap.parse_args()
    corpus = None
    if a.data_dir:
        from kaldi_cnn_tpu.recipes.datadir import corpus_from_data_dir
        corpus = corpus_from_data_dir(a.data_dir, a.lexicon)
    res = run(corpus=corpus)
    sys.exit(0 if res["wer"] == 0.0 else 1)

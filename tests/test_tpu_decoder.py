"""Batched dense device decoder (TpuViterbiDecoder) vs host decoder
oracle tests (the CPU-vs-GPU oracle pattern of SURVEY.md §4:
cudamatrix/cu-*-test.cc)."""

import numpy as np
import pytest

from kaldi_cnn_tpu.decode.decoder import viterbi_decode
from kaldi_cnn_tpu.decode.graph import CompiledGraph
from kaldi_cnn_tpu.decode.tpu_decoder import TpuViterbiDecoder
from kaldi_cnn_tpu.lang.arpa import make_unigram_arpa
from kaldi_cnn_tpu.lang.hclg import Lang, make_hclg_from_arpa
from kaldi_cnn_tpu.recipes import synthetic
from kaldi_cnn_tpu.recipes.yesno import compute_features


@pytest.fixture(scope="module")
def setup():
    from kaldi_cnn_tpu.gmm.train import MonoTrainOptions, train_mono
    lex = synthetic.digits_lexicon()
    wp = {w: 0.1 for w in lex.entries}
    corpus = synthetic.make_corpus(lex, wp, 24, 1, 3, 23)
    feats = compute_features(corpus, seed=23)
    lang = Lang.create(lex)
    am, _ = train_mono(feats, corpus.transcripts, lang,
                       MonoTrainOptions(num_iters=8, totgauss=150))
    hclg = CompiledGraph(make_hclg_from_arpa(lang, make_unigram_arpa(wp)),
                         lang.trans_model.trans_id_to_pdf_array())
    lls = [am.loglikes(feats[u]) for u in sorted(feats)[:8]]
    return hclg, lls


def test_tpu_matches_host_viterbi(setup):
    hclg, lls = setup
    scale = 0.1
    dec = TpuViterbiDecoder(hclg, beam=1e9, max_active=0,
                            acoustic_scale=scale)
    results = dec.decode_batch(lls)
    for ll, (tids, words, cost) in zip(lls, results):
        tids_h, words_h, cost_h = viterbi_decode(
            hclg, ll, acoustic_scale=scale, beam=np.inf, max_active=0)
        assert list(words) == list(words_h)
        assert len(tids) == len(tids_h) == ll.shape[0]
        assert cost == pytest.approx(cost_h, rel=1e-5, abs=1e-2)


def test_tpu_decoder_beam_pruning_still_correct(setup):
    """With a generous-but-finite beam the best path must survive."""
    hclg, lls = setup
    scale = 0.1
    dec = TpuViterbiDecoder(hclg, beam=200.0, max_active=0,
                            acoustic_scale=scale)
    results = dec.decode_batch(lls[:4])
    for ll, (tids, words, cost) in zip(lls[:4], results):
        _, words_h, cost_h = viterbi_decode(
            hclg, ll, acoustic_scale=scale, beam=np.inf, max_active=0)
        assert list(words) == list(words_h)
        assert cost == pytest.approx(cost_h, rel=1e-5, abs=1e-2)


def test_tpu_decoder_variable_lengths(setup):
    """Padded batch must give identical results to singleton batches."""
    hclg, lls = setup
    scale = 0.1
    dec = TpuViterbiDecoder(hclg, beam=1e9, acoustic_scale=scale)
    batched = dec.decode_batch(lls[:5])
    for ll, (tids, words, cost) in zip(lls[:5], batched):
        solo = dec.decode_batch([ll])[0]
        assert list(words) == list(solo[1])
        assert cost == pytest.approx(solo[2], rel=1e-6)

"""Online pipeline tests: streaming == offline equivalence (the key
invariant of src/feat/online-feature-test.cc) + incremental decoding
and endpointing."""

import numpy as np
import pytest

from kaldi_cnn_tpu.features import functional as F
from kaldi_cnn_tpu.online2 import (
    EndpointConfig, EndpointRule, OnlineBaseFeature, OnlineCmvn,
    OnlineFeaturePipeline, SingleUtteranceDecoder)


def test_streaming_base_features_match_offline(rng):
    wave = (rng.normal(size=8000) * 1000).astype(np.float32)
    opts = F.MfccOptions()
    opts.frame_opts.samp_freq = 8000.0
    opts.frame_opts.dither = 0.0
    online = OnlineBaseFeature("mfcc", opts)
    for i in range(0, len(wave), 1000):
        online.accept_waveform(wave[i:i + 1000])
    online.finish()
    offline = np.asarray(F.compute_mfcc(wave, opts))
    got = online.get_frames(0, online.num_frames_ready())
    assert got.shape == offline.shape
    assert np.allclose(got, offline, atol=1e-3)


def test_streaming_chunk_size_invariance(rng):
    wave = (rng.normal(size=6400) * 500).astype(np.float32)
    opts = F.FbankOptions()
    opts.frame_opts.samp_freq = 8000.0
    opts.frame_opts.dither = 0.0

    def run(chunk):
        ob = OnlineBaseFeature("fbank", opts)
        for i in range(0, len(wave), chunk):
            ob.accept_waveform(wave[i:i + chunk])
        ob.finish()
        return ob.get_frames(0, ob.num_frames_ready())

    a, b = run(160), run(2048)
    assert a.shape == b.shape
    assert np.allclose(a, b, atol=1e-4)


def test_online_cmvn_causal(rng):
    x = rng.normal(size=(300, 5)).astype(np.float32) + 7.0
    cm = OnlineCmvn()
    y = cm.apply(x)
    # later frames approach zero mean
    assert np.abs(y[200:].mean(axis=0)).max() < 0.5
    # causality: normalizing a prefix gives the same prefix
    y2 = cm.apply(x[:100])
    assert np.allclose(y[:100], y2, atol=1e-5)


def test_pipeline_right_context_lag(rng):
    wave = (rng.normal(size=4000) * 300).astype(np.float32)
    opts = F.MfccOptions()
    opts.frame_opts.samp_freq = 8000.0
    pipe = OnlineFeaturePipeline("mfcc", opts, deltas_order=2)
    pipe.accept_waveform(wave)
    ready = pipe.num_frames_ready()
    base_ready = pipe.base.num_frames_ready()
    assert ready == base_ready - pipe.right_context
    pipe.finish()
    assert pipe.num_frames_ready() == base_ready
    f = pipe.get_frames(0, ready)
    assert f.shape[0] == ready and f.shape[1] == 13 * 3


@pytest.fixture(scope="module")
def decode_setup():
    from kaldi_cnn_tpu.decode.graph import CompiledGraph
    from kaldi_cnn_tpu.gmm.train import MonoTrainOptions, train_mono
    from kaldi_cnn_tpu.lang.arpa import make_unigram_arpa
    from kaldi_cnn_tpu.lang.hclg import Lang, make_hclg_from_arpa
    from kaldi_cnn_tpu.recipes import synthetic
    from kaldi_cnn_tpu.recipes.yesno import compute_features
    lex = synthetic.yesno_lexicon()
    wp = {"yes": 0.5, "no": 0.5}
    corpus = synthetic.make_corpus(lex, wp, 16, 1, 2, 31)
    feats = compute_features(corpus, seed=31)
    lang = Lang.create(lex)
    am, _ = train_mono(feats, corpus.transcripts, lang,
                       MonoTrainOptions(num_iters=8, totgauss=80))
    hclg = CompiledGraph(make_hclg_from_arpa(lang, make_unigram_arpa(wp)),
                         lang.trans_model.trans_id_to_pdf_array())
    return corpus, feats, lang, am, hclg


def test_incremental_decode_matches_batch(decode_setup):
    from kaldi_cnn_tpu.decode.decoder import viterbi_decode
    corpus, feats, lang, am, hclg = decode_setup
    utt = next(iter(feats))
    ll = am.loglikes(feats[utt])
    dec = SingleUtteranceDecoder(hclg, acoustic_scale=0.1, beam=np.inf,
                                 max_active=0)
    for i in range(0, ll.shape[0], 17):
        dec.advance(ll[i:i + 17])
    tids, words, cost = dec.best_path()
    tids_b, words_b, cost_b = viterbi_decode(hclg, ll,
                                             acoustic_scale=0.1,
                                             beam=np.inf, max_active=0)
    assert list(words) == list(words_b)
    assert cost == pytest.approx(cost_b, abs=1e-2)


def test_endpointing_on_trailing_silence(decode_setup):
    corpus, feats, lang, am, hclg = decode_setup
    tm = lang.trans_model
    sil = lang.phone_table.id("SIL")
    utt = next(iter(feats))
    ll = am.loglikes(feats[utt])
    # synthesize strong trailing silence: repeat the utterance's best
    # silence frame for 1.5 s
    sil_pdfs = [tm.id_to_pdf(t) for t in range(1, tm.num_transition_ids + 1)
                if tm.id_to_phone(t) == sil]
    sil_frame = np.full((1, ll.shape[1]), -30.0, np.float32)
    sil_frame[0, sil_pdfs] = 0.0
    extended = np.concatenate([ll, np.repeat(sil_frame, 150, axis=0)])
    dec = SingleUtteranceDecoder(hclg, acoustic_scale=0.1, beam=np.inf,
                                 max_active=0)
    cfg = EndpointConfig(rule_trailing=EndpointRule(
        min_trailing_silence_sec=0.5, max_relative_cost=1e9))
    dec.advance(ll)
    assert not dec.endpoint_detected(tm, sil, cfg)
    dec.advance(extended[ll.shape[0]:])
    assert dec.trailing_silence_frames(tm, sil) >= 100
    assert dec.endpoint_detected(tm, sil, cfg)


def test_online_recognizer_matches_offline(decode_setup):
    """Streaming wav chunks through the full recognizer must produce
    the same words as the offline decode (ref: online2-wav-...-latgen
    vs offline latgen equivalence)."""
    from kaldi_cnn_tpu.features import functional as F
    from kaldi_cnn_tpu.decode.decoder import viterbi_decode
    from kaldi_cnn_tpu.online2 import OnlineFeaturePipeline, OnlineRecognizer
    corpus, feats, lang, am, hclg = decode_setup
    utt = next(iter(corpus.waves))
    wave = corpus.waves[utt]
    opts = F.MfccOptions()
    opts.frame_opts.samp_freq = float(corpus.sample_rate)
    pipe = OnlineFeaturePipeline("mfcc", opts, deltas_order=2)
    # offline comparison uses the same (no-dither, online-CMVN) features
    rec = OnlineRecognizer(hclg, lambda f: am.loglikes(f),
                           pipeline=pipe, acoustic_scale=0.1,
                           beam=np.inf, max_active=0)
    for i in range(0, len(wave), 1600):
        rec.accept_waveform(wave[i:i + 1600])
    rec.input_finished()
    tids, words, cost = rec.result()
    # offline: same feature pipeline, batch decode
    pipe2 = OnlineFeaturePipeline("mfcc", opts, deltas_order=2)
    pipe2.accept_waveform(wave)
    pipe2.finish()
    full = pipe2.get_frames(0, pipe2.num_frames_ready())
    tids_o, words_o, cost_o = viterbi_decode(
        hclg, am.loglikes(full), acoustic_scale=0.1, beam=np.inf,
        max_active=0)
    assert list(words) == list(words_o)
    assert cost == pytest.approx(cost_o, abs=1e-2)
    assert len(tids) == len(tids_o)


def test_tpu_streaming_decoder_matches_offline_batch(decode_setup):
    """VERDICT round-2 item 8 'done' bar: chunked on-device decode (token
    state carried across chunk boundaries) produces identical words —
    and identical costs — to offline decode_batch of the same rows."""
    from kaldi_cnn_tpu.decode.topk_decoder import (
        TpuStreamingDecoder, TpuTopKDecoder)
    corpus, feats, lang, am, hclg = decode_setup
    dec = TpuTopKDecoder(hclg, beam=1e8, max_active=hclg.num_states + 32,
                         acoustic_scale=0.1)
    for n, utt in enumerate(sorted(feats)[:3]):
        ll = am.loglikes(feats[utt])
        ((tids_o, words_o, cost_o),) = dec.decode_batch([ll])
        stream = TpuStreamingDecoder(dec)
        chunk = 7 + 3 * n  # vary chunk size across utterances
        for i in range(0, ll.shape[0], chunk):
            stream.advance(ll[i:i + chunk])
            # partial results must be readable mid-stream
            stream.best_path(use_final=False)
        stream.finalize()
        tids, words, cost = stream.best_path()
        assert list(words) == list(words_o)
        assert list(tids) == list(tids_o)
        assert cost == pytest.approx(cost_o, abs=1e-2)


def test_online_recognizer_with_tpu_decoder(decode_setup):
    """The streaming recognizer running on the device decoder produces the
    same words as offline decode of the same audio."""
    from kaldi_cnn_tpu.decode.decoder import viterbi_decode
    from kaldi_cnn_tpu.decode.topk_decoder import (
        TpuStreamingDecoder, TpuTopKDecoder)
    from kaldi_cnn_tpu.features import functional as F
    from kaldi_cnn_tpu.online2 import (
        OnlineFeaturePipeline, OnlineRecognizer)
    corpus, feats, lang, am, hclg = decode_setup
    utt = next(iter(corpus.waves))
    wave = corpus.waves[utt]
    opts = F.MfccOptions()
    opts.frame_opts.samp_freq = float(corpus.sample_rate)
    pipe = OnlineFeaturePipeline("mfcc", opts, deltas_order=2)
    tdec = TpuTopKDecoder(hclg, beam=1e8,
                          max_active=hclg.num_states + 32,
                          acoustic_scale=0.1)
    rec = OnlineRecognizer(hclg, lambda f: am.loglikes(f),
                           pipeline=pipe,
                           decoder=TpuStreamingDecoder(tdec))
    for i in range(0, len(wave), 1600):
        rec.accept_waveform(wave[i:i + 1600])
    rec.input_finished()
    tids, words, cost = rec.result()
    pipe2 = OnlineFeaturePipeline("mfcc", opts, deltas_order=2)
    pipe2.accept_waveform(wave)
    pipe2.finish()
    full = pipe2.get_frames(0, pipe2.num_frames_ready())
    _, words_o, cost_o = viterbi_decode(
        hclg, am.loglikes(full), acoustic_scale=0.1, beam=np.inf,
        max_active=0)
    assert list(words) == list(words_o)
    assert cost == pytest.approx(cost_o, abs=1e-2)


def test_tpu_streaming_decoder_bounded_long_stream(decode_setup):
    """Round-3 VERDICT item 6 'done' bar: a long (>=60 s) stream keeps
    the streaming decoder's host state bounded — the traceback window
    commits converged prefixes and drops history — while endpoint-style
    polling (best_path per chunk) walks only the window, and the final
    result still exactly matches offline decode of the same rows."""
    from kaldi_cnn_tpu.decode.topk_decoder import (
        TpuStreamingDecoder, TpuTopKDecoder)
    corpus, feats, lang, am, hclg = decode_setup
    # 60+ seconds of audio: loop real utterance loglikes end to end
    rows = np.concatenate(
        [am.loglikes(feats[u]) for u in sorted(feats)] * 6)
    rows = rows[:6100]
    assert rows.shape[0] * 0.01 >= 60.0
    # a REAL pruning beam: commits rely on beam pruning killing losing
    # token families so live paths converge (an infinite beam keeps
    # every state alive forever, and nothing can ever provably commit)
    dec = TpuTopKDecoder(hclg, beam=30.0, max_active=hclg.num_states + 32,
                         acoustic_scale=0.1)
    stream = TpuStreamingDecoder(dec, commit_every=16)
    max_window = 0
    chunk = 25
    for i in range(0, rows.shape[0], chunk):
        stream.advance(rows[i:i + chunk])
        stream.best_path(use_final=False)     # endpoint-style polling
        max_window = max(max_window, len(stream._buf))
    stream.finalize()
    tids, words, cost = stream.best_path()
    # the window stayed a small constant fraction of the stream
    assert max_window <= 8 * stream.commit_every, max_window
    assert len(stream._buf) <= 8 * stream.commit_every
    # committed prefix did the work: most of the stream was dropped
    assert len(stream._ctids) >= 0.9 * len(tids)
    ((tids_o, words_o, cost_o),) = dec.decode_batch([rows])
    assert list(words) == list(words_o)
    assert list(tids) == list(tids_o)
    assert cost == pytest.approx(cost_o, rel=1e-5)

"""Top-K on-device beam decoder vs host decoder oracle tests (the CPU-vs-GPU
oracle pattern of SURVEY.md §4), plus graph-scale tests the dense
decoder cannot pass."""

import numpy as np
import pytest

from kaldi_cnn_tpu.decode.biggraph import make_big_graph, sample_loglikes
from kaldi_cnn_tpu.decode.decoder import lattice_decode, viterbi_decode
from kaldi_cnn_tpu.decode.graph import CompiledGraph
from kaldi_cnn_tpu.decode.lattice import shortest_path
from kaldi_cnn_tpu.decode.topk_decoder import TopKGraph, TpuTopKDecoder
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
    lls = [am.loglikes(feats[u]) for u in sorted(feats)[:6]]
    return hclg, lls


def test_topk_graph_bounds_degree(setup):
    hclg, _ = setup
    tg = TopKGraph(hclg, max_emit=4, max_eps=3)
    assert tg.max_emit_deg <= 4
    assert tg.max_eps_deg <= 3
    # arc multiset preserved (labels + weights)
    assert sorted(tg.e_ilabel.tolist()) == sorted(hclg.e_ilabel.tolist())
    assert np.isclose(np.sort(tg.e_w), np.sort(hclg.e_weight)).all()
    # original eps arcs preserved; extra link arcs are free + unlabeled
    extra = tg.num_eps_arcs - hclg.num_eps_arcs
    assert extra >= 0
    assert np.isclose(tg.n_w.sum(), hclg.n_weight.sum(), atol=1e-4)
    assert tg.n_olabel.sum() == hclg.n_olabel.sum()


def test_topk_matches_host_viterbi_exact(setup):
    """K >= reachable states, huge beam: must be exact Viterbi."""
    hclg, lls = setup
    scale = 0.1
    dec = TpuTopKDecoder(hclg, beam=1e8, max_active=hclg.num_states + 32,
                         acoustic_scale=scale)
    results = dec.decode_batch(lls)
    for ll, (tids, words, cost) in zip(lls, results):
        tids_h, words_h, cost_h = viterbi_decode(
            hclg, ll, acoustic_scale=scale, beam=np.inf, max_active=0)
        assert list(words) == list(words_h)
        assert len(tids) == len(tids_h) == ll.shape[0]
        assert cost == pytest.approx(cost_h, rel=1e-5, abs=1e-2)


def test_topk_matches_host_viterbi_pruned(setup):
    """Tight-ish top-K with generous beam still finds the best path on
    this graph (the best path's states dominate)."""
    hclg, lls = setup
    scale = 0.1
    dec = TpuTopKDecoder(hclg, beam=200.0, max_active=48,
                         acoustic_scale=scale)
    results = dec.decode_batch(lls[:4])
    for ll, (tids, words, cost) in zip(lls[:4], results):
        _, words_h, cost_h = viterbi_decode(
            hclg, ll, acoustic_scale=scale, beam=np.inf, max_active=0)
        assert list(words) == list(words_h)
        assert cost == pytest.approx(cost_h, rel=1e-5, abs=1e-2)


def test_topk_degree_bounding_does_not_change_result(setup):
    hclg, lls = setup
    scale = 0.1
    a = TpuTopKDecoder(hclg, beam=1e8, max_active=hclg.num_states + 32,
                       acoustic_scale=scale)
    b = TpuTopKDecoder(hclg, beam=1e8, max_active=2 * hclg.num_states,
                       acoustic_scale=scale, max_emit_deg=2, max_eps_deg=2)
    ra = a.decode_batch(lls[:3])
    rb = b.decode_batch(lls[:3])
    for (ta, wa, ca), (tb, wb, cb) in zip(ra, rb):
        assert list(wa) == list(wb)
        assert list(ta) == list(tb)
        assert ca == pytest.approx(cb, rel=1e-5, abs=1e-2)


def test_topk_lattice_matches_host_lattice(setup):
    """Device-emitted raw lattice: one-best equals the host lattice
    decoder's one-best, and a rescoring sweep tracks it too."""
    hclg, lls = setup
    scale = 0.1
    dec = TpuTopKDecoder(hclg, beam=14.0, max_active=hclg.num_states + 32,
                         acoustic_scale=scale, lattice_beam=7.0,
                         lattice_arcs_per_frame=2048)
    lats = dec.decode_batch_lattice(lls[:4])
    for ll, lat in zip(lls[:4], lats):
        lat_h = lattice_decode(hclg, ll, acoustic_scale=scale, beam=14.0,
                               lattice_beam=7.0, max_active=0)
        t, w, c = shortest_path(lat, acoustic_scale=scale)
        t_h, w_h, c_h = shortest_path(lat_h, acoustic_scale=scale)
        assert list(w) == list(w_h)
        assert c == pytest.approx(c_h, rel=1e-4, abs=5e-2)
        # rescoring sweep over acoustic scales on both lattices
        for s2 in (0.08, 0.12):
            _, w2, c2 = shortest_path(lat, acoustic_scale=s2)
            _, w2h, c2h = shortest_path(lat_h, acoustic_scale=s2)
            assert list(w2) == list(w2h)
            assert c2 == pytest.approx(c2h, rel=1e-4, abs=5e-2)


def test_topk_mesh_sharded_decode_matches_single_device(setup):
    """Decoder-state parallelism (SURVEY.md §2.2): utterance batch
    sharded over the 8-device mesh 'data' axis gives results identical
    to the single-device decode."""
    import jax
    from jax.sharding import Mesh
    hclg, lls = setup
    scale = 0.1
    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    a = TpuTopKDecoder(hclg, beam=1e8, max_active=hclg.num_states + 32,
                       acoustic_scale=scale)
    b = TpuTopKDecoder(hclg, beam=1e8, max_active=hclg.num_states + 32,
                       acoustic_scale=scale, mesh=mesh)
    ra = a.decode_batch(lls)       # 6 utts: also exercises batch padding
    rb = b.decode_batch(lls)
    for (ta, wa, ca), (tb, wb, cb) in zip(ra, rb):
        assert list(wa) == list(wb)
        assert list(ta) == list(tb)
        assert ca == pytest.approx(cb, rel=1e-5, abs=1e-2)


def test_topk_huge_graph_million_arcs():
    """VERDICT round-1 'done' bar: a >=100k-state / >=1M-arc graph
    decodes within memory and matches the host decoder's best path."""
    P = 256
    g = make_big_graph(num_words=90_000, num_pdfs=P, min_len=4,
                       max_len=8, seed=3)
    assert g.num_states >= 100_000
    assert g.num_emitting_arcs + g.num_eps_arcs >= 1_000_000
    ll = sample_loglikes(g, P, T=20, seed=5)
    # K is ~3% of the states and ~18% of the hub fan-out: survival of
    # the true path through the 90k-arc LM hub relies on the decoder's
    # acoustic-lookahead ranking (TopKGraph._build_lookahead)
    dec = TpuTopKDecoder(g, beam=60.0, max_active=16384,
                         acoustic_scale=1.0)
    ((tids, words, cost),) = dec.decode_batch([ll])
    tids_h, words_h, cost_h = viterbi_decode(
        g, ll, acoustic_scale=1.0, beam=np.inf, max_active=0)
    assert len(tids) == ll.shape[0]
    assert cost == pytest.approx(cost_h, rel=1e-4, abs=0.1)
    assert list(words) == list(words_h)


def test_topk_big_graph_scales():
    """A graph far past the dense decoder's comfort zone: the top-K
    decoder's working set is O(K), not O(states)."""
    P = 64
    g = make_big_graph(num_words=2000, num_pdfs=P, seed=1)
    assert g.num_states > 10_000
    lls = [sample_loglikes(g, P, T=40, seed=s) for s in (0, 1)]
    # peaked acoustics: the best path dominates, so beam search (device,
    # candidate-level pruning) and exact Viterbi (host) must agree
    dec = TpuTopKDecoder(g, beam=80.0, max_active=4096,
                         acoustic_scale=1.0)
    results = dec.decode_batch(lls)
    for ll, (tids, words, cost) in zip(lls, results):
        tids_h, words_h, cost_h = viterbi_decode(
            g, ll, acoustic_scale=1.0, beam=np.inf, max_active=0)
        assert len(tids) == ll.shape[0]
        assert cost == pytest.approx(cost_h, rel=1e-4, abs=0.1)
        assert list(words) == list(words_h)


def test_lattice_overflow_reported_and_autogrown(setup, caplog):
    """VERDICT round-2 item 6: a dense frame that overflows a small
    lattice buffer must be REPORTED (arcs dropped on frames), and
    auto_grow must re-run with a larger buffer until nothing is
    dropped — never a silently thinner lattice."""
    import logging
    hclg, lls = setup
    scale = 0.1
    dec = TpuTopKDecoder(hclg, beam=1e4, max_active=hclg.num_states + 32,
                         acoustic_scale=scale, lattice_beam=1e4,
                         lattice_arcs_per_frame=8)
    # no auto-grow: the overflow must be surfaced
    with caplog.at_level(logging.WARNING):
        lats_small = dec.decode_batch_lattice(
            lls[:1], determinize=False, auto_grow=False)
    dropped, frames = dec.last_overflow
    assert dropped > 0 and frames > 0
    assert any("overflow" in r.message for r in caplog.records)
    # auto-grow: buffer doubles until the drop count reaches zero
    dec2 = TpuTopKDecoder(hclg, beam=1e4,
                          max_active=hclg.num_states + 32,
                          acoustic_scale=scale, lattice_beam=1e4,
                          lattice_arcs_per_frame=8)
    lats_grown = dec2.decode_batch_lattice(
        lls[:1], determinize=False, auto_grow=True, max_grow=12)
    assert dec2.last_overflow == (0, 0)
    assert dec2.A_lat > 8
    # the grown lattice is a strict superset of the clipped one
    assert lats_grown[0].num_arcs >= lats_small[0].num_arcs


def test_decode_utterances_matches_host_wer(setup):
    """VERDICT round-2 item 1 'done' bar: the production batched entry
    point (bucketed + padded batches, determinized lattices) produces
    the same one-best words as the host lattice decoder on every
    utterance."""
    from kaldi_cnn_tpu.decode.topk_decoder import decode_utterances
    hclg, lls = setup
    scale = 0.1
    keyed = {f"utt{i:02d}": ll for i, ll in enumerate(lls)}
    lats = decode_utterances(hclg, keyed, acoustic_scale=scale,
                             beam=14.0, lattice_beam=7.0,
                             max_active=hclg.num_states + 32,
                             lattice_arcs_per_frame=2048,
                             batch_size=4, bucket_frames=32)
    assert set(lats) == set(keyed)
    for utt, ll in keyed.items():
        lat_h = lattice_decode(hclg, ll, acoustic_scale=scale,
                               beam=14.0, lattice_beam=7.0, max_active=0)
        _, w, c = shortest_path(lats[utt], acoustic_scale=scale)
        _, w_h, c_h = shortest_path(lat_h, acoustic_scale=scale)
        assert list(w) == list(w_h)
        assert c == pytest.approx(c_h, rel=1e-4, abs=5e-2)


def test_derived_lattice_sizing_no_overflow(setup):
    """lattice_arcs_per_frame=None derives the capacity from
    max_active; the derived sizing must decode without any auto-grow
    re-decode (the round-4 bench overflowed its hand-tuned 2048 three
    times before settling at 16384)."""
    hclg, lls = setup
    assert TpuTopKDecoder._derive_lattice_arcs(7000) == 16384
    assert TpuTopKDecoder._derive_lattice_arcs(2000) == 4096
    assert TpuTopKDecoder._derive_lattice_arcs(1) == 2048
    dec = TpuTopKDecoder(hclg, beam=16.0, max_active=200,
                         acoustic_scale=0.1, lattice_beam=8.0,
                         lattice_arcs_per_frame=None)
    assert dec.A_lat == TpuTopKDecoder._derive_lattice_arcs(dec.K)
    before = dec.A_lat
    lats = dec.decode_batch_lattice(lls[:2], determinize=False)
    assert dec.A_lat == before, "derived sizing still overflowed"
    assert dec.last_overflow == (0, 0)
    assert all(l.num_arcs > 0 for l in lats)

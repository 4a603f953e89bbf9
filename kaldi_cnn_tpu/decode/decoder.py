"""Host Viterbi decoder over CSR-packed graphs.

Functional equivalent of the reference's FasterDecoder
(ref: src/decoder/faster-decoder.{h,cc}: per-frame ProcessEmitting /
ProcessNonemitting token passing with beam + max-active pruning), but
vectorized: each frame relaxes ALL emitting arcs with numpy gathers and
a stable-sort group-min instead of a hash map of tokens.  Used for
forced alignment (training graphs) and as the correctness baseline for
the batched device decoders.

Backpointers form a shared trace tree (token passing): each token holds
an index into flat arrays (prev, ilabel, olabel), so best-path recovery
is a single unwind, like the reference's Token::prev_ chain.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from kaldi_cnn_tpu.decode.graph import CompiledGraph

INF = np.float32(np.inf)


class _PenalizedGraph:
    """View of a CompiledGraph with word-insertion penalty folded into
    the weights of word-emitting arcs."""

    def __init__(self, g: CompiledGraph, penalty: float):
        self.__dict__.update(g.__dict__)
        self.num_emitting_arcs = g.num_emitting_arcs
        self.num_eps_arcs = g.num_eps_arcs
        self.e_weight = g.e_weight + penalty * (g.e_olabel > 0)
        self.n_weight = g.n_weight + penalty * (g.n_olabel > 0)


class _Trace:
    def __init__(self):
        self.prev: List[int] = [-1]
        self.ilabel: List[int] = [0]
        self.olabel: List[int] = [0]

    def push(self, prev: np.ndarray, ilabel: np.ndarray,
             olabel: np.ndarray) -> np.ndarray:
        base = len(self.prev)
        self.prev.extend(prev.tolist())
        self.ilabel.extend(ilabel.tolist())
        self.olabel.extend(olabel.tolist())
        return np.arange(base, base + len(prev), dtype=np.int64)


def _group_min(dst: np.ndarray, cost: np.ndarray, n: int):
    """Per-destination min: returns (best_cost [n], argfirst index into
    the arc arrays achieving it, valid mask)."""
    order = np.argsort(cost, kind="stable")
    d_sorted = dst[order]
    uniq, first = np.unique(d_sorted, return_index=True)
    best_arc = order[first]
    out_cost = np.full(n, INF, np.float32)
    out_arc = np.full(n, -1, np.int64)
    out_cost[uniq] = cost[best_arc]
    out_arc[uniq] = best_arc
    return out_cost, out_arc


def _eps_expand(g: CompiledGraph, cost: np.ndarray, tok: np.ndarray,
                trace: _Trace, max_iters: int = 100):
    """ProcessNonemitting: relax eps arcs to fixpoint."""
    if g.num_eps_arcs == 0:
        return cost, tok
    for _ in range(max_iters):
        src_cost = cost[g.n_src]
        cand = src_cost + g.n_weight
        new_cost, best_arc = _group_min(g.n_dst, cand, g.num_states)
        improved = new_cost < cost - 1e-6
        if not improved.any():
            break
        states = np.nonzero(improved)[0]
        arcs = best_arc[states]
        new_tok = trace.push(tok[g.n_src[arcs]],
                             np.zeros(len(arcs), np.int32),
                             g.n_olabel[arcs])
        cost[states] = new_cost[states]
        tok[states] = new_tok
    return cost, tok


def _viterbi_native(g, loglikes, acoustic_scale, beam, max_active,
                    require_final, word_ins_penalty):
    """C++ fast path (kaldi_cnn_tpu.native viterbi.cc); returns None
    when the native library is unavailable."""
    import ctypes
    from kaldi_cnn_tpu import native
    lib = native.load()
    if lib is None:
        return None
    T, P = loglikes.shape
    ll = np.ascontiguousarray(loglikes, np.float32)
    out_tids = np.zeros(max(T, 1), np.int32)
    out_words = np.zeros(max(T, 1), np.int32)
    nwords = ctypes.c_int64(0)
    cost = ctypes.c_float(0.0)
    nt = lib.kct_viterbi(
        g.num_states, g.start,
        g.num_emitting_arcs, g.e_src, g.e_dst, g.e_ilabel, g.e_olabel,
        g.e_weight, g.e_pdf,
        g.num_eps_arcs, g.n_src, g.n_dst, g.n_olabel, g.n_weight,
        g.final,
        ll, T, P,
        np.float32(acoustic_scale),
        np.float32(beam if np.isfinite(beam) else np.inf),
        np.int32(max_active), np.int32(bool(require_final)),
        np.float32(word_ins_penalty),
        out_tids, out_words, ctypes.byref(nwords), ctypes.byref(cost))
    if nt < 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                float("inf"))
    return (out_tids[:nt].copy(), out_words[:nwords.value].copy(),
            float(cost.value))


def _viterbi(
    g: CompiledGraph,
    loglikes: np.ndarray,
    acoustic_scale: float = 0.1,
    beam: float = np.inf,
    max_active: int = 0,
    require_final: bool = False,
    word_ins_penalty: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """loglikes [T, num_pdfs] -> (frame alignment tids [T], olabels, cost)."""
    if type(g) is CompiledGraph:   # native path reads the raw arrays
        r = _viterbi_native(g, loglikes, acoustic_scale, beam,
                            max_active, require_final, word_ins_penalty)
        if r is not None:
            return r
    T = loglikes.shape[0]
    am_scores = -acoustic_scale * loglikes  # costs
    if word_ins_penalty != 0.0:
        # per-word additive cost (ref: local/score.sh wip sweep /
        # lattice-add-penalty); applied on word-emitting arcs
        g = _PenalizedGraph(g, word_ins_penalty)
    cost = np.full(g.num_states, INF, np.float32)
    tok = np.zeros(g.num_states, np.int64)
    trace = _Trace()
    cost[g.start] = 0.0
    cost, tok = _eps_expand(g, cost, tok, trace)

    for t in range(T):
        src_cost = cost[g.e_src]
        cand = src_cost + g.e_weight + am_scores[t, g.e_pdf]
        new_cost, best_arc = _group_min(g.e_dst, cand, g.num_states)
        valid = np.isfinite(new_cost)
        states = np.nonzero(valid)[0]
        arcs = best_arc[states]
        new_tok_states = trace.push(tok[g.e_src[arcs]], g.e_ilabel[arcs],
                                    g.e_olabel[arcs])
        cost = np.full(g.num_states, INF, np.float32)
        tok = np.zeros(g.num_states, np.int64)
        cost[states] = new_cost[states]
        tok[states] = new_tok_states
        cost, tok = _eps_expand(g, cost, tok, trace)
        # pruning (ref: faster-decoder.cc adaptive beam / max-active)
        if np.isfinite(beam):
            cutoff = cost.min() + beam
            cost[cost > cutoff] = INF
        if max_active and np.isfinite(cost).sum() > max_active:
            kth = np.partition(cost, max_active)[max_active]
            cost[cost > kth] = INF

    total = cost + g.final
    best_state = int(np.argmin(total))
    best_cost = float(total[best_state])
    if not np.isfinite(best_cost):
        if require_final:
            return np.zeros(0, np.int32), np.zeros(0, np.int32), float("inf")
        # no token reached a final state: back off to best active token
        # (ref: faster-decoder.cc ReachedFinal()==false fallback)
        best_state = int(np.argmin(cost))
        best_cost = float(cost[best_state])
        if not np.isfinite(best_cost):
            return np.zeros(0, np.int32), np.zeros(0, np.int32), float("inf")
    # unwind
    ilabels, olabels = [], []
    i = tok[best_state]
    prev = np.asarray(trace.prev)
    il = np.asarray(trace.ilabel)
    ol = np.asarray(trace.olabel)
    while i > 0:
        if il[i] > 0:
            ilabels.append(il[i])
        if ol[i] > 0:
            olabels.append(ol[i])
        i = prev[i]
    return (np.asarray(ilabels[::-1], np.int32),
            np.asarray(olabels[::-1], np.int32), best_cost)


def lattice_decode(
    graph: CompiledGraph,
    loglikes: np.ndarray,
    acoustic_scale: float = 0.1,
    beam: float = 16.0,
    lattice_beam: float = 8.0,
    max_active: int = 7000,
):
    """Lattice-generating beam decode (ref: lattice-faster-decoder.cc
    LatticeFasterDecoder::Decode + GetRawLattice + final PruneLattice):
    the forward pass keeps, per frame, every within-beam arc into every
    surviving state (not just the Viterbi-best), then the raw lattice is
    pruned backward to ``lattice_beam``.  Acoustic costs are stored
    unscaled for downstream rescoring sweeps."""
    from kaldi_cnn_tpu.decode.lattice import Lattice, prune_lattice
    g = graph
    T = loglikes.shape[0]
    am_raw = -loglikes  # unscaled acoustic costs

    # node bookkeeping: one lattice state per (frame, graph state)
    state_time: List[int] = []
    a_src: List[np.ndarray] = []
    a_dst: List[np.ndarray] = []
    a_il: List[np.ndarray] = []
    a_ol: List[np.ndarray] = []
    a_g: List[np.ndarray] = []
    a_ac: List[np.ndarray] = []

    def new_nodes(states: np.ndarray, t: int) -> np.ndarray:
        base = len(state_time)
        state_time.extend([t] * len(states))
        node = np.full(g.num_states, -1, np.int64)
        node[states] = np.arange(base, base + len(states))
        return node

    def record(src_nodes, dst_nodes, il, ol, gw, ac):
        a_src.append(np.asarray(src_nodes, np.int64))
        a_dst.append(np.asarray(dst_nodes, np.int64))
        a_il.append(np.asarray(il, np.int32))
        a_ol.append(np.asarray(ol, np.int32))
        a_g.append(np.asarray(gw, np.float32))
        a_ac.append(np.asarray(ac, np.float32))

    def record_eps(cost: np.ndarray, node: np.ndarray, cutoff: float):
        if g.num_eps_arcs == 0:
            return
        keep = np.nonzero(
            (node[g.n_src] >= 0) & (node[g.n_dst] >= 0)
            & (cost[g.n_src] + g.n_weight <= cutoff))[0]
        if len(keep):
            record(node[g.n_src[keep]], node[g.n_dst[keep]],
                   np.zeros(len(keep), np.int32), g.n_olabel[keep],
                   g.n_weight[keep], np.zeros(len(keep), np.float32))

    trace = _Trace()
    cost = np.full(g.num_states, INF, np.float32)
    tok = np.zeros(g.num_states, np.int64)
    cost[g.start] = 0.0
    cost, tok = _eps_expand(g, cost, tok, trace)
    if np.isfinite(beam):
        cost[cost > cost.min() + beam] = INF
    active = np.nonzero(np.isfinite(cost))[0]
    node = new_nodes(active, 0)
    record_eps(cost, node, float(cost.min() + (beam if np.isfinite(beam)
                                               else 1e30)))

    for t in range(T):
        src_cost = cost[g.e_src]
        cand = (src_cost + g.e_weight
                + acoustic_scale * am_raw[t, g.e_pdf])
        new_cost, _ = _group_min(g.e_dst, cand, g.num_states)
        cutoff = float(new_cost.min() + beam) if np.isfinite(beam) \
            else float("inf")
        surviving = new_cost <= cutoff
        if max_active and surviving.sum() > max_active:
            kth = np.partition(new_cost, max_active)[max_active]
            cutoff = min(cutoff, float(kth))
            surviving = new_cost <= cutoff
        new_cost[~surviving] = INF
        # eps closure on costs (cheap trace reuse; lattice arcs recorded
        # separately below)
        tok2 = np.zeros(g.num_states, np.int64)
        new_cost, tok2 = _eps_expand(g, new_cost, tok2, trace)
        new_cost[new_cost > cutoff] = INF
        act2 = np.nonzero(np.isfinite(new_cost))[0]
        if len(act2) == 0:
            break
        node2 = new_nodes(act2, t + 1)
        # record emitting arcs into surviving states
        keep = np.nonzero((node[g.e_src] >= 0) & (node2[g.e_dst] >= 0)
                          & (cand <= cutoff))[0]
        if len(keep):
            record(node[g.e_src[keep]], node2[g.e_dst[keep]],
                   g.e_ilabel[keep], g.e_olabel[keep], g.e_weight[keep],
                   am_raw[t, g.e_pdf[keep]])
        record_eps(new_cost, node2, cutoff)
        cost, node = new_cost, node2

    n = len(state_time)
    final_graph = np.full(n, INF, np.float32)
    last = node >= 0
    final_graph[node[last]] = g.final[last]
    lat = Lattice(
        num_states=n, start=0,
        state_time=np.asarray(state_time, np.int32),
        arc_src=(np.concatenate(a_src) if a_src
                 else np.zeros(0, np.int64)).astype(np.int32),
        arc_dst=(np.concatenate(a_dst) if a_dst
                 else np.zeros(0, np.int64)).astype(np.int32),
        arc_ilabel=np.concatenate(a_il) if a_il else np.zeros(0, np.int32),
        arc_olabel=np.concatenate(a_ol) if a_ol else np.zeros(0, np.int32),
        arc_graph=np.concatenate(a_g) if a_g else np.zeros(0, np.float32),
        arc_acoustic=(np.concatenate(a_ac) if a_ac
                      else np.zeros(0, np.float32)),
        final_graph=final_graph,
    )
    if not np.isfinite(lat.final_graph).any():
        # no token reached a final state: make best last-frame states
        # final with zero cost (ref: GetRawLattice use_final_probs=false)
        lat.final_graph[node[last]] = 0.0
    return prune_lattice(lat, lattice_beam, lm_scale=1.0,
                         acoustic_scale=acoustic_scale)


def viterbi_align(
    graph: CompiledGraph,
    loglikes: np.ndarray,
    acoustic_scale: float = 1.0,
    beam: float = np.inf,
) -> Optional[np.ndarray]:
    """Forced alignment: [T] transition-ids, or None if no path
    (ref: gmm-align-compiled / align-compiled-mapped)."""
    tids, _, cost = _viterbi(graph, loglikes, acoustic_scale, beam,
                             require_final=True)
    if len(tids) != loglikes.shape[0]:
        return None
    return tids


def viterbi_decode(
    graph: CompiledGraph,
    loglikes: np.ndarray,
    acoustic_scale: float = 0.1,
    beam: float = 16.0,
    max_active: int = 7000,
    word_ins_penalty: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Best-path decode: returns (alignment tids, word ids, cost)
    (ref: gmm-latgen-faster / nnet-latgen-faster best path)."""
    return _viterbi(graph, loglikes, acoustic_scale, beam, max_active,
                    word_ins_penalty=word_ins_penalty)

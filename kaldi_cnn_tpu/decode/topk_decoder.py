"""Scalable batched on-device beam search: top-K token passing over CSR
HCLG with on-device lattice emission.

A JAX re-design of the reference's lattice decoder
(ref: src/decoder/lattice-faster-decoder.cc LatticeFasterDecoder::Decode,
ProcessEmitting / ProcessNonemitting / PruneActiveTokens / GetRawLattice).
Where the reference keeps a hash map state->Token and walks OpenFst arc
iterators per active state, and the dense ``TpuViterbiDecoder`` relaxes
every arc of the graph every frame (O(arcs) work and O(states) memory per
frame — fine for small graphs, fatal for real HCLGs of 10^6-10^7 states),
this decoder's per-frame work and working-set memory are independent of
graph size:

  tokens   = K active (state, cost) pairs, kept SORTED BY STATE so that
             membership lookup is a binary search, not an O(S) table;
  expand   = windowed gather of each active state's outgoing arcs from
             the CSR packing, PLUS a dense relaxation of the arcs of the
             few statically-identified high-degree hub states (LM
             backoff / word-loop hubs; see ``TopKGraph``);
  recombine= lax.sort by (dst, cost) + dedup mask  (the hash-map insert);
  prune    = candidate beam cutoff + lax.top_k     (beam + max-active);
  eps      = the same expand/recombine on the eps arc table, iterated to
             the precomputed eps-DAG depth             (ProcessNonemitting);
  lattice  = per frame, every within-beam candidate arc between surviving
             tokens is compacted into a fixed-size record buffer on device
             (GetRawLattice's arc set), assembled into a ``Lattice`` on the
             host with zero recomputation.

Graph arrays live in device memory; per-frame working set is
O(K * max_degree).
Acoustic scores feed the scan directly, erasing the GPU-scores/CPU-search
asymmetry of the reference decode pipeline (SURVEY.md §3.4).

Backpointers: after the eps fixpoint, one resolution pass recomputes, for
every surviving token, the arc that achieves its final cost (Viterbi
optimal substructure makes fixpoint backpointers self-consistent).  The
rare token whose eps predecessor was itself evicted by top-K pruning is
emitted unresolved (-1) and repaired on the host by re-closing that one
frame (``_host_fix``).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_cnn_tpu.decode.graph import CompiledGraph
from kaldi_cnn_tpu.decode.lattice import Lattice, prune_lattice

BIG = np.float32(1e30)
INVALID = np.int32(2**31 - 1)


# ---------------------------------------------------------------------------
# Graph packing
# ---------------------------------------------------------------------------

class TopKGraph:
    """Two-tier CSR packing of a CompiledGraph.

    Arc tables are sorted by source state (full CSR, arc multiset and
    state numbering unchanged).  States whose out-degree fits the caps
    are expanded with a fixed gather window per frame; the few states
    that exceed them (LM backoff / word-loop hubs with 10^4-10^5 arcs)
    are marked as *hubs* and get a dense relaxation instead: every hub
    arc is a candidate every frame, its source cost looked up in the
    active set.  That is exactly the cost the reference pays when a hub
    is active (ProcessEmitting walks all its arcs) — but here the hub
    arc set is static, so the shapes stay XLA-friendly.
    """

    def __init__(self, g: CompiledGraph, max_emit: int = 16,
                 max_eps: int = 8):
        assert max_emit >= 1 and max_eps >= 2
        S = g.num_states
        self.num_states = S
        self.start = g.start

        # full CSR over all emitting arcs (vectorized: 10^6-10^7 arc
        # graphs pack in milliseconds)
        e_order = np.argsort(np.asarray(g.e_src, np.int64), kind="stable")
        e_src_a = np.asarray(g.e_src, np.int64)[e_order]
        self.e_src = e_src_a.astype(np.int32)
        self.e_dst = g.e_dst[e_order]
        self.e_pdf = g.e_pdf[e_order]
        self.e_w = g.e_weight[e_order]
        self.e_ilabel = g.e_ilabel[e_order]
        self.e_olabel = g.e_olabel[e_order]
        self.e_off = np.searchsorted(
            e_src_a, np.arange(S + 1)).astype(np.int32)

        n_order = np.argsort(np.asarray(g.n_src, np.int64), kind="stable")
        n_src_a = np.asarray(g.n_src, np.int64)[n_order]
        self.n_src = n_src_a.astype(np.int32)
        self.n_dst = g.n_dst[n_order]
        self.n_w = g.n_weight[n_order]
        self.n_olabel = g.n_olabel[n_order]
        self.n_off = np.searchsorted(
            n_src_a, np.arange(S + 1)).astype(np.int32)

        # hub classification (per arc family)
        e_deg = self.e_off[1:] - self.e_off[:-1]
        n_deg = self.n_off[1:] - self.n_off[:-1]
        self.e_is_hub = (e_deg > max_emit)
        self.n_is_hub = (n_deg > max_eps)
        self.e_hub_arcs = np.concatenate(
            [np.arange(self.e_off[s], self.e_off[s + 1])
             for s in np.nonzero(self.e_is_hub)[0]] or
            [np.zeros(0, np.int64)]).astype(np.int32)
        self.n_hub_arcs = np.concatenate(
            [np.arange(self.n_off[s], self.n_off[s + 1])
             for s in np.nonzero(self.n_is_hub)[0]] or
            [np.zeros(0, np.int64)]).astype(np.int32)
        self.max_emit_deg = int(e_deg[~self.e_is_hub].max()) \
            if (~self.e_is_hub).any() and len(self.e_src) else 0
        self.max_eps_deg = int(n_deg[~self.n_is_hub].max()) \
            if (~self.n_is_hub).any() and len(self.n_src) else 0

        self.final = np.asarray(g.final, np.float32)
        self.eps_depth = self._eps_depth()
        self._build_lookahead()
        self._build_hub_aux()
        self._build_eps_incsr()

    def _build_hub_aux(self) -> None:
        """Per-hub-state auxiliary tables: hub arcs are relaxed densely
        every frame, but their SOURCES are a handful of distinct hub
        states — looking up those few states once and broadcasting via a
        static arc->hub-state index replaces a 10^5-query binary search
        per frame.  Hub arc
        DESTINATIONS are static too, so their acoustic-lookahead table
        rows are pre-gathered here; at runtime the lookahead becomes a
        small-table gather over the P-row acoustic vector instead of a
        random device-memory gather over the [S, W+1] table."""
        for fam in ("e", "n"):
            arcs = getattr(self, f"{fam}_hub_arcs")
            srcs = getattr(self, f"{fam}_src")[arcs] if len(arcs) else \
                np.zeros(0, np.int32)
            states, sid = np.unique(srcs, return_inverse=True)
            setattr(self, f"{fam}_hub_states", states.astype(np.int32))
            setattr(self, f"{fam}_hub_sid", sid.astype(np.int32))
        dsts = self.n_dst[self.n_hub_arcs] if len(self.n_hub_arcs) else \
            np.zeros(0, np.int64)
        self.n_hub_la_pdf = self.la_pdf[dsts]
        self.n_hub_la_w = self.la_w[dsts]

    def _build_eps_incsr(self, max_in: int = 8) -> None:
        """CSR of eps arcs BY DESTINATION, for backpointer resolution:
        each surviving token checks only its own eps in-arcs (a bounded
        window) instead of the whole expansion being scattered through
        segment-min reductions.  States whose eps in-degree exceeds the
        cap (e.g. an LM backoff state fed by many word-ends) keep a
        dense in-hub arc table."""
        A = len(self.n_src)
        order = np.argsort(np.asarray(self.n_dst, np.int64),
                           kind="stable")
        dst_sorted = np.asarray(self.n_dst, np.int64)[order]
        off = np.searchsorted(dst_sorted, np.arange(self.num_states + 1))
        deg = off[1:] - off[:-1]
        self.ni_is_hub = deg > max_in
        hub_arcs = np.concatenate(
            [order[off[s]:off[s + 1]]
             for s in np.nonzero(self.ni_is_hub)[0]] or
            [np.zeros(0, np.int64)]).astype(np.int32)
        self.ni_hub_arcs = hub_arcs
        self.ni_off = off.astype(np.int32)
        self.ni_arc = order.astype(np.int32)
        self.max_in_deg = int(deg[~self.ni_is_hub].max()) \
            if (~self.ni_is_hub).any() and A else 0

    def _build_lookahead(self, W: int = 2) -> None:
        """Per-state acoustic-lookahead table: up to W outgoing emitting
        (weight, pdf) pairs per state, used to RANK tokens during top-K
        pruning by cost + min_a(w_a + scale*am_next[pdf_a]).  States
        whose out-degree exceeds W (hubs), is zero, or that also have
        epsilon out-arcs get an optimistic 0-cost sentinel slot (never
        wrongly evicted: a state with 1-2 emitting arcs plus eps
        out-arcs — e.g. a word-end state feeding LM backoff through a
        non-hub eps chain — must not be ranked purely by its emitting
        arcs' next-frame acoustics, or the eps fixpoint can evict tokens
        whose best continuation is epsilon).  True Viterbi costs are
        untouched — only survival under K/beam pressure changes, which
        is what lets acoustically-supported word-start tokens live
        through an LM hub fan-out that K cannot cover (the reference has
        the same eviction problem in GetCutoff when active >> max-active;
        ref: lattice-faster-decoder.cc adaptive-beam logic)."""
        S = self.num_states
        deg = (self.e_off[1:] - self.e_off[:-1]).astype(np.int64)
        eps_deg = (self.n_off[1:] - self.n_off[:-1]).astype(np.int64)
        la_pdf = np.full((S, W + 1), -1, np.int32)   # -1 = sentinel slot
        la_w = np.full((S, W + 1), BIG, np.float32)
        for j in range(W):
            has = deg > j
            idx = self.e_off[:-1][has] + j
            la_pdf[has, j] = self.e_pdf[idx]
            la_w[has, j] = self.e_w[idx]
        optimistic = (deg == 0) | (deg > W) | (eps_deg > 0)
        la_w[optimistic, W] = 0.0
        self.la_pdf = la_pdf
        self.la_w = la_w

    def _eps_depth(self, cap: int = 64) -> int:
        if len(self.n_src) == 0:
            return 0
        depth = np.zeros(self.num_states, np.int32)
        for _ in range(cap):
            upd = np.zeros(self.num_states, np.int32)
            np.maximum.at(upd, self.n_dst, depth[self.n_src] + 1)
            new = np.maximum(depth, upd)
            if (new == depth).all():
                return int(depth.max())
            depth = new
        raise ValueError("epsilon cycle in decoding graph")

    @property
    def num_emitting_arcs(self) -> int:
        return len(self.e_src)

    @property
    def num_eps_arcs(self) -> int:
        return len(self.n_src)


# ---------------------------------------------------------------------------
# Device-side primitives (single utterance; vmapped over batch)
# ---------------------------------------------------------------------------

def _recombine_topk(dst, cost, payloads, k, beam, la=None):
    """Hash-map insert + beam + max-active in one shot: sort candidates
    by (dst, cost), keep the cheapest per dst, beam-cut, take top-K, and
    restore state-sorted order (ref: ProcessEmitting's token map +
    PruneActiveTokens).

    ``la``: optional PER-CANDIDATE acoustic-lookahead ranking addend,
    carried through the sort as a payload (a post-sort la gather over
    the shuffled dst array would be a random device-memory gather per
    frame, nearly free as a payload).  Per-dst recombination
    and the stored costs remain exact true costs; only the top-K
    *selection* uses cost + lookahead, so tokens with acoustic support
    next frame out-survive LM-only hub fan-out
    (TopKGraph._build_lookahead)."""
    extra = () if la is None else (la,)
    ops = jax.lax.sort((dst, cost) + extra + tuple(payloads), num_keys=2)
    sdst, scost = ops[0], ops[1]
    dup = jnp.concatenate(
        [jnp.zeros((1,), bool), sdst[1:] == sdst[:-1]])
    cutoff = jnp.min(scost) + beam
    bad = dup | (scost > cutoff) | (sdst == INVALID)
    scost = jnp.where(bad, BIG, scost)
    sdst = jnp.where(bad, INVALID, sdst)
    if la is None:
        rank, rest = scost, ops[2:]
    else:
        rank, rest = jnp.where(bad, BIG, scost + ops[2]), ops[3:]
    _, idx = jax.lax.top_k(-rank, k)
    sel = (sdst[idx], scost[idx]) + tuple(o[idx] for o in rest)
    # restore the state-sorted invariant (dedup marking above happened
    # after the first sort, so selected entries are not in dst order)
    return jax.lax.sort(sel, num_keys=2)


def _lookup(sorted_states, values, query, default):
    """values[slot of query] for queries present in the state-sorted
    active set, else default.

    method='sort': the default scan method lowers to ~log2(K) serial
    gather rounds per query batch; the sort method is one fused
    lax.sort with identical results."""
    k = sorted_states.shape[0]
    pos = jnp.clip(jnp.searchsorted(sorted_states, query,
                                    method="sort"), 0, k - 1)
    hit = (sorted_states[pos] == query) & (query != INVALID)
    return jnp.where(hit, values[pos], default), \
        jnp.where(hit, pos.astype(jnp.int32), -1)


class TpuTopKDecoder:
    """Batched top-K beam decoder with optional lattice emission.

    Exact Viterbi (matches the host decoder) whenever ``max_active``
    covers all simultaneously-alive states and the beam is generous;
    otherwise the usual beam-search approximation, like the reference.
    """

    def __init__(self, graph: CompiledGraph, beam: float = 16.0,
                 max_active: int = 2048, acoustic_scale: float = 0.1,
                 lattice_beam: float = 8.0,
                 lattice_arcs_per_frame: Optional[int] = 0,
                 max_emit_deg: int = 16, max_eps_deg: int = 8,
                 mesh=None):
        """``mesh``: optional jax.sharding.Mesh with a ``data`` axis —
        the utterance batch shards over it (decoder-state parallelism:
        graph arrays replicate, token state stays per-utterance, so no
        collectives cross utterances; SURVEY.md §2.2 decoder-state row).

        ``lattice_arcs_per_frame``: per-frame lattice record capacity.
        0 disables lattice buffers (best-path only); None derives the
        capacity from ``max_active`` (see _derive_lattice_arcs) so
        default-sized decodes don't pay auto-grow re-decodes.
        """
        self.g0 = graph
        self.g = TopKGraph(graph, max_emit_deg, max_eps_deg)
        g = self.g
        self.beam = np.float32(min(beam, 1e9))
        # max_active <= 0 means unlimited, like the host decoder and the
        # reference's --max-active=0 convention
        self.K = int(min(max_active, g.num_states)) if max_active > 0 \
            else g.num_states
        self.acoustic_scale = np.float32(acoustic_scale)
        self.lattice_beam = float(lattice_beam)
        self.A_lat = (self._derive_lattice_arcs(self.K)
                      if lattice_arcs_per_frame is None
                      else int(lattice_arcs_per_frame))
        self.De = max(g.max_emit_deg, 1)
        self.Dn = max(g.max_eps_deg, 1)
        self.He = len(g.e_hub_arcs)
        self.Hn = len(g.n_hub_arcs)
        self.eps_iters = g.eps_depth
        # device graph
        self.d = {
            "e_off": jnp.asarray(g.e_off), "e_dst": jnp.asarray(g.e_dst),
            "e_pdf": jnp.asarray(g.e_pdf), "e_w": jnp.asarray(g.e_w),
            "n_off": jnp.asarray(g.n_off), "n_dst": jnp.asarray(g.n_dst),
            "n_w": jnp.asarray(g.n_w),
            "e_is_hub": jnp.asarray(g.e_is_hub),
            "n_is_hub": jnp.asarray(g.n_is_hub),
            "la_pdf": jnp.asarray(g.la_pdf),
            "la_w": jnp.asarray(g.la_w),
        }
        # dense hub arc tables (see TopKGraph docstring); hub aux
        # tables let source costs resolve per hub STATE and hub-dst
        # lookahead come from pre-gathered rows (TopKGraph._build_hub_aux)
        if self.He:
            ha = g.e_hub_arcs
            self.d["e_hub"] = tuple(jnp.asarray(x) for x in (
                ha, g.e_src[ha], g.e_dst[ha], g.e_w[ha], g.e_pdf[ha]))
            self.d["e_hub_states"] = jnp.asarray(g.e_hub_states)
            self.d["e_hub_sid"] = jnp.asarray(g.e_hub_sid)
        if self.Hn:
            ha = g.n_hub_arcs
            self.d["n_hub"] = tuple(jnp.asarray(x) for x in (
                ha, g.n_src[ha], g.n_dst[ha], g.n_w[ha]))
            self.d["n_hub_states"] = jnp.asarray(g.n_hub_states)
            self.d["n_hub_sid"] = jnp.asarray(g.n_hub_sid)
            self.d["n_hub_la_pdf"] = jnp.asarray(g.n_hub_la_pdf)
            self.d["n_hub_la_w"] = jnp.asarray(g.n_hub_la_w)
        # eps in-CSR for backpointer resolution (TopKGraph._build_eps_incsr)
        self.Di = max(g.max_in_deg, 1)
        self.Hni = len(g.ni_hub_arcs)
        if self.eps_iters > 0:
            self.d["ni_off"] = jnp.asarray(g.ni_off)
            self.d["ni_arc"] = jnp.asarray(g.ni_arc)
            self.d["ni_is_hub"] = jnp.asarray(g.ni_is_hub)
            self.d["n_src"] = jnp.asarray(g.n_src)
            if self.Hni:
                ha = g.ni_hub_arcs
                self.d["ni_hub"] = tuple(jnp.asarray(x) for x in (
                    ha, g.n_src[ha], g.n_dst[ha], g.n_w[ha]))
        self.d_e_pdf = self.d["e_pdf"]
        self.mesh = mesh
        self._jit_cache = {}

    # -- expansion ---------------------------------------------------------
    def _expand(self, states, costs, off, dst, w, width, is_hub):
        """Windowed CSR gather of the out-arcs of the active set's
        non-hub states.  Returns flat (arc_id, dst, base_cost, src_slot,
        ok) of K*width candidates (invalid ones cost BIG / dst
        INVALID).  Hub states are masked out here — their arcs come from
        the dense hub tables via _expand_hub."""
        k = states.shape[0]
        valid = states != INVALID
        sc = jnp.where(valid, states, 0)
        base = off[sc]
        deg = off[sc + 1] - base
        j = jax.lax.broadcasted_iota(jnp.int32, (k, width), 1)
        arc = jnp.clip(base[:, None] + j, 0, dst.shape[0] - 1)
        ok = ((j < deg[:, None]) & valid[:, None]
              & (costs[:, None] < BIG) & ~is_hub[sc][:, None])
        cdst = jnp.where(ok, dst[arc], INVALID)
        ccost = jnp.where(ok, costs[:, None] + w[arc], BIG)
        slot = jax.lax.broadcasted_iota(jnp.int32, (k, width), 0)
        return (arc.reshape(-1), cdst.reshape(-1), ccost.reshape(-1),
                slot.reshape(-1), ok.reshape(-1))

    def _expand_hub(self, states, costs, hub, hub_states, hub_sid):
        """Dense relaxation of the static hub arc tables: every hub arc
        is a candidate; its source cost is a binary-search lookup of the
        FEW distinct hub states (not one lookup per arc, 90k arcs at
        bench scale), broadcast to arcs via the static arc->hub index."""
        arc, src, dst, w = hub[0], hub[1], hub[2], hub[3]
        scost_s, sslot_s = _lookup(states, costs, hub_states, BIG)
        scost = scost_s[hub_sid]
        sslot = sslot_s[hub_sid]
        ok = (sslot >= 0) & (scost < BIG)
        cdst = jnp.where(ok, dst, INVALID)
        ccost = jnp.where(ok, scost + w, BIG)
        return arc, cdst, ccost, sslot, ok

    @staticmethod
    def _cat(parts_a, parts_b):
        """Concatenate two candidate tuples (arc, dst, cost, slot, ok)."""
        return tuple(jnp.concatenate([a, b])
                     for a, b in zip(parts_a, parts_b))

    def _expand_emit(self, states, costs):
        d = self.d
        cand = self._expand(states, costs, d["e_off"], d["e_dst"],
                            d["e_w"], self.De, d["e_is_hub"])
        if self.He:
            cand = self._cat(cand, self._expand_hub(
                states, costs, d["e_hub"], d["e_hub_states"],
                d["e_hub_sid"]))
        return cand

    def _expand_eps(self, states, costs):
        d = self.d
        cand = self._expand(states, costs, d["n_off"], d["n_dst"],
                            d["n_w"], self.Dn, d["n_is_hub"])
        if self.Hn:
            cand = self._cat(cand, self._expand_hub(
                states, costs, d["n_hub"], d["n_hub_states"],
                d["n_hub_sid"]))
        return cand

    # -- one frame ---------------------------------------------------------
    def _am_ext(self, am_next):
        """Scaled next-frame acoustic costs with a trailing 0 sentinel
        (la_pdf -1 slots index it)."""
        return jnp.concatenate([self.acoustic_scale * am_next,
                                jnp.zeros((1,), am_next.dtype)])

    def _la_states(self, states, am_ext):
        """Dynamic acoustic lookahead for a state set (random gather
        over the [S, W+1] tables — keep the set small; hub arcs use the
        pre-gathered static rows via _la_hub instead)."""
        P = am_ext.shape[0] - 1
        s = jnp.where(states == INVALID, 0, states)
        pdfs = self.d["la_pdf"][s]
        idx = jnp.where((pdfs < 0) | (pdfs >= P), P, pdfs)
        v = jnp.min(self.d["la_w"][s] + am_ext[idx], axis=-1)
        return jnp.where(states == INVALID, np.float32(0.0),
                         jnp.minimum(v, BIG))

    def _la_hub(self, am_ext):
        """Lookahead of the (static) eps hub arc destinations: only a
        small-table gather over am_ext at runtime."""
        P = am_ext.shape[0] - 1
        pdfs = self.d["n_hub_la_pdf"]
        idx = jnp.where((pdfs < 0) | (pdfs >= P), P, pdfs)
        return jnp.minimum(
            jnp.min(self.d["n_hub_la_w"] + am_ext[idx], axis=-1), BIG)

    def _eps_fixpoint(self, fs, fc, am_ext=None):
        d = self.d
        for _ in range(self.eps_iters):
            cand = self._expand(fs, fc, d["n_off"], d["n_dst"],
                                d["n_w"], self.Dn, d["n_is_hub"])
            dsts = [fs, cand[1]]
            costs = [fc, cand[2]]
            las = None
            if am_ext is not None:
                las = [self._la_states(fs, am_ext),
                       self._la_states(cand[1], am_ext)]
            if self.Hn:
                hub = self._expand_hub(fs, fc, d["n_hub"],
                                       d["n_hub_states"],
                                       d["n_hub_sid"])
                dsts.append(hub[1])
                costs.append(hub[2])
                if am_ext is not None:
                    las.append(self._la_hub(am_ext))
            fs, fc = _recombine_topk(
                jnp.concatenate(dsts), jnp.concatenate(costs), (),
                self.K, self.beam,
                None if las is None else jnp.concatenate(las))
        return fs, fc

    def _resolve_bp(self, fs, fc, es, ec, e_bp_arc, e_bp_prev):
        """Post-fixpoint backpointer pass: each surviving token is traced
        either to the emitting set (same state, same cost) or to the eps
        in-arc from another surviving token that achieves its cost.
        The eps case checks each token's OWN eps in-arcs via the
        by-destination CSR (a [K, Di] windowed gather + one [K*Di]
        lookup) instead of re-expanding and scattering the full eps
        candidate set through segment-min reductions (a 97k-candidate
        lookup + 2 segment-mins at bench scale); in-hub
        destinations (huge eps in-degree, e.g. LM backoff states) keep
        the dense segment-min path over their static in-arc table."""
        tol = np.float32(1e-3)
        # case a: token unchanged since the emitting step
        ecost_at, eslot = _lookup(es, ec, fs, BIG)
        emit_hit = jnp.abs(ecost_at - fc) <= tol
        K = self.K
        # case b: eps arc from another final token
        if self.eps_iters > 0:
            d = self.d
            valid = fs != INVALID
            sc = jnp.where(valid, fs, 0)
            base = d["ni_off"][sc]
            deg = d["ni_off"][sc + 1] - base
            Di = self.Di
            j = jax.lax.broadcasted_iota(jnp.int32, (K, Di), 1)
            hi = max(int(self.g.num_eps_arcs) - 1, 0)
            arc = d["ni_arc"][jnp.clip(base[:, None] + j, 0, hi)]
            ok = ((j < deg[:, None]) & valid[:, None]
                  & ~d["ni_is_hub"][sc][:, None])
            src = jnp.where(ok, d["n_src"][arc], INVALID)
            scost, sslot = _lookup(fs, fc, src, BIG)
            match = ok & (sslot >= 0) & (jnp.abs(
                scost + d["n_w"][arc] - fc[:, None]) <= tol)
            arc_m = jnp.where(match, arc, INVALID)
            pos = jnp.argmin(arc_m, axis=1)            # min arc id wins
            best_arc = jnp.take_along_axis(arc_m, pos[:, None], 1)[:, 0]
            best_src = jnp.take_along_axis(
                jnp.where(match, sslot, INVALID), pos[:, None], 1)[:, 0]
            if self.Hni:
                ha, hsrc, hdst, hw = d["ni_hub"]
                hscost, hslot = _lookup(fs, fc, hsrc, BIG)
                hdcost, hdslot = _lookup(fs, fc, hdst, BIG)
                hmatch = ((hslot >= 0) & (hdslot >= 0) & (jnp.abs(
                    hscost + hw - hdcost) <= tol))
                seg = jnp.where(hmatch, hdslot, K).astype(jnp.int32)
                h_arc = jax.ops.segment_min(
                    jnp.where(hmatch, ha, INVALID), seg,
                    num_segments=K + 1)[:K]
                win = hmatch & (ha == h_arc[
                    jnp.where(hdslot >= 0, hdslot, 0)])
                h_src = jax.ops.segment_min(
                    jnp.where(win, hslot, INVALID), seg,
                    num_segments=K + 1)[:K]
                is_ihub = d["ni_is_hub"][sc] & valid
                best_arc = jnp.where(is_ihub, h_arc, best_arc)
                best_src = jnp.where(is_ihub, h_src, best_src)
            eps_hit = best_arc != INVALID
        else:
            eps_hit = jnp.zeros_like(fs, dtype=bool)
            best_arc = jnp.full_like(fs, INVALID)
            best_src = jnp.full_like(fs, INVALID)
        n_e = self.g.num_emitting_arcs
        bp_arc = jnp.where(
            emit_hit, jnp.where(eslot >= 0, e_bp_arc[
                jnp.where(eslot >= 0, eslot, 0)], -1),
            jnp.where(eps_hit, best_arc + n_e, -1))
        bp_prev = jnp.where(
            emit_hit, jnp.where(eslot >= 0, e_bp_prev[
                jnp.where(eslot >= 0, eslot, 0)], -1),
            jnp.where(eps_hit, best_src, -1))
        dead = fs == INVALID
        return jnp.where(dead, -1, bp_arc), jnp.where(dead, -1, bp_prev)

    def _emit_records(self, fs, fc, emit_cand, a_lat):
        """GetRawLattice emitting-arc records for one frame.

        Keep criterion ``ccost <= fc[dst] + lattice_beam`` is the exact
        per-destination lattice-beam cut: an arc reaching dst at cost
        ccost lies on no path better than best_total + (ccost - fc[dst])
        (fc is the true Viterbi forward cost), so arcs beyond it are
        precisely the ones prune_lattice would drop on the host — this
        thins the on-device record buffers ~(beam/lattice_beam)x with
        zero change to the pruned lattice (ref: GetRawLattice emits arcs
        between surviving tokens; PruneLattice applies the beam)."""
        lbeam = np.float32(self.lattice_beam)
        arc, cdst, ccost, srcslot, ok = emit_cand
        dcost, dslot = _lookup(fs, fc, cdst, BIG)
        keep = ok & (dslot >= 0) & (ccost <= dcost + lbeam)
        return self._compact(keep, (srcslot, dslot, arc), a_lat)

    def _eps_records(self, fs, fc, a_lat):
        """Same-level eps-arc records (same per-dst lattice-beam cut),
        built from the by-DESTINATION in-CSR: each surviving token
        gathers its own eps in-arcs ([K, Di] window + dense in-hub
        table) and tests the source against the active set — K*Di
        candidates instead of the full out-expansion (K*Dn + all hub
        arcs), which cost a 97k-query lookup per frame at bench
        scale."""
        if self.eps_iters == 0:
            z = jnp.full((a_lat,), -1, jnp.int32)
            return (z, z, z, jnp.int32(0))
        lbeam = np.float32(self.lattice_beam)
        d = self.d
        K = self.K
        valid = fs != INVALID
        sc = jnp.where(valid, fs, 0)
        base = d["ni_off"][sc]
        deg = d["ni_off"][sc + 1] - base
        Di = self.Di
        j = jax.lax.broadcasted_iota(jnp.int32, (K, Di), 1)
        hi = max(int(self.g.num_eps_arcs) - 1, 0)
        arc = d["ni_arc"][jnp.clip(base[:, None] + j, 0, hi)]
        ok = ((j < deg[:, None]) & valid[:, None]
              & ~d["ni_is_hub"][sc][:, None])
        src = jnp.where(ok, d["n_src"][arc], INVALID)
        scost, sslot = _lookup(fs, fc, src, BIG)
        keep = ok & (sslot >= 0) & (
            scost + d["n_w"][arc] <= fc[:, None] + lbeam)
        dslot = jax.lax.broadcasted_iota(jnp.int32, (K, Di), 0)
        keeps = [keep.reshape(-1)]
        srcs = [sslot.reshape(-1)]
        dsts = [dslot.reshape(-1)]
        arcs = [arc.reshape(-1)]
        if self.Hni:
            ha, hsrc, hdst, hw = d["ni_hub"]
            hscost, hslot = _lookup(fs, fc, hsrc, BIG)
            hdcost, hdslot = _lookup(fs, fc, hdst, BIG)
            keeps.append((hslot >= 0) & (hdslot >= 0)
                         & (hscost + hw <= hdcost + lbeam))
            srcs.append(hslot)
            dsts.append(hdslot)
            arcs.append(ha)
        return self._compact(
            jnp.concatenate(keeps),
            (jnp.concatenate(srcs), jnp.concatenate(dsts),
             jnp.concatenate(arcs)), a_lat)

    @staticmethod
    def _compact(mask, arrays, out_len):
        """Compacts mask-selected entries to the first ``out_len`` slots.
        The returned count is the TRUE (unclamped) candidate count, so
        the host can detect and report overflow (count > out_len means
        arcs were dropped on this frame — the 'no silent caps' rule);
        only the first min(count, out_len) array slots are valid."""
        n = mask.shape[0]
        take = min(out_len, n)
        order = jnp.argsort(jnp.logical_not(mask).astype(jnp.int8),
                            stable=True)[:take]
        cnt_true = jnp.sum(mask.astype(jnp.int32))
        cnt = jnp.minimum(cnt_true, np.int32(take))
        outs = []
        for a in arrays:
            v = jnp.where(jnp.arange(take) < cnt, a[order], -1)
            if take < out_len:
                v = jnp.pad(v, (0, out_len - take), constant_values=-1)
            outs.append(v)
        return tuple(outs) + (cnt_true,)

    def _frame(self, prev_fs, prev_fc, am_row, am_next_row,
               a_lat: Optional[int] = None):
        """One decode frame.  ``a_lat``: per-frame lattice record buffer
        size; 0 disables lattice emission for this jit variant (the
        best-path fast path), None uses the decoder's setting.  The
        emitting and eps expansions are each computed ONCE and shared
        between recombination, backpointer resolution, and lattice
        record emission."""
        a_lat = self.A_lat if a_lat is None else a_lat
        arc, cdst, ccost, srcslot, ok = self._expand_emit(
            prev_fs, prev_fc)
        ccost = jnp.where(ok, ccost + self.acoustic_scale
                          * am_row[jnp.where(ok, self.d_e_pdf[arc], 0)],
                          BIG)
        emit_cand = (arc, cdst, ccost, srcslot, ok)
        es, ec, e_arc, e_prev = _recombine_topk(
            cdst, ccost, (arc, srcslot), self.K, self.beam)
        fs, fc = self._eps_fixpoint(es, ec, self._am_ext(am_next_row))
        if a_lat:
            # lattice variant: the assembled lattice never reads
            # backpointers (best path comes from the lattice itself), so
            # the whole _resolve_bp pass is skipped
            e_rec = self._emit_records(fs, fc, emit_cand, a_lat)
            n_rec = self._eps_records(fs, fc, a_lat)
            return (fs, fc) + e_rec + n_rec
        bp_arc, bp_prev = self._resolve_bp(fs, fc, es, ec, e_arc, e_prev)
        return (fs, fc, bp_arc, bp_prev)

    # -- full decode -------------------------------------------------------
    def _decode_impl(self, am_batch, a_lat: int):
        """am_batch [B, T, P] raw acoustic costs (-loglikes)."""
        B, T, P = am_batch.shape
        K = self.K

        def init_level(am_row0):
            """Start token + eps closure, lookahead-ranked by the first
            frame's acoustics (per utterance, so vmapped over batch)."""
            s0 = jnp.full((K,), INVALID, jnp.int32).at[0].set(self.g.start)
            c0 = jnp.full((K,), BIG).at[0].set(0.0)
            fs0, fc0 = self._eps_fixpoint(s0, c0, self._am_ext(am_row0))
            if a_lat:
                return (fs0, fc0), self._eps_records(fs0, fc0, a_lat)
            root_arc = jnp.full((K,), -1, jnp.int32)
            bp0_arc, bp0_prev = self._resolve_bp(
                fs0, fc0, s0, c0, root_arc, root_arc)
            return (fs0, fc0, bp0_arc, bp0_prev), ()

        initB, n_rec0B = jax.vmap(init_level)(am_batch[:, 0])
        frame_b = jax.vmap(
            lambda fs, fc, am, amn: self._frame(fs, fc, am, amn, a_lat),
            in_axes=(0, 0, 0, 0))

        def step(carry, x):
            fs, fc = carry
            am_row, am_next_row = x
            outs = frame_b(fs, fc, am_row, am_next_row)
            return (outs[0], outs[1]), outs

        am_t = jnp.swapaxes(am_batch, 0, 1)            # [T, B, P]
        am_nx = jnp.concatenate([am_t[1:], am_t[-1:]], axis=0)
        (_, _), hist = jax.lax.scan(
            step, (initB[0], initB[1]), (am_t, am_nx))
        out = {"init": initB, "fs": hist[0], "fc": hist[1]}
        if a_lat:
            out["init_eps"] = n_rec0B
            out["e_rec"] = hist[2:6]
            out["n_rec"] = hist[6:10]
        else:
            out["bp_arc"] = hist[2]
            out["bp_prev"] = hist[3]
        return out

    def _run(self, loglikes: List[np.ndarray], pad_frames: int = 0,
             a_lat: Optional[int] = None, to_host: bool = True):
        """``pad_frames``: pad the time axis up to this many frames (for
        length-bucketed batching: one jit specialization per bucket).
        Padding frames carry zero acoustics and are ignored by
        assembly/backtrace, which use the recorded true lengths.
        ``a_lat``: lattice buffer size override (0 = best-path-only jit
        variant).  ``to_host``: False keeps the history on device (the
        on-device backtrace path — the full history is ~100 MB+ per
        batch)."""
        B = len(loglikes)
        T = max(max(x.shape[0] for x in loglikes), pad_frames)
        P = loglikes[0].shape[1]
        a_lat = self.A_lat if a_lat is None else a_lat
        Bp = B
        if self.mesh is not None:
            n = self.mesh.shape["data"]
            Bp = -(-B // n) * n          # pad batch to the data axis
        am = np.zeros((Bp, T, P), np.float32)
        lengths = np.zeros((B,), np.int32)
        for i, x in enumerate(loglikes):
            am[i, :x.shape[0]] = -x
            lengths[i] = x.shape[0]
        key = (Bp, T, P, a_lat)
        if key not in self._jit_cache:
            fn = functools.partial(self._decode_impl, a_lat=a_lat)
            if self.mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec
                sh = NamedSharding(self.mesh, PartitionSpec("data"))
                self._jit_cache[key] = jax.jit(fn, in_shardings=sh)
            else:
                self._jit_cache[key] = jax.jit(fn)
        r = self._jit_cache[key](jnp.asarray(am))
        if to_host:
            r = jax.device_get(r)
        return r, am, lengths

    # -- on-device backtrace ----------------------------------------------
    def _backtrace_impl(self, fs_all, fc_all, ba_all, bp_all, lengths):
        """Vectorized backtrace of the whole batch on device: walks the
        backpointer chains exactly like the host ``_best_path`` loop and
        emits the arc sequence (newest first).  Only [B, L] ints cross
        to the host instead of the [T, B, K] histories.
        Tokens whose chain hits an unresolved backpointer set ``fail``
        and fall back to the host repair path for that utterance."""
        Tp1 = fs_all.shape[1]
        L = Tp1 * (self.eps_iters + 1) + 4
        n_e = self.g.num_emitting_arcs
        finals = jnp.asarray(self.g.final)
        start = self.g.start

        def one(fs_a, fc_a, ba_a, bp_a, T):
            fsT = jax.lax.dynamic_index_in_dim(fs_a, T, 0, keepdims=False)
            fcT = jax.lax.dynamic_index_in_dim(fc_a, T, 0, keepdims=False)
            valid = fsT != INVALID
            total_f = jnp.where(
                valid, fcT + finals[jnp.where(valid, fsT, 0)], BIG)
            slot_f = jnp.argmin(total_f)
            cost_f = total_f[slot_f]
            total_a = jnp.where(valid, fcT, BIG)
            slot_a = jnp.argmin(total_a)
            cost_a = total_a[slot_a]
            use_f = cost_f < BIG
            slot0 = jnp.where(use_f, slot_f, slot_a).astype(jnp.int32)
            cost = jnp.where(use_f, cost_f, cost_a)
            empty = ~jnp.any(valid)

            def body(_, st):
                t, slot, n, fail, done, out = st
                a = ba_a[t, slot]
                p = bp_a[t, slot]
                is_root = (t == 0) & (a < 0) & (fs_a[0, slot] == start)
                done2 = done | is_root
                fail2 = fail | ((a < 0) & ~done2)
                act = ~done2 & ~fail2
                out = jnp.where(act, out.at[n].set(a), out)
                n = jnp.where(act, n + 1, n)
                eps = a >= n_e
                t = jnp.where(act & ~eps, t - 1, t)
                slot = jnp.where(act, p, slot)
                return (t, slot, n, fail2, done2, out)

            st = (T.astype(jnp.int32), slot0, jnp.int32(0),
                  jnp.zeros((), bool), empty,
                  jnp.full((L,), -1, jnp.int32))
            t, slot, n, fail, done, out = jax.lax.fori_loop(
                0, L, body, st)
            fail = fail | (~done)
            return out, n, cost, fail, empty

        return jax.vmap(one)(fs_all, fc_all, ba_all, bp_all, lengths)

    def _arcs_to_path(self, arcs: np.ndarray, n: int, cost: float
                      ) -> Tuple[np.ndarray, np.ndarray, float]:
        """Host label mapping of a device-backtraced arc sequence
        (given newest-first, length n)."""
        g = self.g
        n_e = g.num_emitting_arcs
        fwd = arcs[:n][::-1].astype(np.int64)
        eps = fwd >= n_e
        ol = np.where(eps, g.n_olabel[np.where(eps, fwd - n_e, 0)],
                      g.e_olabel[np.where(eps, 0, fwd)])
        words = ol[ol > 0].astype(np.int32)
        tids = g.e_ilabel[fwd[~eps]].astype(np.int32)
        return tids, words, float(cost)

    def decode_batch(
        self, loglikes: List[np.ndarray], pad_frames: int = 0
    ) -> List[Tuple[np.ndarray, np.ndarray, float]]:
        """Best-path decode; same contract as TpuViterbiDecoder:
        per utterance (tids, word ids, total cost).  Runs the
        lattice-free jit variant and backtraces on device; only the arc
        sequences cross to the host."""
        r, am, lengths = self._run(loglikes, pad_frames, a_lat=0,
                                   to_host=False)
        fs_all = jnp.concatenate([r["init"][0][:, None], jnp.swapaxes(
            r["fs"], 0, 1)], axis=1)           # [B, T+1, K]
        fc_all = jnp.concatenate([r["init"][1][:, None], jnp.swapaxes(
            r["fc"], 0, 1)], axis=1)
        ba_all = jnp.concatenate([r["init"][2][:, None], jnp.swapaxes(
            r["bp_arc"], 0, 1)], axis=1)
        bp_all = jnp.concatenate([r["init"][3][:, None], jnp.swapaxes(
            r["bp_prev"], 0, 1)], axis=1)
        B = len(loglikes)
        key = ("bt", fs_all.shape[0], fs_all.shape[1])
        if key not in self._jit_cache:
            self._jit_cache[key] = jax.jit(self._backtrace_impl)
        arcs, ns, costs, fails, empties = jax.device_get(
            self._jit_cache[key](fs_all[:B], fc_all[:B], ba_all[:B],
                                 bp_all[:B], jnp.asarray(lengths)))
        out = []
        r_host = None
        for b in range(B):
            if empties[b]:
                out.append((np.zeros(0, np.int32), np.zeros(0, np.int32),
                            float("inf")))
            elif fails[b]:
                # rare: an eps predecessor was evicted — fetch this
                # utterance's history and repair on the host
                if r_host is None:
                    r_host = {
                        "init": tuple(np.asarray(x) for x in r["init"]),
                        "fs": np.asarray(r["fs"]),
                        "fc": np.asarray(r["fc"]),
                        "bp_arc": np.asarray(r["bp_arc"]),
                        "bp_prev": np.asarray(r["bp_prev"]),
                    }
                out.append(self._best_path(r_host, am, int(lengths[b]),
                                           b))
            else:
                out.append(self._arcs_to_path(arcs[b], int(ns[b]),
                                              float(costs[b])))
        return out

    def _level(self, r, t, b):
        """(states, costs[, bp_arc, bp_prev]) at level t (0 = init).
        Backpointer entries exist only in best-path (a_lat=0) runs —
        the lattice variant does not compute them."""
        if t == 0:
            return tuple(np.asarray(x[b]) for x in r["init"])
        return tuple(np.asarray(r[k][t - 1, b])
                     for k in ("fs", "fc", "bp_arc", "bp_prev")
                     if k in r)

    def _best_path(self, r, am, T, b, use_final: bool = True):
        g = self.g
        fs, fc, _, _ = self._level(r, T, b)
        valid = fs != INVALID
        if not valid.any():
            return np.zeros(0, np.int32), np.zeros(0, np.int32), float("inf")
        if use_final:
            total = np.where(valid, fc + g.final[np.where(valid, fs, 0)],
                             BIG)
        else:
            total = np.where(valid, fc, BIG)
        slot = int(np.argmin(total))
        cost = float(total[slot])
        if cost >= BIG:        # no final state reached: best active token
            total = np.where(valid, fc, BIG)
            slot = int(np.argmin(total))
            cost = float(total[slot])
        tids_r: List[int] = []
        words_r: List[int] = []
        t = T
        n_e = g.num_emitting_arcs
        guard = 0
        while t >= 0:
            guard += 1
            if guard > (T + 2) * (self.eps_iters + 2):
                raise RuntimeError("backtrace loop")
            fs_t, fc_t, bp_arc, bp_prev = self._level(r, t, b)
            a, p = int(bp_arc[slot]), int(bp_prev[slot])
            if a < 0:
                if t == 0 and fs_t[slot] == g.start:
                    break
                # unresolved: eps predecessor was evicted; repair on host
                slot2, t2, tids2, words2 = self._host_fix(
                    r, am, t, b, slot)
                tids_r.extend(tids2)
                words_r.extend(words2)
                slot, t = slot2, t2
                continue
            if a >= n_e:                  # eps arc, same level
                a -= n_e
                if g.n_olabel[a] > 0:
                    words_r.append(int(g.n_olabel[a]))
                slot = p
            else:                         # emitting arc, previous level
                tids_r.append(int(g.e_ilabel[a]))
                if g.e_olabel[a] > 0:
                    words_r.append(int(g.e_olabel[a]))
                slot = p
                t -= 1
        return (np.asarray(tids_r[::-1], np.int32),
                np.asarray(words_r[::-1], np.int32), cost)

    def _host_fix(self, r, am, t, b, slot):
        """Recompute one frame's token chains on the host (numpy, exact)
        when a device backpointer was left unresolved.  Returns the slot
        and level to continue from plus the labels collected."""
        g = self.g
        fs_t, fc_t, _, _ = self._level(r, t, b)
        state = int(fs_t[slot])
        if t == 0:
            pstates = np.asarray([g.start]); pcosts = np.asarray([0.0])
        else:
            pfs, pfc, _, _ = self._level(r, t - 1, b)
            keep = pfs != INVALID
            pstates, pcosts = pfs[keep], pfc[keep]
        # emitting relax (skipped at level 0)
        cost = {}
        via = {}
        if t > 0:
            row = am[b, t - 1]
            for ps, pc in zip(pstates.tolist(), pcosts.tolist()):
                for a in range(g.e_off[ps], g.e_off[ps + 1]):
                    c = pc + g.e_w[a] + float(self.acoustic_scale) \
                        * float(row[g.e_pdf[a]])
                    dd = int(g.e_dst[a])
                    if c < cost.get(dd, BIG):
                        cost[dd] = c
                        via[dd] = ("e", a, int(ps))
        else:
            cost[g.start] = 0.0
            via[g.start] = None
        # eps closure to fixpoint
        for _ in range(self.eps_iters + 1):
            changed = False
            for s in list(cost):
                for a in range(g.n_off[s], g.n_off[s + 1]):
                    c = cost[s] + float(g.n_w[a])
                    dd = int(g.n_dst[a])
                    if c < cost.get(dd, BIG) - 1e-6:
                        cost[dd] = c
                        via[dd] = ("n", a, s)
                        changed = True
            if not changed:
                break
        if state not in via:
            raise RuntimeError("host backtrace repair failed")
        tids, words = [], []
        s = state
        while via.get(s) is not None:
            kind, a, ps = via[s]
            if kind == "n":
                if g.n_olabel[a] > 0:
                    words.append(int(g.n_olabel[a]))
                s = ps
            else:
                tids.append(int(g.e_ilabel[a]))
                if g.e_olabel[a] > 0:
                    words.append(int(g.e_olabel[a]))
                # continue from the predecessor token at level t-1
                pfs, _, _, _ = self._level(r, t - 1, b)
                slots = np.nonzero(pfs == ps)[0]
                if len(slots) == 0:
                    raise RuntimeError("host repair: predecessor missing")
                return int(slots[0]), t - 1, tids, words
        # reached the start state inside level 0
        return 0, -1, tids, words

    # -- lattice path ------------------------------------------------------
    @staticmethod
    def _derive_lattice_arcs(max_active: int) -> int:
        """Initial per-frame lattice record capacity derived from the
        token budget: a frame's records are the candidate arcs of the
        <=K surviving tokens that pass the per-destination lattice-beam
        cut, and at reference settings (beam 15 / lattice-beam 8 /
        max-active 7000 on the 1.17M-arc bench graph) the densest
        frames carry up to ~1.7*K records (at K=7000 a capacity of 8192
        still clipped, 16384 did not).  2*K
        rounded up to a power of two covers that with headroom, so the
        cold decode pays zero auto-grow re-decodes; auto-grow still
        backstops pathological graphs."""
        return 1 << max(11, (2 * int(max_active) - 1).bit_length())

    @staticmethod
    def _overflow_from_counts(init_cnt, e_cnt, n_cnt, lengths, cap
                              ) -> Tuple[int, int]:
        """(arcs dropped, frames affected) across the batch: per-frame
        candidate counts above A_lat mean _compact clipped that frame's
        lattice arcs (the 'no silent caps' rule — surfaced, not
        swallowed)."""
        dropped, frames = 0, 0
        for b, T in enumerate(lengths):
            cnts = np.concatenate(
                [init_cnt[b:b + 1], e_cnt[:T, b], n_cnt[:T, b]])
            over = np.maximum(cnts.astype(np.int64) - cap, 0)
            dropped += int(over.sum())
            frames += int((over > 0).sum())
        return dropped, frames

    def _fetch_lattice_run(self, r, lengths, i_cnt, e_cnt, n_cnt):
        """Host-fetch of a lattice run, minimized in bytes and
        dispatches: per-frame counts come first (tiny), the record
        buffers are truncated on device to the largest count actually
        used before crossing, the state history crosses as a 1-byte
        validity mask (assembly only needs which slots are alive), and
        only the per-utterance FINAL level's states cross in full (for
        final weights).  The whole preparation runs as ONE jitted
        call + ONE device_get instead of eager slicing per array."""
        B = len(lengths)
        A = int(self.A_lat)
        # exact per-utterance stored-record totals (counts are already
        # on the host), so the transfer is sized by the DATA, not by
        # T * max-frame-count: early frames of a wide beam emit
        # thousands of near-tie records and inflated the per-frame
        # layout to ~800 MB / batch at bench scale
        Ls = lengths.astype(np.int64)
        msk = np.arange(e_cnt.shape[0])[:, None] < Ls[None, :]
        ce = int((np.minimum(e_cnt, A) * msk).sum(0).max(initial=0))
        cn = int((np.minimum(n_cnt, A) * msk).sum(0).max(initial=0)
                 + np.minimum(i_cnt, A).max(initial=0))
        ce = max(-(-max(ce, 1) // 4096) * 4096, 4096)
        cn = max(-(-max(cn, 1) // 4096) * 4096, 4096)
        T = r["fs"].shape[0]
        key = ("fetch", B, T, ce, cn)
        if key not in self._jit_cache:
            def compress(src, dst, arc, cnts, lvl0, L, cap):
                """[Trows, A] records -> flat [cap] (src, dst, arc,
                level) with -1 padding; level = row + lvl0."""
                rows = src.shape[0]
                lvl = jax.lax.broadcasted_iota(jnp.int32, (rows, A), 0)
                j = jax.lax.broadcasted_iota(jnp.int32, (rows, A), 1)
                ok = ((j < jnp.minimum(cnts[:, None], A))
                      & (lvl + lvl0 <= L) & (src >= 0) & (dst >= 0))
                take = min(cap, rows * A)
                order = jnp.argsort(jnp.logical_not(ok).ravel(),
                                    stable=True)[:take]
                n = jnp.minimum(jnp.sum(ok), take)
                live = jnp.arange(take) < n
                pad = cap - take
                out = tuple(jnp.pad(jnp.where(live, x.ravel()[order], -1),
                                    (0, pad), constant_values=-1)
                            for x in (src, dst, arc, lvl + lvl0))
                return out, n

            def fetch_impl(init_fs, fs, e_rec, n_rec, i_rec, i_c, lens):
                fs_all = jnp.concatenate([init_fs[None], fs], 0)[:, :B]
                fsT = jax.vmap(lambda a, t: jax.lax.dynamic_index_in_dim(
                    a, t, 0, False), in_axes=(1, 0))(fs_all, lens)

                def per_utt(e3, n3, i3, ic, L):
                    # emit rows: frame i holds arcs into level i+1
                    e_out, e_n = compress(e3[0], e3[1], e3[2], e3[3],
                                          1, L, ce)
                    nsrc = jnp.concatenate([i3[0][None], n3[0]])
                    ndst = jnp.concatenate([i3[1][None], n3[1]])
                    narc = jnp.concatenate([i3[2][None], n3[2]])
                    ncnt = jnp.concatenate([ic[None], n3[3]])
                    n_out, n_n = compress(nsrc, ndst, narc, ncnt,
                                          0, L, cn)
                    return e_out, e_n, n_out, n_n

                e_all = tuple(jnp.moveaxis(x, 1, 0) for x in e_rec)
                n_all = tuple(jnp.moveaxis(x, 1, 0) for x in n_rec)
                return jax.vmap(per_utt)(
                    e_all, n_all, i_rec, i_c, lens), fsT
            self._jit_cache[key] = jax.jit(fetch_impl)
        (e_out, e_n, n_out, n_n), fsT = jax.device_get(
            self._jit_cache[key](
                r["init"][0], r["fs"],
                tuple(x[:, :B] for x in r["e_rec"][:3])
                + (r["e_rec"][3][:, :B],),
                tuple(x[:, :B] for x in r["n_rec"][:3])
                + (r["n_rec"][3][:, :B],),
                tuple(x[:B] for x in r["init_eps"][:3]),
                r["init_eps"][3][:B], jnp.asarray(lengths)))
        return {"e": tuple(np.asarray(x) for x in e_out)
                + (np.asarray(e_n),),
                "n": tuple(np.asarray(x) for x in n_out)
                + (np.asarray(n_n),),
                "fsT": np.asarray(fsT)}

    def decode_batch_lattice(self, loglikes: List[np.ndarray],
                             determinize: bool = True,
                             auto_grow: bool = True,
                             max_grow: int = 3,
                             pad_frames: int = 0) -> List[Lattice]:
        """Batched lattice decode.  ``determinize`` applies word-level
        lattice determinization to each assembled lattice, completing
        the reference's GetRawLattice -> DeterminizeLatticePruned
        pipeline (ref: lat/determinize-lattice-pruned.cc) so no
        duplicate word sequences reach rescoring/MBR.  ``auto_grow``
        re-runs with doubled ``lattice_arcs_per_frame`` (up to
        ``max_grow`` doublings) when per-frame arc buffers overflowed;
        any residual overflow is logged, never silent."""
        assert self.A_lat > 0, \
            "construct with lattice_arcs_per_frame > 0 for lattice output"
        from kaldi_cnn_tpu.core.logging import get_logger
        logger = get_logger(__name__)
        for attempt in range(max_grow + 1):
            r, am, lengths = self._run(loglikes, pad_frames,
                                       to_host=False)
            B = len(lengths)
            i_cnt = np.asarray(jax.device_get(r["init_eps"][3]))[:B]
            e_cnt = np.asarray(jax.device_get(r["e_rec"][3]))[:, :B]
            n_cnt = np.asarray(jax.device_get(r["n_rec"][3]))[:, :B]
            dropped, frames = self._overflow_from_counts(
                i_cnt, e_cnt, n_cnt, lengths, self.A_lat)
            if dropped == 0 or not auto_grow or attempt == max_grow:
                break
            new_cap = self.A_lat * 2
            logger.warning(
                "lattice buffers overflowed: %d arcs dropped on %d "
                "frames at lattice_arcs_per_frame=%d; re-running with "
                "%d", dropped, frames, self.A_lat, new_cap)
            self.A_lat = new_cap
        self.last_overflow = (dropped, frames)
        if dropped:
            logger.warning(
                "lattice overflow (final): %d arcs dropped on %d frames "
                "at lattice_arcs_per_frame=%d — lattices are thinner "
                "than the lattice beam implies", dropped, frames,
                self.A_lat)
        fetch = self._fetch_lattice_run(r, lengths, i_cnt, e_cnt, n_cnt)
        lats = [self._assemble_lattice(fetch, am, int(lengths[b]), b)
                for b in range(len(loglikes))]
        if determinize:
            from kaldi_cnn_tpu.decode.lattice import determinize_lattice
            lats = [determinize_lattice(
                lat, lm_scale=1.0,
                acoustic_scale=float(self.acoustic_scale))
                for lat in lats]
        return lats

    def _assemble_lattice(self, fetch, am, T, b) -> Lattice:
        """Builds one utterance's Lattice from the minimized host fetch
        (validity mask + truncated record buffers, _fetch_lattice_run).
        Fully vectorized over levels — the per-level Python loop cost
        ~22 s per 16-utterance batch at bench scale."""
        g = self.g
        K = self.K
        # compact per-utterance records (flat, -1-padded; see
        # _fetch_lattice_run): emit entries carry their DST level,
        # eps entries their (same-src/dst) level
        esb, edb, eab, elv = (x[b][:int(fetch["e"][4][b])]
                              for x in fetch["e"][:4])
        nsb, ndb, nab, nlv = (x[b][:int(fetch["n"][4][b])]
                              for x in fetch["n"][:4])
        esb_c = np.clip(esb, 0, K - 1)
        edb_c = np.clip(edb, 0, K - 1)
        nsb_c = np.clip(nsb, 0, K - 1)
        ndb_c = np.clip(ndb, 0, K - 1)

        # number ONLY tokens that appear as a record endpoint (every
        # beam-surviving token's achieving arc is itself a record, so
        # connected tokens are covered; the rest — possibly millions of
        # beam-survivors at K=7000 — would only bloat prune_lattice)
        used = np.zeros((T + 1, K), bool)
        used[elv - 1, esb_c] = True
        used[elv, edb_c] = True
        used[nlv, nsb_c] = True
        used[nlv, ndb_c] = True
        fsT = fetch["fsT"][b]
        if not (len(esb) or len(nsb)):      # nothing survived: empty
            return Lattice(
                num_states=1, start=0,
                state_time=np.zeros(1, np.int32),
                arc_src=np.zeros(0, np.int32),
                arc_dst=np.zeros(0, np.int32),
                arc_ilabel=np.zeros(0, np.int32),
                arc_olabel=np.zeros(0, np.int32),
                arc_graph=np.zeros(0, np.float32),
                arc_acoustic=np.zeros(0, np.float32),
                final_graph=np.zeros(1, np.float32))
        flat = used.ravel()
        node = np.where(flat, np.cumsum(flat) - 1, -1).reshape(T + 1, K)
        nid = max(int(flat.sum()), 1)
        times = np.repeat(np.arange(T + 1), used.sum(axis=1))

        a_src = [node[elv - 1, esb_c]]
        a_dst = [node[elv, edb_c]]
        a_il = [g.e_ilabel[eab]]
        a_ol = [g.e_olabel[eab]]
        a_gw = [g.e_w[eab]]
        a_ac = [am[b][elv - 1, g.e_pdf[eab]]]
        a_src.append(node[nlv, nsb_c])
        a_dst.append(node[nlv, ndb_c])
        a_il.append(np.zeros(len(nab), np.int32))
        a_ol.append(g.n_olabel[nab])
        a_gw.append(g.n_w[nab])
        a_ac.append(np.zeros(len(nab), np.float32))

        final_graph = np.full(nid, np.inf, np.float32)
        last = used[T]
        final_graph[node[T, last]] = g.final[
            np.where(fsT[last] == INVALID, 0, fsT[last])]
        lat = Lattice(
            num_states=nid, start=0,
            state_time=np.asarray(times, np.int32),
            arc_src=np.concatenate(a_src).astype(np.int32),
            arc_dst=np.concatenate(a_dst).astype(np.int32),
            arc_ilabel=np.concatenate(a_il).astype(np.int32),
            arc_olabel=np.concatenate(a_ol).astype(np.int32),
            arc_graph=np.concatenate(a_gw).astype(np.float32),
            arc_acoustic=np.concatenate(a_ac).astype(np.float32),
            final_graph=final_graph)
        if not np.isfinite(lat.final_graph).any():
            lat.final_graph[node[T, last]] = 0.0
        return prune_lattice(lat, self.lattice_beam, lm_scale=1.0,
                             acoustic_scale=float(self.acoustic_scale))


# ---------------------------------------------------------------------------
# Streaming (chunked) decode on the same device kernel
# ---------------------------------------------------------------------------

class TpuStreamingDecoder:
    """AdvanceDecoding-style chunked interface over ``TpuTopKDecoder``
    (ref: online2/online-nnet2-decoding.cc
    SingleUtteranceNnet2Decoder::AdvanceDecoding): feed acoustic chunks
    as they arrive; token state (the sorted top-K active set) carries
    across chunk boundaries on device.

    Exactly matches offline ``decode_batch`` of the same rows: the
    acoustic-lookahead ranking needs frame t+1's row when pruning frame
    t, so one frame is held back per ``advance`` and flushed by
    ``finalize()`` using itself as lookahead — the offline scan's
    shift-and-duplicate-last, reproduced incrementally.

    Host memory is BOUNDED (ref: lattice-faster-decoder.cc keeps pruned
    backpointers, not full frames — PruneActiveTokens): only a
    traceback window of recent levels is retained.  Every
    ``commit_every`` frames the decoder checks whether all live tokens
    share a single ancestor token at an anchor level (each token's
    Viterbi backpointer is unique, so once paths re-merge the surviving
    ancestor IS unique); if so, the path segment up to that ancestor is
    final regardless of future audio — its labels are committed, the
    window is dropped up to the anchor, and partial/final traceback
    walks only the committed labels plus the short window.  Endpoint
    polling is therefore O(window), not O(stream).  The commit changes
    nothing vs offline decode: only provably-final prefixes commit.
    ``max_history`` (frames) optionally force-commits along the current
    best token when genuinely parallel hypotheses keep the window from
    converging — a hard memory bound at the cost of exactness in that
    (pathological) case; default off."""

    # chunk sizes the scan jit specializes on: a chunk of C frames is
    # processed as greedy blocks from this ladder (32+8+1+... covers
    # any C with <=3 compiled shapes), each block ONE jit dispatch +
    # ONE host fetch instead of per-frame round-trips
    CHUNK_BLOCKS = (32, 8, 1)

    def __init__(self, decoder: TpuTopKDecoder,
                 frame_shift_sec: float = 0.01,
                 commit_every: int = 24,
                 max_history: Optional[int] = None,
                 walk_limit: Optional[int] = None):
        self.dec = decoder
        self.frame_shift = frame_shift_sec
        self.commit_every = int(commit_every)
        self.max_history = max_history
        # commit checks walk at most this many recent levels, keeping
        # the per-check cost O(1) in the stream length even when live
        # hypotheses refuse to converge (e.g. an effectively infinite
        # beam keeps parallel token families alive forever)
        self.walk_limit = (max(256, 8 * self.commit_every)
                           if walk_limit is None else int(walk_limit))
        self._jit_frame = None
        self._jit_init = None
        self._jit_chunks: Dict[int, object] = {}
        self.reset()

    def reset(self) -> None:
        self._pending: Optional[np.ndarray] = None   # held-back raw row
        self._state = None                           # (fs, fc) on device
        self.num_frames = 0                          # processed frames
        # committed-prefix state (see class docstring)
        self._frontier: Optional[Tuple[np.ndarray, ...]] = None
        self._frontier_slot: int = 0
        self._buf: List[Tuple[np.ndarray, ...]] = []  # levels after frontier
        self._ctids: List[int] = []                   # committed labels
        self._cwords: List[int] = []
        self._since_check = 0

    def _jits(self):
        if self._jit_frame is None:
            dec = self.dec

            def frame_fn(fs, fc, am_row, am_next_row):
                # a_lat=0: the streaming path keeps no lattice records,
                # so use the lattice-free (cheaper) frame variant
                return dec._frame(fs, fc, am_row, am_next_row, 0)[:4]

            def init_fn(am_row0):
                k = dec.K
                s0 = jnp.full((k,), INVALID, jnp.int32).at[0].set(
                    dec.g.start)
                c0 = jnp.full((k,), BIG).at[0].set(0.0)
                fs0, fc0 = dec._eps_fixpoint(s0, c0, dec._am_ext(am_row0))
                root = jnp.full((k,), -1, jnp.int32)
                bp_a, bp_p = dec._resolve_bp(fs0, fc0, s0, c0, root, root)
                return fs0, fc0, bp_a, bp_p

            self._jit_frame = jax.jit(frame_fn)
            self._jit_init = jax.jit(init_fn)
        return self._jit_frame, self._jit_init

    def _chunk_fn(self, size: int):
        """jit-cached scan over ``size`` frames: ONE dispatch runs the
        whole block on device (the offline _decode_impl scan shape,
        incremental) and returns every level's (fs, fc, bp_arc,
        bp_prev) stacked for a single host fetch."""
        if size not in self._jit_chunks:
            dec = self.dec

            def chunk(fs, fc, am_rows, am_next_rows):
                def body(carry, x):
                    out = dec._frame(carry[0], carry[1], x[0], x[1],
                                     0)[:4]
                    return (out[0], out[1]), out
                carry, levels = jax.lax.scan(
                    body, (fs, fc), (am_rows, am_next_rows))
                return carry, levels

            self._jit_chunks[size] = jax.jit(chunk)
        return self._jit_chunks[size]

    def _ensure_init(self, am_row0: np.ndarray) -> None:
        if self._state is not None:
            return
        _, init_fn = self._jits()
        out = init_fn(jnp.asarray(am_row0))
        lvl = tuple(np.asarray(x) for x in out)
        self._frontier = lvl + (None,)
        root = np.nonzero((lvl[2] < 0)
                          & (lvl[0] == self.dec.g.start))[0]
        self._frontier_slot = int(root[0]) if len(root) else 0
        self._state = (out[0], out[1])

    def _append_level(self, lvl: Tuple[np.ndarray, ...]) -> None:
        """Host bookkeeping for one processed frame: retain the level
        in the traceback window, run the commit-cadence checks."""
        self._buf.append(lvl)
        self.num_frames += 1
        self._since_check += 1
        if self._since_check >= self.commit_every:
            self._since_check = 0
            self._try_commit()
        if self.max_history and len(self._buf) > self.max_history:
            self._force_commit()

    def advance(self, loglikes: np.ndarray) -> None:
        """Feed [n, num_pdfs] acoustic log-likelihoods.  Frames run on
        device in scan blocks (CHUNK_BLOCKS) — one jit dispatch + one
        batched level fetch per block, not ~2 round-trips per frame."""
        rows = -np.asarray(loglikes, np.float32)
        if rows.size == 0:
            return
        if self._pending is not None:
            rows = np.concatenate([self._pending[None], rows])
        if len(rows) < 2:
            self._pending = rows[-1]
            return
        self._ensure_init(rows[0])
        i, n = 0, len(rows) - 1
        while i < n:
            size = next(b for b in self.CHUNK_BLOCKS if b <= n - i)
            am = rows[i:i + size]
            amn = rows[i + 1:i + 1 + size]
            carry, levels = self._chunk_fn(size)(
                self._state[0], self._state[1], jnp.asarray(am),
                jnp.asarray(amn))
            self._state = carry
            levels_np = jax.device_get(levels)
            for j in range(size):
                self._append_level(
                    tuple(x[j] for x in levels_np) + (am[j],))
            i += size
        self._pending = rows[-1]

    def finalize(self) -> None:
        """Flush the held-back frame (end of input)."""
        if self._pending is not None:
            self._step(self._pending, self._pending)
            self._pending = None

    def _step(self, am_row: np.ndarray, am_next_row: np.ndarray) -> None:
        frame_fn, _ = self._jits()
        self._ensure_init(am_row)
        outs = frame_fn(self._state[0], self._state[1],
                        jnp.asarray(am_row), jnp.asarray(am_next_row))
        self._state = (outs[0], outs[1])
        lvl = tuple(np.asarray(o) for o in outs) + (np.asarray(am_row),)
        self._append_level(lvl)

    # -- committed-prefix machinery ---------------------------------------
    def _collapse_eps(self, lvl, cur: np.ndarray) -> np.ndarray:
        """Map token slots to their within-level eps-ROOT slot (a path
        through an eps-descendant also passes through its root); broken
        chains go to -1 only if an unresolved backpointer interrupts."""
        _, _, ba, bp = lvl[:4]
        hi = len(ba) - 1
        n_e = self.dec.g.num_emitting_arcs
        for _ in range(self.dec.eps_iters + 1):
            a = ba[np.clip(cur, 0, hi)]
            is_eps = (cur >= 0) & (a >= n_e)
            if not is_eps.any():
                break
            cur = np.where(is_eps, bp[np.clip(cur, 0, hi)], cur)
        return cur

    def _emit_hop(self, lvl, cur: np.ndarray) -> np.ndarray:
        """Map eps-root slots at one level to their emitting-predecessor
        slots at the previous level (-1 when unresolved)."""
        _, _, ba, bp = lvl[:4]
        hi = len(ba) - 1
        cur_c = np.clip(cur, 0, hi)
        a = ba[cur_c]
        n_e = self.dec.g.num_emitting_arcs
        return np.where((cur >= 0) & (a >= 0) & (a < n_e), bp[cur_c], -1)

    def _step_back(self, lvl, cur: np.ndarray) -> np.ndarray:
        return self._emit_hop(lvl, self._collapse_eps(lvl, cur))

    def _try_commit(self) -> None:
        """Walk the live tokens' backpointer chains backward through the
        window; the LATEST level at which all chains pass through one
        token (an eps-root shared by every chain) is provably on the
        final path no matter what audio follows — Viterbi backpointers
        are unique per token, so merged paths stay merged — and the
        prefix up to it commits."""
        W = len(self._buf)
        if W == 0:
            return
        valid = self._buf[-1][0] != INVALID
        if not valid.any():
            return
        K = self.dec.K
        cur = np.where(valid, np.arange(K), -1)
        for i in range(W, max(W - self.walk_limit, -1), -1):
            lvl = self._buf[i - 1] if i > 0 else self._frontier
            cur = self._collapse_eps(lvl, cur)
            if (cur[valid] < 0).any():     # a chain broke: cannot prove
                return
            u = np.unique(cur[valid])
            if len(u) == 1:
                self._commit_to(i, int(u[0]))
                return
            if i > 0:
                cur = self._emit_hop(lvl, cur)
                if (cur[valid] < 0).any():
                    return

    def _force_commit(self) -> None:
        """max_history exceeded: commit along the CURRENT BEST token's
        path even though other live tokens disagree (forced partial
        traceback — bounded memory, approximate in the non-converging
        case; see class docstring)."""
        W = len(self._buf)
        target = W - max(self.max_history // 2, 1)
        if target < 0:
            return
        fs, fc = self._buf[-1][:2]
        valid = fs != INVALID
        if not valid.any():
            return
        s = np.asarray([int(np.argmin(np.where(valid, fc, BIG)))])
        for i in range(W, target, -1):
            s = self._step_back(self._buf[i - 1], s)
            if s[0] < 0:
                return
        s = self._collapse_eps(
            self._buf[target - 1] if target > 0 else self._frontier, s)
        if s[0] < 0:
            return
        self._commit_to(target, int(s[0]))

    def _commit_to(self, off: int, slot: int) -> None:
        try:
            tids, words = self._trace(off, slot)
        except RuntimeError:
            return          # rare unresolved chain: retry a later check
        self._ctids.extend(tids)
        self._cwords.extend(words)
        if off > 0:
            self._frontier = self._buf[off - 1]
            self._buf = self._buf[off:]
        self._frontier_slot = slot

    def _level_host(self, i: int) -> Tuple[np.ndarray, ...]:
        """Window level i: 0 = the committed frontier, i = _buf[i-1]."""
        return self._frontier if i == 0 else self._buf[i - 1]

    def _trace(self, i: int, slot: int
               ) -> Tuple[List[int], List[int]]:
        """Backpointer walk from (window level i, slot) back to the
        committed frontier token; forward-order (tids, words)."""
        g = self.dec.g
        n_e = g.num_emitting_arcs
        tids_r: List[int] = []
        words_r: List[int] = []
        guard, limit = 0, (i + 2) * (self.dec.eps_iters + 2) + 16
        while not (i == 0 and slot == self._frontier_slot):
            guard += 1
            if guard > limit:
                raise RuntimeError("streaming traceback loop")
            _, _, ba, bp = self._level_host(i)[:4]
            a, p = int(ba[slot]), int(bp[slot])
            if a < 0 or (i == 0 and a < n_e):
                if i == 0:
                    raise RuntimeError(
                        "streaming traceback: chain does not reach the "
                        "commit frontier")
                slot, i2, tids2, words2 = self._window_fix(i, slot)
                i = i2
                tids_r.extend(tids2)
                words_r.extend(words2)
                continue
            if a >= n_e:
                a -= n_e
                if g.n_olabel[a] > 0:
                    words_r.append(int(g.n_olabel[a]))
                slot = p
            else:
                tids_r.append(int(g.e_ilabel[a]))
                if g.e_olabel[a] > 0:
                    words_r.append(int(g.e_olabel[a]))
                slot = p
                i -= 1
        return tids_r[::-1], words_r[::-1]

    def _window_fix(self, i: int, slot: int):
        """Host repair of an unresolved backpointer inside the window
        (the streaming analogue of TpuTopKDecoder._host_fix; window
        level 0 — the committed frontier — plays the init role)."""
        levels = [self._level_host(j)
                  for j in range(len(self._buf) + 1)]
        r = {"init": tuple(x[None] for x in levels[0][:4])}
        for j, name in enumerate(("fs", "fc", "bp_arc", "bp_prev")):
            r[name] = np.stack([lv[j] for lv in levels[1:]])[:, None]
        am = np.stack([lv[4] for lv in levels[1:]])[None]
        return self.dec._host_fix(r, am, i, 0, slot)

    def best_path(self, use_final: bool = True
                  ) -> Tuple[np.ndarray, np.ndarray, float]:
        """Current best (tids, words, cost) over the processed frames —
        committed prefix + traceback over the retained window only."""
        if self._state is None:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                    float("inf"))
        g = self.dec.g
        fs, fc = self._level_host(len(self._buf))[:2]
        valid = fs != INVALID
        if not valid.any():
            return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                    float("inf"))
        if use_final:
            total = np.where(valid, fc + g.final[np.where(valid, fs, 0)],
                             BIG)
        else:
            total = np.where(valid, fc, BIG)
        slot = int(np.argmin(total))
        cost = float(total[slot])
        if cost >= BIG:      # no final state reached: best active token
            total = np.where(valid, fc, BIG)
            slot = int(np.argmin(total))
            cost = float(total[slot])
        tids, words = self._trace(len(self._buf), slot)
        return (np.asarray(self._ctids + tids, np.int32),
                np.asarray(self._cwords + words, np.int32), cost)

    # -- endpointing (same rules as the host online decoder) --------------
    def trailing_silence_frames(self, trans_model, silence_phone: int
                                ) -> int:
        tids, _, _ = self.best_path(use_final=False)
        n = 0
        for tid in tids[::-1]:
            if trans_model.id_to_phone(int(tid)) == silence_phone:
                n += 1
            else:
                break
        return n

    def endpoint_detected(self, trans_model, silence_phone: int,
                          config=None) -> bool:
        """(ref: online-endpoint.cc EndpointDetected, over the top-K
        active set instead of the dense cost vector)."""
        from kaldi_cnn_tpu.online2.decoder import EndpointConfig
        config = config or EndpointConfig()
        t = self.num_frames
        if t == 0:
            return False
        utt_sec = t * self.frame_shift
        _, words, _ = self.best_path(use_final=False)
        trailing_sec = self.trailing_silence_frames(
            trans_model, silence_phone) * self.frame_shift
        said_something = len(words) > 0
        if not said_something and utt_sec >= config.silence_timeout_sec:
            return True
        r = config.rule_trailing
        if said_something or not r.must_contain_nonsilence:
            if (trailing_sec >= r.min_trailing_silence_sec
                    and utt_sec >= r.min_utterance_length_sec):
                fs, fc = self._level_host(len(self._buf))[:2]
                valid = fs != INVALID
                if valid.any():
                    final = self.dec.g.final[np.where(valid, fs, 0)]
                    best_final = float(np.min(np.where(
                        valid, fc + final, BIG)))
                    best_any = float(np.min(np.where(valid, fc, BIG)))
                    if (best_final < BIG and
                            best_final - best_any <= r.max_relative_cost):
                        return True
        if utt_sec >= config.max_utterance_length_sec:
            return True
        return False


# ---------------------------------------------------------------------------
# Production entry point: the decode path of the recipes and CLI verbs
# ---------------------------------------------------------------------------

def decode_utterances(graph: CompiledGraph,
                      loglikes: "Dict[str, np.ndarray]",
                      acoustic_scale: float = 0.1,
                      beam: float = 16.0,
                      lattice_beam: float = 8.0,
                      max_active: int = 7000,
                      lattice_arcs_per_frame: Optional[int] = None,
                      batch_size: int = 16,
                      bucket_frames: int = 128,
                      mesh=None,
                      determinize: bool = True,
                      decoder: Optional[TpuTopKDecoder] = None
                      ) -> "Dict[str, Lattice]":
    """Batched on-device lattice decode of a keyed utterance set — the
    production decode path (ref: nnet2bin/nnet-latgen-faster.cc's role:
    acoustic scoring AND token passing both on-device, erasing the
    GPU-scores/CPU-search split of SURVEY.md §3.4; the post-pass
    determinization mirrors GetRawLattice -> DeterminizeLatticePruned).

    Utterances are bucketed by padded length (multiples of
    ``bucket_frames``) and decoded in fixed-size batches so the jit
    specializes once per (bucket, batch) shape; short final batches are
    padded by repeating the last utterance and the duplicates dropped.

    ``lattice_arcs_per_frame=None`` (default) derives the record
    capacity from ``max_active`` (TpuTopKDecoder._derive_lattice_arcs)
    so cold decodes don't pay overflow re-decodes + re-compiles.
    """
    dec = decoder or TpuTopKDecoder(
        graph, beam=beam, max_active=max_active,
        acoustic_scale=acoustic_scale, lattice_beam=lattice_beam,
        lattice_arcs_per_frame=lattice_arcs_per_frame, mesh=mesh)
    assert dec.A_lat > 0
    buckets: "Dict[int, List[str]]" = {}
    for utt in sorted(loglikes):
        t = loglikes[utt].shape[0]
        tb = -(-max(t, 1) // bucket_frames) * bucket_frames
        buckets.setdefault(tb, []).append(utt)
    out: "Dict[str, Lattice]" = {}
    for tb in sorted(buckets):
        us = buckets[tb]
        for i in range(0, len(us), batch_size):
            chunk = us[i:i + batch_size]
            lls = [np.asarray(loglikes[u], np.float32) for u in chunk]
            n_pad = batch_size - len(chunk)
            if n_pad:
                lls = lls + [lls[-1]] * n_pad
            lats = dec.decode_batch_lattice(lls, determinize=determinize,
                                            pad_frames=tb)
            out.update(zip(chunk, lats[:len(chunk)]))
    return out

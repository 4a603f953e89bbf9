"""Batched dense on-device Viterbi beam search over CSR-packed HCLG.

A JAX re-design of src/decoder/lattice-faster-decoder.cc
(and faster-decoder.cc): the reference's per-frame hash-map token
passing (ProcessEmitting / ProcessNonemitting, scalar CPU code) becomes
dense vectorized relaxation entirely on device, batched over
utterances:

  per frame (one lax.scan step, all inside jit):
    cand[a]  = cost[src[a]] + graph_w[a] + scale * am[t, pdf[a]]
    cost'[s] = segment_min over arcs into s        (ProcessEmitting)
    L unrolled eps sweeps of the same form         (ProcessNonemitting)
    beam / max-active pruning by thresholding      (PruneActiveTokens)

L is the longest eps-path in the graph, precomputed on host, so the
eps closure is exact.  Backtrace decisions (best emitting arc per
state, eps predecessor arc per state) are emitted per frame and
unwound on host — O(path length), negligible.

Acoustic scoring stays on device: the model's posteriors feed straight
into the scan without a host round-trip (the asymmetry SURVEY.md §3.4
says the device build must erase).

Scaling: costs are dense [B, S]; for multi-chip decoding the batch
dimension shards over the ``data`` mesh axis (per-utterance
parallelism, ref: steps/decode.sh --nj), with graph arrays replicated.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_cnn_tpu.decode.graph import CompiledGraph

BIG = np.float32(1e30)


def _eps_depth(g: CompiledGraph, cap: int = 32) -> int:
    """Longest path length in the eps-arc subgraph (host, offline)."""
    if g.num_eps_arcs == 0:
        return 0
    depth = np.zeros(g.num_states, np.int32)
    # Bellman-Ford style; the eps subgraph of HCLG is a DAG
    for _ in range(cap):
        upd = np.zeros(g.num_states, np.int32)
        np.maximum.at(upd, g.n_dst, depth[g.n_src] + 1)
        new = np.maximum(depth, upd)
        if (new == depth).all():
            return int(depth.max())
        depth = new
    return cap


def _segment_min_argmin(cand: jnp.ndarray, dst: jnp.ndarray,
                        num_states: int
                        ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-destination min cost and the arc index achieving it."""
    m = jax.ops.segment_min(cand, dst, num_segments=num_states)
    is_best = cand <= m[dst] + 1e-7
    arc_idx = jnp.arange(cand.shape[0], dtype=jnp.int32)
    a = jax.ops.segment_min(
        jnp.where(is_best, arc_idx, np.int32(2**31 - 1)), dst,
        num_segments=num_states)
    return m, a


class TpuViterbiDecoder:
    def __init__(self, graph: CompiledGraph, beam: float = 16.0,
                 max_active: int = 0, acoustic_scale: float = 0.1):
        self.g = graph
        self.beam = float(beam)
        self.max_active = (int(max_active)
                           if 0 < max_active < graph.num_states else 0)
        self.acoustic_scale = float(acoustic_scale)
        self.eps_iters = _eps_depth(graph)
        self.S = graph.num_states
        # device-resident graph
        self.e_src = jnp.asarray(graph.e_src, jnp.int32)
        self.e_dst = jnp.asarray(graph.e_dst, jnp.int32)
        self.e_w = jnp.asarray(graph.e_weight)
        self.e_pdf = jnp.asarray(graph.e_pdf, jnp.int32)
        self.n_src = jnp.asarray(graph.n_src, jnp.int32)
        self.n_dst = jnp.asarray(graph.n_dst, jnp.int32)
        self.n_w = jnp.asarray(graph.n_weight)
        self.final = jnp.asarray(graph.final)
        self._decode_jit = {}

    # -- single-utterance frame step (vmapped over batch) -----------------
    def _eps_sweeps(self, cost, eps_arc):
        for _ in range(self.eps_iters):
            cand = cost[self.n_src] + self.n_w
            m, a = _segment_min_argmin(cand, self.n_dst, self.S)
            improved = m < cost - 1e-6
            cost = jnp.where(improved, m, cost)
            eps_arc = jnp.where(improved, a, eps_arc)
        return cost, eps_arc

    def _frame(self, cost, am_row, active_mask):
        """cost [S], am_row [P] (-loglikes), active_mask scalar bool."""
        cand = (cost[self.e_src] + self.e_w
                + self.acoustic_scale * am_row[self.e_pdf])
        new_cost, emit_arc = _segment_min_argmin(cand, self.e_dst, self.S)
        eps_arc = jnp.full((self.S,), -1, jnp.int32)
        new_cost, eps_arc = self._eps_sweeps(new_cost, eps_arc)
        # beam prune
        cmin = jnp.min(new_cost)
        cutoff = cmin + self.beam
        if self.max_active:
            kth = jnp.sort(new_cost)[self.max_active]
            cutoff = jnp.minimum(cutoff, kth)
        new_cost = jnp.where(new_cost <= cutoff, new_cost, BIG)
        # frozen for padded frames
        out_cost = jnp.where(active_mask, new_cost, cost)
        emit_arc = jnp.where(active_mask, emit_arc, -1)
        eps_arc = jnp.where(active_mask, eps_arc, -1)
        return out_cost, (emit_arc, eps_arc)

    def _decode_impl(self, am_batch, lengths):
        """am_batch [B, T, P] raw -loglikes; lengths [B]."""
        B, T, P = am_batch.shape

        init_cost = jnp.full((self.S,), BIG).at[self.g.start].set(0.0)
        eps0 = jnp.full((self.S,), -1, jnp.int32)
        init_cost, init_eps = self._eps_sweeps(init_cost, eps0)
        init_cost = jnp.broadcast_to(init_cost, (B, self.S))
        init_eps = jnp.broadcast_to(init_eps, (B, self.S))

        frame_b = jax.vmap(self._frame, in_axes=(0, 0, 0))

        def step(carry, t):
            cost = carry
            am_row = am_batch[:, t, :]
            mask = t < lengths
            cost, (emit_arc, eps_arc) = frame_b(cost, am_row, mask)
            return cost, (emit_arc, eps_arc)

        final_cost, (emit_arcs, eps_arcs) = jax.lax.scan(
            step, init_cost, jnp.arange(T))
        total = final_cost + self.final[None, :]
        best_state = jnp.argmin(total, axis=1)
        best_cost = jnp.min(total, axis=1)
        # fallback when no final state is reachable
        alt_state = jnp.argmin(final_cost, axis=1)
        alt_cost = jnp.min(final_cost, axis=1)
        use_alt = best_cost >= BIG
        best_state = jnp.where(use_alt, alt_state, best_state)
        best_cost = jnp.where(use_alt, alt_cost, best_cost)
        return (best_state, best_cost, emit_arcs, eps_arcs, init_eps)

    def _get_jit(self, shape):
        if shape not in self._decode_jit:
            self._decode_jit[shape] = jax.jit(self._decode_impl)
        return self._decode_jit[shape]

    def decode_batch(
        self, loglikes: List[np.ndarray]
    ) -> List[Tuple[np.ndarray, np.ndarray, float]]:
        """loglikes: list of [T_i, P] arrays.  Returns per utterance
        (tids [T_i], word ids, total cost).  Pads to the max length;
        the scan freezes finished utterances."""
        B = len(loglikes)
        T = max(x.shape[0] for x in loglikes)
        P = loglikes[0].shape[1]
        am = np.zeros((B, T, P), np.float32)
        lengths = np.zeros((B,), np.int32)
        for i, x in enumerate(loglikes):
            am[i, :x.shape[0]] = -x     # raw acoustic costs
            lengths[i] = x.shape[0]
        fn = self._get_jit((B, T, P))
        best_state, best_cost, emit_arcs, eps_arcs, init_eps = [
            np.asarray(r) for r in
            fn(jnp.asarray(am), jnp.asarray(lengths))]
        g = self.g
        out = []
        for i in range(B):
            tids, words = self._unwind(
                int(best_state[i]), int(lengths[i]),
                emit_arcs[:, i, :], eps_arcs[:, i, :], init_eps[i])
            out.append((tids, words, float(best_cost[i])))
        return out

    def _unwind(self, state: int, T: int, emit_arcs: np.ndarray,
                eps_arcs: np.ndarray, init_eps: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Host backtrace over the recorded per-frame decisions."""
        g = self.g
        tids_r: List[int] = []
        words_r: List[int] = []
        s = state
        for t in range(T - 1, -1, -1):
            # eps chain within frame t+1 (after the emitting step)
            guard = 0
            while eps_arcs[t, s] >= 0:
                a = int(eps_arcs[t, s])
                if g.n_olabel[a] > 0:
                    words_r.append(int(g.n_olabel[a]))
                s = int(g.n_src[a])
                guard += 1
                assert guard <= self.eps_iters + 1
            a = int(emit_arcs[t, s])
            assert a >= 0, "backtrace hit a pruned state"
            tids_r.append(int(g.e_ilabel[a]))
            if g.e_olabel[a] > 0:
                words_r.append(int(g.e_olabel[a]))
            s = int(g.e_src[a])
        guard = 0
        while init_eps[s] >= 0:
            a = int(init_eps[s])
            if g.n_olabel[a] > 0:
                words_r.append(int(g.n_olabel[a]))
            s = int(g.n_src[a])
            guard += 1
            assert guard <= self.eps_iters + 1
        return (np.asarray(tids_r[::-1], np.int32),
                np.asarray(words_r[::-1], np.int32))

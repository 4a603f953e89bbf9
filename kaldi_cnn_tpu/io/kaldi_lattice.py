"""Kaldi binary CompactLattice archive interop.

Clean-room implementation of the on-disk form the reference's lattice
tools exchange (ref: lat/kaldi-lattice.{h,cc} CompactLatticeHolder;
fstext/lattice-weight.h CompactLatticeWeightTpl::Write/Read): a Kaldi
lattice archive entry is ``key<space>\\0B<OpenFst-binary-VectorFst>``
where the arc weight is a CompactLatticeWeight — a ⟨graph-cost,
acoustic-cost⟩ LatticeWeight pair plus a transition-id string.  The
OpenFst container layout (1.3-era VectorFst, file version 2):

    int32   magic = 2125659606
    string  fst type      ("vector")       [int32 length + bytes]
    string  arc type      ("compactlattice4")
    int32   version (2)
    int32   flags (0: no embedded symbol tables)
    uint64  properties
    int64   start state
    int64   num states
    int64   num arcs
    per state:
        CompactLatticeWeight final   [f32 graph, f32 acoustic,
                                      int64 n, n*int32 tids]
        int64 num arcs
        per arc: int32 ilabel, int32 olabel, CompactLatticeWeight,
                 int32 nextstate

In a CompactLattice ilabel == olabel == word id (an acceptor); the
frame-level alignment lives in the weight strings.  Conversion from
the decoder's state-level ``Lattice`` (ilabel = transition-id per
frame arc) mirrors fst::ConvertLattice + fst::Factor: linear eps-word
chains collapse into the word arc's transition-id string.

This lets device-emitted lattices be written where ``lattice-best-path``,
``lattice-scale`` or sclite pipelines expect ``lat.JOB`` archives, and
reference-produced archives be read back for differential testing.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import BinaryIO, Dict, List, Tuple

import numpy as np

from kaldi_cnn_tpu.decode.lattice import Lattice

FST_MAGIC = 2125659606
FST_TYPE = "vector"
ARC_TYPE = "compactlattice4"      # CompactLatticeWeightTpl<float,int32>
FILE_VERSION = 2
INF = float("inf")


@dataclass
class CompactLattice:
    """Word-acceptor lattice with per-arc transition-id strings."""

    num_states: int
    start: int
    # per-arc flat arrays; strings ragged
    arc_src: np.ndarray
    arc_dst: np.ndarray
    arc_word: np.ndarray
    arc_graph: np.ndarray
    arc_acoustic: np.ndarray
    arc_string: List[np.ndarray]
    # final weights: (graph, acoustic, string); inf graph = non-final
    final_graph: np.ndarray
    final_acoustic: np.ndarray
    final_string: List[np.ndarray] = field(default_factory=list)

    @property
    def num_arcs(self) -> int:
        return len(self.arc_src)


# ---------------------------------------------------------------------------
# Lattice <-> CompactLattice conversion
# ---------------------------------------------------------------------------

def lattice_to_compact(lat: Lattice) -> CompactLattice:
    """State-level Lattice -> CompactLattice (ref: fst::ConvertLattice
    + fst::Factor): arcs become word-labelled with their transition-id
    in the string; then linear chains (interior states with exactly one
    in-arc and one out-arc, the out-arc unlabelled) are factored into
    the incoming arc so each surviving arc carries one word's
    alignment."""
    A = lat.num_arcs
    src = lat.arc_src.astype(np.int64).copy()
    dst = lat.arc_dst.astype(np.int64).copy()
    word = lat.arc_olabel.astype(np.int32).copy()
    gw = lat.arc_graph.astype(np.float64).copy()
    ac = lat.arc_acoustic.astype(np.float64).copy()
    strings: List[List[int]] = [
        [int(t)] if t else [] for t in lat.arc_ilabel]

    out_deg = np.zeros(lat.num_states, np.int64)
    in_deg = np.zeros(lat.num_states, np.int64)
    np.add.at(out_deg, src, 1)
    np.add.at(in_deg, dst, 1)
    in_arc = np.full(lat.num_states, -1, np.int64)
    in_arc[dst] = np.arange(A)
    final_mask = np.isfinite(lat.final_graph)

    # factor: arc a (x -> s) absorbs arc b (s -> y) when s is a
    # pass-through state and b carries no word label
    alive = np.ones(A, bool)
    out_arc = np.full(lat.num_states, -1, np.int64)
    out_arc[src[::-1]] = np.arange(A - 1, -1, -1)[::-1]  # any one out-arc
    out_arc[src] = np.arange(A)
    for s in np.nonzero((in_deg == 1) & (out_deg == 1)
                        & ~final_mask)[0]:
        if s == lat.start:
            continue
        b = int(out_arc[s])
        if word[b] != 0:
            continue
        a = int(in_arc[s])
        # chase a through already-absorbed arcs
        while not alive[a]:
            a = int(in_arc[src[a]])
        strings[a] = strings[a] + strings[b]
        gw[a] += gw[b]
        ac[a] += ac[b]
        dst[a] = dst[b]
        in_arc[dst[b]] = a
        alive[b] = False

    keep = np.nonzero(alive)[0]
    used = np.zeros(lat.num_states, bool)
    used[lat.start] = True
    used[src[keep]] = True
    used[dst[keep]] = True
    used |= final_mask
    remap = np.cumsum(used) - 1
    fg = np.where(final_mask, lat.final_graph, np.inf).astype(np.float32)
    return CompactLattice(
        num_states=int(used.sum()), start=int(remap[lat.start]),
        arc_src=remap[src[keep]].astype(np.int32),
        arc_dst=remap[dst[keep]].astype(np.int32),
        arc_word=word[keep],
        arc_graph=gw[keep].astype(np.float32),
        arc_acoustic=ac[keep].astype(np.float32),
        arc_string=[np.asarray(strings[a], np.int32) for a in keep],
        final_graph=fg[used],
        final_acoustic=np.zeros(int(used.sum()), np.float32),
        final_string=[np.zeros(0, np.int32)] * int(used.sum()))


def compact_to_lattice(cl: CompactLattice) -> Lattice:
    """CompactLattice -> state-level Lattice: each arc's transition-id
    string expands to a chain of frame arcs (word on the first); state
    times recomputed by a forward sweep over alignment lengths (ref:
    lat/lattice-functions.cc CompactLatticeStateTimes)."""
    a_src: List[int] = []
    a_dst: List[int] = []
    a_il: List[int] = []
    a_ol: List[int] = []
    a_gw: List[float] = []
    a_ac: List[float] = []
    n = cl.num_states
    for a in range(cl.num_arcs):
        tids = cl.arc_string[a]
        chain = [int(cl.arc_src[a])]
        for _ in range(max(len(tids) - 1, 0)):
            chain.append(n)
            n += 1
        chain.append(int(cl.arc_dst[a]))
        if len(tids) == 0:
            a_src.append(chain[0]); a_dst.append(chain[-1])
            a_il.append(0); a_ol.append(int(cl.arc_word[a]))
            a_gw.append(float(cl.arc_graph[a]))
            a_ac.append(float(cl.arc_acoustic[a]))
            continue
        for i, t in enumerate(tids):
            a_src.append(chain[i]); a_dst.append(chain[i + 1])
            a_il.append(int(t))
            a_ol.append(int(cl.arc_word[a]) if i == 0 else 0)
            # costs ride the first arc of the chain
            a_gw.append(float(cl.arc_graph[a]) if i == 0 else 0.0)
            a_ac.append(float(cl.arc_acoustic[a]) if i == 0 else 0.0)
    final_graph = np.full(n, np.inf, np.float32)
    final_graph[:cl.num_states] = cl.final_graph
    lat = Lattice(
        num_states=n, start=cl.start,
        state_time=np.zeros(n, np.int32),
        arc_src=np.asarray(a_src, np.int32),
        arc_dst=np.asarray(a_dst, np.int32),
        arc_ilabel=np.asarray(a_il, np.int32),
        arc_olabel=np.asarray(a_ol, np.int32),
        arc_graph=np.asarray(a_gw, np.float32),
        arc_acoustic=np.asarray(a_ac, np.float32),
        final_graph=final_graph)
    # state times: longest-alignment forward sweep over the DAG
    times = np.zeros(n, np.int64)
    for s in lat.topo_order():
        sel = np.nonzero(lat.arc_src == s)[0]
        for a in sel:
            step = times[s] + (1 if lat.arc_ilabel[a] else 0)
            if step > times[lat.arc_dst[a]]:
                times[lat.arc_dst[a]] = step
    lat.state_time = times.astype(np.int32)
    return lat


# ---------------------------------------------------------------------------
# OpenFst binary encoding
# ---------------------------------------------------------------------------

def _write_string(f: BinaryIO, s: str) -> None:
    b = s.encode()
    f.write(struct.pack("<i", len(b)))
    f.write(b)


def _write_clat_weight(f: BinaryIO, g: float, a: float,
                       tids: np.ndarray) -> None:
    f.write(struct.pack("<ff", np.float32(g), np.float32(a)))
    f.write(struct.pack("<q", len(tids)))
    if len(tids):
        f.write(np.asarray(tids, "<i4").tobytes())


def write_compact_lattice(f: BinaryIO, cl: CompactLattice) -> None:
    """One CompactLattice in OpenFst binary VectorFst layout."""
    f.write(struct.pack("<i", FST_MAGIC))
    _write_string(f, FST_TYPE)
    _write_string(f, ARC_TYPE)
    f.write(struct.pack("<i", FILE_VERSION))
    f.write(struct.pack("<i", 0))                  # flags
    f.write(struct.pack("<Q", 3))                  # kExpanded|kMutable
    f.write(struct.pack("<q", cl.start))
    f.write(struct.pack("<q", cl.num_states))
    f.write(struct.pack("<q", cl.num_arcs))
    order = np.argsort(cl.arc_src, kind="stable")
    bounds = np.searchsorted(cl.arc_src[order],
                             np.arange(cl.num_states + 1))
    for s in range(cl.num_states):
        if np.isfinite(cl.final_graph[s]):
            fstr = (cl.final_string[s] if s < len(cl.final_string)
                    else np.zeros(0, np.int32))
            _write_clat_weight(f, cl.final_graph[s],
                               cl.final_acoustic[s], fstr)
        else:                                       # Weight::Zero()
            _write_clat_weight(f, INF, INF, np.zeros(0, np.int32))
        arcs = order[bounds[s]:bounds[s + 1]]
        f.write(struct.pack("<q", len(arcs)))
        for a in arcs:
            w = int(cl.arc_word[a])
            f.write(struct.pack("<ii", w, w))       # acceptor
            _write_clat_weight(f, cl.arc_graph[a], cl.arc_acoustic[a],
                               cl.arc_string[a])
            f.write(struct.pack("<i", int(cl.arc_dst[a])))


def _read_exact(f: BinaryIO, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise EOFError("truncated lattice stream")
    return b


def _read_string(f: BinaryIO) -> str:
    (n,) = struct.unpack("<i", _read_exact(f, 4))
    return _read_exact(f, n).decode()


def _read_clat_weight(f: BinaryIO):
    g, a = struct.unpack("<ff", _read_exact(f, 8))
    (n,) = struct.unpack("<q", _read_exact(f, 8))
    tids = np.frombuffer(_read_exact(f, 4 * n), "<i4") if n else \
        np.zeros(0, np.int32)
    return g, a, tids


def read_compact_lattice(f: BinaryIO) -> CompactLattice:
    (magic,) = struct.unpack("<i", _read_exact(f, 4))
    if magic != FST_MAGIC:
        raise ValueError(f"bad OpenFst magic {magic}")
    fsttype = _read_string(f)
    arctype = _read_string(f)
    if fsttype != FST_TYPE or not arctype.startswith("compactlattice"):
        raise ValueError(f"unsupported fst {fsttype}/{arctype}")
    (_version,) = struct.unpack("<i", _read_exact(f, 4))
    (flags,) = struct.unpack("<i", _read_exact(f, 4))
    if flags & 0x3:
        raise ValueError("embedded symbol tables not supported")
    struct.unpack("<Q", _read_exact(f, 8))          # properties
    (start,) = struct.unpack("<q", _read_exact(f, 8))
    (ns,) = struct.unpack("<q", _read_exact(f, 8))
    struct.unpack("<q", _read_exact(f, 8))          # num arcs
    a_src: List[int] = []
    a_dst: List[int] = []
    a_w: List[int] = []
    a_g: List[float] = []
    a_a: List[float] = []
    a_str: List[np.ndarray] = []
    fg = np.full(ns, np.inf, np.float32)
    fa = np.zeros(ns, np.float32)
    fstr: List[np.ndarray] = []
    for s in range(ns):
        g, a, tids = _read_clat_weight(f)
        fg[s], fa[s] = g, a
        if not np.isfinite(g):
            fg[s] = np.inf
        fstr.append(tids)
        (narcs,) = struct.unpack("<q", _read_exact(f, 8))
        for _ in range(narcs):
            il, ol = struct.unpack("<ii", _read_exact(f, 8))
            g, a, tids = _read_clat_weight(f)
            (nxt,) = struct.unpack("<i", _read_exact(f, 4))
            a_src.append(s); a_dst.append(nxt); a_w.append(ol)
            a_g.append(g); a_a.append(a); a_str.append(tids)
    return CompactLattice(
        num_states=int(ns), start=int(start),
        arc_src=np.asarray(a_src, np.int32),
        arc_dst=np.asarray(a_dst, np.int32),
        arc_word=np.asarray(a_w, np.int32),
        arc_graph=np.asarray(a_g, np.float32),
        arc_acoustic=np.asarray(a_a, np.float32),
        arc_string=a_str, final_graph=fg, final_acoustic=fa,
        final_string=fstr)


# ---------------------------------------------------------------------------
# Archive (ark) framing
# ---------------------------------------------------------------------------

def write_compact_lattice_ark(path: str, lats: Dict[str, Lattice]
                              ) -> None:
    """Kaldi-binary lattice archive (``key \\0B<fst>`` per entry, like
    the reference's lat.JOB written by nnet-latgen-faster | gzip)."""
    with open(path, "wb") as f:
        for utt in sorted(lats):
            f.write(utt.encode() + b" \0B")
            write_compact_lattice(f, lattice_to_compact(lats[utt]))


def read_compact_lattice_ark(path: str) -> Dict[str, Lattice]:
    out: Dict[str, Lattice] = {}
    with open(path, "rb") as f:
        while True:
            key = bytearray()
            c = f.read(1)
            if not c:
                break
            while c != b" ":
                key += c
                c = f.read(1)
                if not c:
                    raise EOFError("truncated archive key")
            if _read_exact(f, 2) != b"\0B":
                raise ValueError("expected binary marker \\0B")
            out[key.decode()] = compact_to_lattice(
                read_compact_lattice(f))
    return out

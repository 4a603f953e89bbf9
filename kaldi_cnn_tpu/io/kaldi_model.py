"""Kaldi binary-token-stream model files (.mdl): TransitionModel +
nnet2 AmNnet (component list + priors).

Clean-room equivalent of the reference's model serialization
(ref: src/base/io-funcs.{h,cc} Write/ReadToken + the per-class
Read/Write of src/hmm/transition-model.cc TransitionModel::Write,
src/nnet2/nnet-nnet.cc Nnet::Write, src/nnet2/am-nnet.cc
AmNnet::Write; SURVEY.md §5.4 "Model format = Kaldi binary token
stream").  The token layout mirrors the upstream structure —
``\\0B`` binary header, ``<TransitionModel>`` (topology, triples,
log-probs), ``<Nnet> <NumComponents> ... </Nnet>``, priors vector —
so files round-trip exactly through this module.  The reference mount
was empty at survey time (SURVEY.md top note), so byte-level parity
with actual Kaldi binaries is unverified; the first session with a
populated mount should diff a real .mdl against this writer and stamp
corrections.

Native ops layer note: the matrix payloads use the same FM/FV encoding
as the ark Table I/O (io/kaldi_io.py), so the C++ fast reader can mmap
model blobs too.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from kaldi_cnn_tpu.io.kaldi_io import (
    _read_int32, _read_token, _write_int32)
from kaldi_cnn_tpu.lang.topology import (
    HmmState, HmmTopology, TopologyEntry)
from kaldi_cnn_tpu.lang.transition_model import (
    ContextDependencyInterface, TransitionModel)


# --------------------------------------------------------------------------
# primitives (ref: base/io-funcs.cc WriteBasicType / WriteToken)
# --------------------------------------------------------------------------

def write_token(f, tok: str) -> None:
    f.write(tok.encode() + b" ")


def expect_token(f, want: str) -> None:
    got = _read_token(f)
    if got != want:
        raise ValueError(f"expected token {want!r}, got {got!r}")


def write_float(f, v: float) -> None:
    f.write(b"\x04" + struct.pack("<f", v))


def read_float(f) -> float:
    if f.read(1) != b"\x04":
        raise ValueError("expected float size byte")
    return struct.unpack("<f", f.read(4))[0]


def write_fv(f, v: np.ndarray) -> None:
    write_token(f, "FV")
    _write_int32(f, len(v))
    f.write(np.ascontiguousarray(v, np.float32).tobytes())


def read_fv(f) -> np.ndarray:
    expect_token(f, "FV")
    n = _read_int32(f)
    return np.frombuffer(f.read(4 * n), np.float32).copy()


def write_fm(f, m: np.ndarray) -> None:
    write_token(f, "FM")
    _write_int32(f, m.shape[0])
    _write_int32(f, m.shape[1])
    f.write(np.ascontiguousarray(m, np.float32).tobytes())


def read_fm(f) -> np.ndarray:
    expect_token(f, "FM")
    r, c = _read_int32(f), _read_int32(f)
    return np.frombuffer(f.read(4 * r * c), np.float32).reshape(r, c).copy()


def write_int_vec(f, v: Sequence[int]) -> None:
    _write_int32(f, len(v))
    for x in v:
        _write_int32(f, int(x))


def read_int_vec(f) -> List[int]:
    n = _read_int32(f)
    return [_read_int32(f) for _ in range(n)]


# --------------------------------------------------------------------------
# HmmTopology (ref: hmm/hmm-topology.cc HmmTopology::Write)
# --------------------------------------------------------------------------

def write_topology(f, topo: HmmTopology) -> None:
    write_token(f, "<Topology>")
    write_int_vec(f, topo.phones)
    for p in topo.phones:
        entry = topo.entry(p)
        _write_int32(f, len(entry.states))
        for st in entry.states:
            _write_int32(f, st.pdf_class)
            _write_int32(f, len(st.transitions))
            for nxt, prob in st.transitions:
                _write_int32(f, nxt)
                write_float(f, prob)
    write_token(f, "</Topology>")


def read_topology(f) -> HmmTopology:
    expect_token(f, "<Topology>")
    phones = read_int_vec(f)
    entries: Dict[int, TopologyEntry] = {}
    for p in phones:
        n_states = _read_int32(f)
        states = []
        for _ in range(n_states):
            pdf_class = _read_int32(f)
            n_tr = _read_int32(f)
            trans = [(_read_int32(f), read_float(f)) for _ in range(n_tr)]
            states.append(HmmState(pdf_class=pdf_class, transitions=trans))
        entries[p] = TopologyEntry(states)
    expect_token(f, "</Topology>")
    return HmmTopology(phones, entries)


# --------------------------------------------------------------------------
# TransitionModel (ref: hmm/transition-model.cc TransitionModel::Write;
# the 2015 era writes <Triples> — kept here)
# --------------------------------------------------------------------------

class _TupleContextDependency(ContextDependencyInterface):
    """Reconstructs enough of the tree interface from a serialized
    tuple list for the TransitionModel constructor to re-derive the
    identical transition-state enumeration (the .mdl does not contain
    the tree itself, matching the reference, where the tree is a
    separate file)."""

    def __init__(self, topo: HmmTopology,
                 tuples: Sequence[Tuple[int, int, int]]):
        self.context_width = 1
        self.central_position = 0
        self._map: Dict[Tuple[int, int], set] = {}
        num = 0
        for phone, hmm_state, pdf in tuples:
            pc = topo.entry(phone).states[hmm_state].pdf_class
            self._map.setdefault((phone, pc), set()).add(pdf)
            num = max(num, pdf + 1)
        self._num_pdfs = num

    def compute(self, phone_window, pdf_class: int) -> int:
        return min(self._map[(phone_window[0], pdf_class)])

    def pdfs_for(self, phone: int, pdf_class: int):
        return self._map.get((phone, pdf_class), set())

    @property
    def num_pdfs(self) -> int:
        return self._num_pdfs


def write_transition_model(f, tm: TransitionModel) -> None:
    write_token(f, "<TransitionModel>")
    write_topology(f, tm.topo)
    write_token(f, "<Triples>")
    _write_int32(f, len(tm.tuples))
    for phone, hmm_state, pdf in tm.tuples:
        _write_int32(f, phone)
        _write_int32(f, hmm_state)
        _write_int32(f, pdf)
    write_token(f, "</Triples>")
    write_token(f, "<LogProbs>")
    write_fv(f, tm.log_probs.astype(np.float32))
    write_token(f, "</LogProbs>")
    write_token(f, "</TransitionModel>")


def read_transition_model(f) -> TransitionModel:
    expect_token(f, "<TransitionModel>")
    topo = read_topology(f)
    expect_token(f, "<Triples>")
    n = _read_int32(f)
    tuples = [(_read_int32(f), _read_int32(f), _read_int32(f))
              for _ in range(n)]
    expect_token(f, "</Triples>")
    expect_token(f, "<LogProbs>")
    log_probs = read_fv(f)
    expect_token(f, "</LogProbs>")
    expect_token(f, "</TransitionModel>")
    tm = TransitionModel(topo, _TupleContextDependency(topo, tuples))
    if tm.tuples != sorted(tuples):
        raise ValueError("transition tuples failed to reconstruct")
    tm.log_probs = log_probs.astype(np.float64)
    return tm


# --------------------------------------------------------------------------
# nnet2 components (ref: nnet2/nnet-component.cc per-class Write; the
# fork's Conv2DComponent/MaxpoolingComponent get fork-shaped tokens)
# --------------------------------------------------------------------------

def _write_component(f, comp, params: Dict[str, Any]) -> None:
    from kaldi_cnn_tpu.models import components as C
    if isinstance(comp, C.AffineComponent):
        write_token(f, "<AffineComponent>")
        write_token(f, "<MaxChange>")
        write_float(f, comp.max_change)
        write_token(f, "<LinearParams>")
        write_fm(f, np.asarray(params["w"], np.float32))
        write_token(f, "<BiasParams>")
        write_fv(f, np.asarray(params["b"], np.float32))
        write_token(f, "</AffineComponent>")
    elif isinstance(comp, C.FixedAffineComponent):
        write_token(f, "<FixedAffineComponent>")
        write_token(f, "<LinearParams>")
        write_fm(f, np.asarray(params.get("w", comp._w), np.float32))
        write_token(f, "<BiasParams>")
        write_fv(f, np.asarray(params.get("b", comp._b), np.float32))
        write_token(f, "</FixedAffineComponent>")
    elif isinstance(comp, C.SpliceComponent):
        write_token(f, "<SpliceComponent>")
        write_token(f, "<InputDim>")
        _write_int32(f, comp.input_dim)
        write_token(f, "<LeftContext>")
        _write_int32(f, comp.left_context)
        write_token(f, "<RightContext>")
        _write_int32(f, comp.right_context)
        write_token(f, "</SpliceComponent>")
    elif isinstance(comp, C.PnormComponent):
        write_token(f, "<PnormComponent>")
        write_token(f, "<InputDim>")
        _write_int32(f, comp.input_dim)
        write_token(f, "<OutputDim>")
        _write_int32(f, comp.output_dim)
        write_token(f, "<P>")
        write_float(f, comp.p)
        write_token(f, "</PnormComponent>")
    elif isinstance(comp, C.NormalizeComponent):
        write_token(f, "<NormalizeComponent>")
        write_token(f, "<Dim>")
        _write_int32(f, comp.dim)
        write_token(f, "</NormalizeComponent>")
    elif isinstance(comp, C.SoftmaxComponent):
        write_token(f, "<SoftmaxComponent>")
        write_token(f, "<Dim>")
        _write_int32(f, comp.dim)
        write_token(f, "</SoftmaxComponent>")
    elif isinstance(comp, C.TanhComponent):
        write_token(f, "<TanhComponent>")
        write_token(f, "<Dim>")
        _write_int32(f, comp.dim)
        write_token(f, "</TanhComponent>")
    elif isinstance(comp, C.SigmoidComponent):
        write_token(f, "<SigmoidComponent>")
        write_token(f, "<Dim>")
        _write_int32(f, comp.dim)
        write_token(f, "</SigmoidComponent>")
    elif isinstance(comp, C.RectifiedLinearComponent):
        write_token(f, "<RectifiedLinearComponent>")
        write_token(f, "<Dim>")
        _write_int32(f, comp.dim)
        write_token(f, "</RectifiedLinearComponent>")
    elif isinstance(comp, C.DropoutComponent):
        write_token(f, "<DropoutComponent>")
        write_token(f, "<Dim>")
        _write_int32(f, comp.dim)
        write_token(f, "<DropoutProportion>")
        write_float(f, comp.proportion)
        write_token(f, "</DropoutComponent>")
    elif isinstance(comp, C.Conv2DComponent):
        write_token(f, "<Conv2DComponent>")
        for tok, v in (("<InT>", comp.in_t), ("<InF>", comp.in_f),
                       ("<InC>", comp.in_c), ("<FiltT>", comp.filt_t),
                       ("<FiltF>", comp.filt_f),
                       ("<NumFilters>", comp.num_filters),
                       ("<StrideT>", comp.stride_t),
                       ("<StrideF>", comp.stride_f)):
            write_token(f, tok)
            _write_int32(f, v)
        write_token(f, "<FilterParams>")
        write_fm(f, np.asarray(params["w"], np.float32))
        write_token(f, "<BiasParams>")
        write_fv(f, np.asarray(params["b"], np.float32))
        write_token(f, "</Conv2DComponent>")
    elif isinstance(comp, C.Maxpooling3DComponent):
        write_token(f, "<MaxpoolingComponent>")
        for tok, v in (("<InT>", comp.in_t), ("<InF>", comp.in_f),
                       ("<InC>", comp.in_c), ("<PoolT>", comp.pool_t),
                       ("<PoolF>", comp.pool_f), ("<PoolC>", comp.pool_c)):
            write_token(f, tok)
            _write_int32(f, v)
        write_token(f, "</MaxpoolingComponent>")
    else:
        raise TypeError(f"no Kaldi serialization for {type(comp).__name__}")


def _read_dim(f, tok: str) -> int:
    expect_token(f, tok)
    return _read_int32(f)


def _read_component(f):
    """-> (component, params dict)."""
    from kaldi_cnn_tpu.models import components as C
    tok = _read_token(f)
    if tok == "<AffineComponent>":
        expect_token(f, "<MaxChange>")
        max_change = read_float(f)
        expect_token(f, "<LinearParams>")
        w = read_fm(f)
        expect_token(f, "<BiasParams>")
        b = read_fv(f)
        expect_token(f, "</AffineComponent>")
        comp = C.AffineComponent(input_dim=w.shape[1],
                                 output_dim=w.shape[0],
                                 max_change=max_change)
        return comp, {"w": w, "b": b}
    if tok == "<FixedAffineComponent>":
        expect_token(f, "<LinearParams>")
        w = read_fm(f)
        expect_token(f, "<BiasParams>")
        b = read_fv(f)
        expect_token(f, "</FixedAffineComponent>")
        comp = C.FixedAffineComponent.from_matrix(w, b)
        return comp, {"w": w, "b": b}
    if tok == "<SpliceComponent>":
        dim = _read_dim(f, "<InputDim>")
        left = _read_dim(f, "<LeftContext>")
        right = _read_dim(f, "<RightContext>")
        expect_token(f, "</SpliceComponent>")
        return C.SpliceComponent(input_dim=dim, left_context=left,
                                 right_context=right), {}
    if tok == "<PnormComponent>":
        idim = _read_dim(f, "<InputDim>")
        odim = _read_dim(f, "<OutputDim>")
        expect_token(f, "<P>")
        p = read_float(f)
        expect_token(f, "</PnormComponent>")
        return C.PnormComponent(input_dim=idim, output_dim=odim, p=p), {}
    simple = {"<NormalizeComponent>": C.NormalizeComponent,
              "<SoftmaxComponent>": C.SoftmaxComponent,
              "<TanhComponent>": C.TanhComponent,
              "<SigmoidComponent>": C.SigmoidComponent,
              "<RectifiedLinearComponent>": C.RectifiedLinearComponent}
    if tok in simple:
        dim = _read_dim(f, "<Dim>")
        expect_token(f, tok.replace("<", "</", 1))
        return simple[tok](dim=dim), {}
    if tok == "<DropoutComponent>":
        dim = _read_dim(f, "<Dim>")
        expect_token(f, "<DropoutProportion>")
        prop = read_float(f)
        expect_token(f, "</DropoutComponent>")
        return C.DropoutComponent(dim=dim, proportion=prop), {}
    if tok == "<Conv2DComponent>":
        vals = [_read_dim(f, t) for t in
                ("<InT>", "<InF>", "<InC>", "<FiltT>", "<FiltF>",
                 "<NumFilters>", "<StrideT>", "<StrideF>")]
        expect_token(f, "<FilterParams>")
        w = read_fm(f)
        expect_token(f, "<BiasParams>")
        b = read_fv(f)
        expect_token(f, "</Conv2DComponent>")
        comp = C.Conv2DComponent(
            in_t=vals[0], in_f=vals[1], in_c=vals[2], filt_t=vals[3],
            filt_f=vals[4], num_filters=vals[5], stride_t=vals[6],
            stride_f=vals[7])
        return comp, {"w": w, "b": b}
    if tok == "<MaxpoolingComponent>":
        vals = [_read_dim(f, t) for t in
                ("<InT>", "<InF>", "<InC>", "<PoolT>", "<PoolF>",
                 "<PoolC>")]
        expect_token(f, "</MaxpoolingComponent>")
        return C.Maxpooling3DComponent(
            in_t=vals[0], in_f=vals[1], in_c=vals[2], pool_t=vals[3],
            pool_f=vals[4], pool_c=vals[5]), {}
    raise ValueError(f"unknown component token {tok!r}")


# --------------------------------------------------------------------------
# Nnet / AmNnet (.mdl)
# --------------------------------------------------------------------------

def write_nnet(f, nnet, params) -> None:
    write_token(f, "<Nnet>")
    write_token(f, "<NumComponents>")
    _write_int32(f, len(nnet.components))
    write_token(f, "<Components>")
    for comp, p in zip(nnet.components, params):
        _write_component(f, comp, p or {})
    write_token(f, "</Components>")
    write_token(f, "</Nnet>")


def read_nnet(f):
    """-> (Nnet, params tuple) with numpy parameter arrays."""
    from kaldi_cnn_tpu.models.nnet import Nnet
    expect_token(f, "<Nnet>")
    expect_token(f, "<NumComponents>")
    n = _read_int32(f)
    expect_token(f, "<Components>")
    comps, params = [], []
    for _ in range(n):
        c, p = _read_component(f)
        comps.append(c)
        params.append(p)
    expect_token(f, "</Components>")
    expect_token(f, "</Nnet>")
    return Nnet(comps), tuple(params)


def write_am_nnet(path: str, trans_model: TransitionModel, nnet, params,
                  priors: Optional[np.ndarray] = None) -> None:
    """The .mdl file: binary header, transition model, nnet, priors
    (ref: nnet2bin/nnet-am-init.cc output via AmNnet::Write)."""
    with open(path, "wb") as f:
        f.write(b"\x00B")
        write_transition_model(f, trans_model)
        write_nnet(f, nnet, params)
        write_token(f, "<Priors>")
        out_dim = nnet.output_dim
        if priors is None:
            priors = np.full(out_dim, 1.0 / out_dim, np.float32)
        write_fv(f, np.asarray(priors, np.float32))
    return None


def read_am_nnet(path: str):
    """-> (TransitionModel, Nnet, params, priors)."""
    with open(path, "rb") as f:
        if f.read(2) != b"\x00B":
            raise ValueError("not a binary Kaldi model file")
        tm = read_transition_model(f)
        nnet, params = read_nnet(f)
        expect_token(f, "<Priors>")
        priors = read_fv(f)
    return tm, nnet, params, priors


def write_gmm_model(path: str, trans_model: TransitionModel, am) -> None:
    """GMM .mdl: transition model + AmDiagGmm (ref: gmmbin/gmm-est.cc
    output; am-diag-gmm.cc AmDiagGmm::Write token layout adapted to the
    batched-array DiagGmm here)."""
    with open(path, "wb") as f:
        f.write(b"\x00B")
        write_transition_model(f, trans_model)
        write_token(f, "<DIMENSION>")
        _write_int32(f, am.dim)
        write_token(f, "<NUMPDFS>")
        _write_int32(f, len(am.gmms))
        for g in am.gmms:
            write_token(f, "<DiagGMM>")
            write_token(f, "<WEIGHTS>")
            write_fv(f, np.asarray(g.weights, np.float32))
            write_token(f, "<MEANS>")
            write_fm(f, np.asarray(g.means, np.float32))
            write_token(f, "<VARS>")
            write_fm(f, np.asarray(g.vars, np.float32))
            write_token(f, "</DiagGMM>")


def read_gmm_model(path: str):
    """-> (TransitionModel, AmDiagGmm)."""
    from kaldi_cnn_tpu.gmm.am_gmm import AmDiagGmm
    from kaldi_cnn_tpu.gmm.diag_gmm import DiagGmm
    with open(path, "rb") as f:
        if f.read(2) != b"\x00B":
            raise ValueError("not a binary Kaldi model file")
        tm = read_transition_model(f)
        expect_token(f, "<DIMENSION>")
        _read_int32(f)
        expect_token(f, "<NUMPDFS>")
        n = _read_int32(f)
        gmms = []
        for _ in range(n):
            expect_token(f, "<DiagGMM>")
            expect_token(f, "<WEIGHTS>")
            w = read_fv(f)
            expect_token(f, "<MEANS>")
            means = read_fm(f)
            expect_token(f, "<VARS>")
            variances = read_fm(f)
            expect_token(f, "</DiagGMM>")
            gmms.append(DiagGmm(np.asarray(w, np.float64),
                                np.asarray(means, np.float64),
                                np.asarray(variances, np.float64)))
    return tm, AmDiagGmm(gmms)

"""nnet2-style components as stateless config objects + param pytrees.

Mirrors the Component contract of src/nnet2/nnet-component.{h,cc}
(Propagate / Backprop, with the component seeing its minibatch
in_value/out_value/out_deriv) — the explicit backprop walk is what lets
AffineComponentPreconditionedOnline-style layers precondition the raw
minibatch row spaces (NG-SGD) rather than a summed gradient.

Data convention: minibatch matrices are [N, dim] float32 rows, like the
reference's CuMatrix minibatches.  Conv2D/Maxpool3D interpret the flat
row as a (time, freq, channel) volume — the fork's CNN layout
(Conv2DComponent / 3-D MaxpoolingComponent per BASELINE.json).

Each component implements:
  init(key) -> params dict (possibly empty)
  forward(params, x, train=False, key=None) -> (y, aux)
  backprop(params, in_value, out_value, out_deriv, aux) -> in_deriv
Trainable components additionally implement:
  init_opt(ng_factory) -> opt_state pytree
  update(params, opt, in_value, out_deriv, lr, ngs) -> (params', opt')
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_cnn_tpu.models.ng_sgd import (NGState, OnlineNaturalGradient,
                                         fused_ng_delta)

Params = Dict[str, jnp.ndarray]


def _ng_affine_update(params, opt, in_value, out_deriv, lr, ng_in, ng_out,
                      max_change: float):
    """Shared NG-SGD update for affine-like weight matrices.

    (ref: nnet-component.cc AffineComponentPreconditionedOnline::Update:
    extend input rows with 1.0 for the bias, precondition both row
    spaces, delta = deriv_hatᵀ @ in_hat, clip by max_change.)

    No 1/N: the objf derivative is already per-frame normalized (the
    trainer divides by the weight sum), matching the reference where
    objf is per-minibatch and lr absorbs scale.  The heavy lifting is
    ng_affine_apply's factored form — bias column analytic, delta
    never materialized (see its docstring).
    """
    from kaldi_cnn_tpu.models.ng_sgd import ng_affine_apply
    w, b, opt_in, opt_out = ng_affine_apply(
        ng_in, ng_out, opt["ng_in"], opt["ng_out"], in_value, out_deriv,
        params["w"], params["b"], lr, max_change)
    new_params = dict(params)
    new_params["w"] = w
    new_params["b"] = b
    return new_params, {"ng_in": opt_in, "ng_out": opt_out}


@dataclass(frozen=True)
class AffineComponent:
    """(ref: AffineComponent / AffineComponentPreconditionedOnline)."""

    input_dim: int
    output_dim: int
    param_stddev: Optional[float] = None    # default: 1/sqrt(input_dim)
    bias_stddev: float = 1.0
    max_change: float = 0.75                # max-change-per-minibatch
    trainable: bool = True

    def init(self, key) -> Params:
        std = (self.param_stddev if self.param_stddev is not None
               else 1.0 / math.sqrt(self.input_dim))
        k1, k2 = jax.random.split(key)
        w = std * jax.random.normal(k1, (self.output_dim, self.input_dim),
                                    jnp.float32)
        b = self.bias_stddev * jax.random.normal(k2, (self.output_dim,),
                                                 jnp.float32)
        return {"w": w, "b": b}

    def forward(self, params, x, train=False, key=None):
        return x @ params["w"].T + params["b"], None

    def backprop(self, params, in_value, out_value, out_deriv, aux):
        return out_deriv @ params["w"]

    def init_opt(self, ng_in: OnlineNaturalGradient,
                 ng_out: OnlineNaturalGradient):
        return {"ng_in": ng_in.init(self.input_dim + 1),
                "ng_out": ng_out.init(self.output_dim)}

    def update(self, params, opt, in_value, out_deriv, lr, ng_in, ng_out):
        return _ng_affine_update(params, opt, in_value, out_deriv, lr,
                                 ng_in, ng_out, self.max_change)


@dataclass(frozen=True)
class FixedAffineComponent:
    """Non-trainable affine, e.g. the LDA-like preprocessing transform
    (ref: FixedAffineComponent from get-feature-transform)."""

    matrix: tuple  # ((out, in) array bytes handled via init)
    trainable: bool = False
    input_dim: int = 0
    output_dim: int = 0

    @staticmethod
    def from_matrix(mat: np.ndarray, bias: Optional[np.ndarray] = None
                    ) -> "FixedAffineComponent":
        out_dim, in_dim = mat.shape
        b = np.zeros(out_dim, np.float32) if bias is None else bias
        c = FixedAffineComponent(matrix=(), input_dim=in_dim,
                                 output_dim=out_dim)
        object.__setattr__(c, "_w", jnp.asarray(mat, jnp.float32))
        object.__setattr__(c, "_b", jnp.asarray(b, jnp.float32))
        return c

    def init(self, key) -> Params:
        return {"w": self._w, "b": self._b}

    def forward(self, params, x, train=False, key=None):
        return x @ params["w"].T + params["b"], None

    def backprop(self, params, in_value, out_value, out_deriv, aux):
        return out_deriv @ params["w"]


@dataclass(frozen=True)
class TanhComponent:
    dim: int
    trainable: bool = False

    def init(self, key) -> Params:
        return {}

    def forward(self, params, x, train=False, key=None):
        return jnp.tanh(x), None

    def backprop(self, params, in_value, out_value, out_deriv, aux):
        return out_deriv * (1.0 - out_value * out_value)


@dataclass(frozen=True)
class SigmoidComponent:
    dim: int
    trainable: bool = False

    def init(self, key) -> Params:
        return {}

    def forward(self, params, x, train=False, key=None):
        return jax.nn.sigmoid(x), None

    def backprop(self, params, in_value, out_value, out_deriv, aux):
        return out_deriv * out_value * (1.0 - out_value)


@dataclass(frozen=True)
class RectifiedLinearComponent:
    dim: int
    trainable: bool = False

    def init(self, key) -> Params:
        return {}

    def forward(self, params, x, train=False, key=None):
        return jnp.maximum(x, 0.0), None

    def backprop(self, params, in_value, out_value, out_deriv, aux):
        return out_deriv * (out_value > 0.0)


@dataclass(frozen=True)
class PnormComponent:
    """Group p-norm nonlinearity (ref: PnormComponent, p=2 in the
    p-norm recipes: steps/nnet2/train_pnorm_*.sh)."""

    input_dim: int
    output_dim: int
    p: float = 2.0
    trainable: bool = False

    def __post_init__(self):
        assert self.input_dim % self.output_dim == 0

    @property
    def group_size(self) -> int:
        return self.input_dim // self.output_dim

    def init(self, key) -> Params:
        return {}

    def forward(self, params, x, train=False, key=None):
        n = x.shape[0]
        g = x.reshape(n, self.output_dim, self.group_size)
        # group power-sum accumulates in f32 even under bf16 storage
        # (the cast fuses into the reducing op's operand read), matching
        # the cross-row-reduction discipline in nnet.py/PERF.md
        s = jnp.sum(jnp.power(jnp.abs(g), self.p).astype(jnp.float32),
                    axis=2)
        y = jnp.power(s + 1e-20, 1.0 / self.p).astype(x.dtype)
        return y, None

    def backprop(self, params, in_value, out_value, out_deriv, aux):
        n = in_value.shape[0]
        g = in_value.reshape(n, self.output_dim, self.group_size)
        y = jnp.maximum(out_value, 1e-10)[:, :, None]
        dy = out_deriv[:, :, None]
        dx = dy * jnp.sign(g) * jnp.power(jnp.abs(g) / y, self.p - 1.0)
        return dx.reshape(n, self.input_dim)


@dataclass(frozen=True)
class NormalizeComponent:
    """Row RMS normalization (ref: NormalizeComponent: y = x / rms(x),
    stabilizes p-norm nets)."""

    dim: int
    trainable: bool = False

    def init(self, key) -> Params:
        return {}

    def forward(self, params, x, train=False, key=None):
        # f32 accumulation for the row second moment (fused convert)
        rms = jnp.sqrt(jnp.mean((x * x).astype(jnp.float32), axis=1,
                                keepdims=True) + 1e-20)
        return x / rms, None

    def backprop(self, params, in_value, out_value, out_deriv, aux):
        d = in_value.shape[1]
        rms = jnp.sqrt(jnp.mean((in_value * in_value).astype(jnp.float32),
                                axis=1, keepdims=True) + 1e-20)
        dot = jnp.sum((out_deriv * in_value).astype(jnp.float32),
                      axis=1, keepdims=True)
        return out_deriv / rms - in_value * dot / (d * rms ** 3)


@dataclass(frozen=True)
class SoftmaxComponent:
    dim: int
    trainable: bool = False

    def init(self, key) -> Params:
        return {}

    def forward(self, params, x, train=False, key=None):
        # f32 exp/sum regardless of the stored-activation dtype: the
        # posteriors feed log-objf and 1/p derivative terms (cheap —
        # the logits row is the narrow end of the net)
        return jax.nn.softmax(x.astype(jnp.float32), axis=1), None

    def backprop(self, params, in_value, out_value, out_deriv, aux):
        dot = jnp.sum((out_deriv * out_value).astype(jnp.float32),
                      axis=1, keepdims=True)
        return out_value * (out_deriv - dot)


@dataclass(frozen=True)
class DropoutComponent:
    dim: int
    proportion: float = 0.5    # probability of zeroing
    trainable: bool = False

    def init(self, key) -> Params:
        return {}

    def forward(self, params, x, train=False, key=None):
        if not train or key is None or self.proportion <= 0.0:
            return x, jnp.ones_like(x)
        keep = 1.0 - self.proportion
        # mask held in the input/storage dtype: a full f32 [N, dim]
        # aux tensor across forward/backward would claw back part of
        # the bf16 residual-storage HBM win (1/keep is exact in bf16
        # only for power-of-two keep, but dropout scaling needs no
        # more precision than the activations it multiplies)
        mask = ((jax.random.uniform(key, x.shape) < keep)
                .astype(x.dtype) / jnp.asarray(keep, x.dtype))
        return x * mask, mask

    def backprop(self, params, in_value, out_value, out_deriv, aux):
        return out_deriv * aux


@dataclass(frozen=True)
class SpliceComponent:
    """Frame splicing over time for whole-utterance inference
    (ref: SpliceComponent; in training the egs are pre-spliced like
    nnet-get-egs)."""

    input_dim: int
    left_context: int
    right_context: int
    trainable: bool = False

    @property
    def output_dim(self) -> int:
        return self.input_dim * (self.left_context + self.right_context + 1)

    def init(self, key) -> Params:
        return {}

    def forward(self, params, x, train=False, key=None):
        t = x.shape[0]
        offs = np.arange(-self.left_context, self.right_context + 1)
        idx = np.clip(np.arange(t)[:, None] + offs[None, :], 0, t - 1)
        return x[idx].reshape(t, -1), None

    def backprop(self, params, in_value, out_value, out_deriv, aux):
        """Index-scatter transpose of the forward gather: each input
        frame accumulates the derivative from every spliced window it
        appeared in, including the edge-clip duplicates
        (ref: nnet-component.cc SpliceComponent::Backprop)."""
        t = in_value.shape[0]
        w = self.left_context + self.right_context + 1
        offs = np.arange(-self.left_context, self.right_context + 1)
        idx = np.clip(np.arange(t)[:, None] + offs[None, :], 0, t - 1)
        od = out_deriv.reshape(t, w, self.input_dim)
        in_deriv = jnp.zeros((t, self.input_dim), out_deriv.dtype)
        return in_deriv.at[jnp.asarray(idx.reshape(-1))].add(
            od.reshape(t * w, self.input_dim))


@dataclass(frozen=True)
class IdentityComponent:
    """Pass-through (used as a branch of SliceParallelComponent)."""

    dim: int
    trainable: bool = False

    @property
    def input_dim(self):
        return self.dim

    @property
    def output_dim(self):
        return self.dim

    def init(self, key) -> Params:
        return {}

    def forward(self, params, x, train=False, key=None):
        return x, None

    def backprop(self, params, in_value, out_value, out_deriv, aux):
        return out_deriv


@dataclass(frozen=True)
class SliceParallelComponent:
    """Apply sub-components to contiguous input slices and concatenate
    their outputs — how auxiliary inputs (e.g. the online iVector of
    the Switchboard config) bypass the convolutional front end.
    (Upstream nnet2 appends the iVector inside the spliced input; the
    explicit parallel structure here is the nnet3 ParallelComponent
    shape, cleaner for the (t, f, c) conv volume layout.)"""

    parts: Tuple = ()

    @property
    def input_dim(self):
        return sum(p.input_dim for p in self.parts)

    @property
    def output_dim(self):
        return sum(p.output_dim for p in self.parts)

    @property
    def trainable(self):
        return any(getattr(p, "trainable", False) for p in self.parts)

    def _in_slices(self):
        out, o = [], 0
        for p in self.parts:
            out.append((o, o + p.input_dim))
            o += p.input_dim
        return out

    def _out_slices(self):
        out, o = [], 0
        for p in self.parts:
            out.append((o, o + p.output_dim))
            o += p.output_dim
        return out

    def init(self, key) -> Params:
        keys = jax.random.split(key, max(len(self.parts), 2))
        return {"parts": tuple(p.init(k)
                               for p, k in zip(self.parts, keys))}

    def forward(self, params, x, train=False, key=None):
        ys, auxs = [], []
        for p, pp, (i0, i1) in zip(self.parts, params["parts"],
                                   self._in_slices()):
            k = None
            if train and key is not None:
                k = jax.random.fold_in(key, i0)
            y, aux = p.forward(pp, x[:, i0:i1], train=train, key=k)
            ys.append(y)
            auxs.append(aux)
        return jnp.concatenate(ys, axis=1), auxs

    def backprop(self, params, in_value, out_value, out_deriv, aux):
        ds = []
        for p, pp, (i0, i1), (o0, o1), a in zip(
                self.parts, params["parts"], self._in_slices(),
                self._out_slices(), aux or [None] * len(self.parts)):
            ds.append(p.backprop(pp, in_value[:, i0:i1],
                                 out_value[:, o0:o1],
                                 out_deriv[:, o0:o1], a))
        return jnp.concatenate(ds, axis=1)

    def init_opt(self, ng_in: OnlineNaturalGradient,
                 ng_out: OnlineNaturalGradient):
        return {"parts": tuple(
            p.init_opt(ng_in, ng_out)
            if getattr(p, "trainable", False) else {}
            for p in self.parts)}

    def update(self, params, opt, in_value, out_deriv, lr, ng_in, ng_out):
        new_p, new_o = [], []
        for p, pp, oo, (i0, i1), (o0, o1) in zip(
                self.parts, params["parts"], opt["parts"],
                self._in_slices(), self._out_slices()):
            if getattr(p, "trainable", False):
                np_, no_ = p.update(pp, oo, in_value[:, i0:i1],
                                    out_deriv[:, o0:o1], lr,
                                    ng_in, ng_out)
            else:
                np_, no_ = pp, oo
            new_p.append(np_)
            new_o.append(no_)
        return {"parts": tuple(new_p)}, {"parts": tuple(new_o)}


def _conv_patch_indices(in_t, in_f, in_c, filt_t, filt_f,
                        stride_t, stride_f) -> np.ndarray:
    out_t = (in_t - filt_t) // stride_t + 1
    out_f = (in_f - filt_f) // stride_f + 1
    ot = np.arange(out_t)[:, None, None, None, None]
    of = np.arange(out_f)[None, :, None, None, None]
    dt = np.arange(filt_t)[None, None, :, None, None]
    df = np.arange(filt_f)[None, None, None, :, None]
    c = np.arange(in_c)[None, None, None, None, :]
    t = ot * stride_t + dt
    f = of * stride_f + df
    idx = (t * in_f + f) * in_c + c
    idx = np.broadcast_to(idx, (out_t, out_f, filt_t, filt_f, in_c))
    return np.ascontiguousarray(
        idx.reshape(out_t * out_f, filt_t * filt_f * in_c)).astype(np.int32)


@dataclass(frozen=True)
class Conv2DComponent:
    """2-D convolution over the (time, freq) plane of spliced fbank
    patches — the fork's Conv2DComponent reborn (per BASELINE.json; the
    upstream analogue is Convolutional1dComponent in
    src/nnet2/nnet-component.cc implemented as patch-gather + GEMM).

    Input rows are flattened [in_t, in_f, in_c] volumes; output rows are
    flattened [out_t, out_f, num_filters].  Forward = one XLA
    convolution, equal to im2col + one GEMM (``extract_patches`` gives
    the im2col view).
    """

    in_t: int
    in_f: int
    in_c: int
    filt_t: int
    filt_f: int
    num_filters: int
    stride_t: int = 1
    stride_f: int = 1
    param_stddev: Optional[float] = None
    max_change: float = 0.75
    trainable: bool = True

    @property
    def out_t(self) -> int:
        return (self.in_t - self.filt_t) // self.stride_t + 1

    @property
    def out_f(self) -> int:
        return (self.in_f - self.filt_f) // self.stride_f + 1

    @property
    def patch_dim(self) -> int:
        return self.filt_t * self.filt_f * self.in_c

    @property
    def num_patches(self) -> int:
        return self.out_t * self.out_f

    @property
    def input_dim(self) -> int:
        return self.in_t * self.in_f * self.in_c

    @property
    def output_dim(self) -> int:
        return self.num_patches * self.num_filters

    def _patch_indices(self) -> np.ndarray:
        """[num_patches, patch_dim] gather indices into the flat input."""
        return _conv_patch_indices(
            self.in_t, self.in_f, self.in_c, self.filt_t, self.filt_f,
            self.stride_t, self.stride_f)

    def init(self, key) -> Params:
        std = (self.param_stddev if self.param_stddev is not None
               else 1.0 / math.sqrt(self.patch_dim))
        k1, k2 = jax.random.split(key)
        w = std * jax.random.normal(
            k1, (self.num_filters, self.patch_dim), jnp.float32)
        b = 0.1 * jax.random.normal(k2, (self.num_filters,), jnp.float32)
        return {"w": w, "b": b}

    def extract_patches(self, x: jnp.ndarray) -> jnp.ndarray:
        """[N, input_dim] -> [N, num_patches, patch_dim]."""
        return x[:, self._patch_indices()]

    def _conv_nhwc(self, x: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
        """XLA-native convolution: [N, in_t, in_f, in_c] x HWIO kernel
        -> [N, out_t, out_f, F].  XLA picks the conv algorithm; an
        im2col gather and especially its scatter-add transpose move far
        more bytes.  w is [K, patch_dim] for
        any filter count K (the NG update convolves with the rank-R
        preconditioner basis too)."""
        k = w.shape[0]
        kernel = w.reshape(k, self.filt_t, self.filt_f,
                           self.in_c).transpose(1, 2, 3, 0)   # HWIO
        # lax.conv requires matching element types; with bf16-stored
        # train activations the (f32) weights ride along as bf16.  The
        # OUTPUT also stays in the input dtype: a f32
        # preferred_element_type on bf16 operands breaks the conv's
        # VJP (its transpose would mix a f32 cotangent with bf16
        # operands, which lax.conv rejects), and the matrix units
        # accumulate in f32 internally regardless — only the final
        # store rounds.
        kernel = kernel.astype(x.dtype)
        pref = jnp.float32 if x.dtype == jnp.float32 else None
        return jax.lax.conv_general_dilated(
            x, kernel,
            window_strides=(self.stride_t, self.stride_f),
            padding="VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=pref)

    @functools.cached_property
    def _patch_multiplicity(self) -> np.ndarray:
        """[input_dim] float32: how many im2col patch rows each input
        element lands in (for ‖patches‖² without materializing them)."""
        idx = self._patch_indices().ravel()
        return np.bincount(idx, minlength=self.input_dim
                           ).astype(np.float32)


    def forward(self, params, x, train=False, key=None):
        n = x.shape[0]
        xi = x.reshape(n, self.in_t, self.in_f, self.in_c)
        y = self._conv_nhwc(xi, params["w"])
        y = y + params["b"].astype(y.dtype)
        # [N, out_t, out_f, F] row-major == patches-major, filters-minor:
        # identical layout to the im2col path (patch p = (ot, of))
        return y.reshape(n, self.output_dim), None

    def backprop(self, params, in_value, out_value, out_deriv, aux):
        n = in_value.shape[0]
        xi = in_value.reshape(n, self.in_t, self.in_f, self.in_c)
        d = out_deriv.reshape(n, self.out_t, self.out_f,
                              self.num_filters)
        # input gradient = VJP of the conv (XLA emits the transposed
        # conv, vastly faster than the scatter-add im2col transpose)
        out, vjp = jax.vjp(lambda v: self._conv_nhwc(v, params["w"]), xi)
        (dx,) = vjp(d.astype(out.dtype))
        return dx.reshape(n, self.input_dim)

    # NG update treats each patch row as a data row, like the affine
    # layers (ref: Convolutional1dComponent::Update flattens patches)
    def init_opt(self, ng_in: OnlineNaturalGradient,
                 ng_out: OnlineNaturalGradient):
        return {"ng_in": ng_in.init(self.patch_dim + 1),
                "ng_out": ng_out.init(self.num_filters)}

    def update(self, params, opt, in_value, out_deriv, lr, ng_in, ng_out):
        """NG-SGD update over patch rows WITHOUT materializing im2col.

        Treating each (utterance-frame, patch-position) as a data row
        like the reference (Convolutional1dComponent::Update flattens
        patches), but computing every statistic fused_ng_delta needs
        directly from the compact conv layout:

          G      = dᵀ·patches  → XLA conv-backward-filter (one op)
          x·u_iᵀ projections   → a conv with the Rᵢ basis rows as filters
          ‖patches‖²           → Σ x²·multiplicity (static weights)
          dᵀd quadratic stats  → one [F, F] Gram GEMM

        A materialized path would write and re-read a
        [N·positions, patch] im2col (330 MB at mb 4096) plus three full
        passes over the 503 MB out-deriv; this one reads each once.
        """
        from kaldi_cnn_tpu.models.ng_sgd import ng_delta_from_stats
        n = in_value.shape[0]
        n_rows = n * self.num_patches
        xi = in_value.reshape(n, self.in_t, self.in_f, self.in_c)
        d = out_deriv.reshape(n, self.out_t, self.out_f, self.num_filters)
        d2 = out_deriv.reshape(n_rows, self.num_filters)
        state_in, state_out = opt["ng_in"], opt["ng_out"]

        # G extended with the bias column (ones-extended input rows).
        # Reductions over the (possibly bf16-stored) deriv accumulate
        # in f32: the casts/preferred types fuse into the reducing ops.
        cout, vjp = jax.vjp(lambda w: self._conv_nhwc(xi, w), params["w"])
        (gw,) = vjp(d.astype(cout.dtype))            # [F, patch_dim] f32
        gb = jnp.sum(d2, axis=0, dtype=jnp.float32)  # [F]
        g = jnp.concatenate([gw, gb[:, None]], axis=1)

        # input-side quadratic stats in the OLD basis
        u_i = state_in.u                             # [Rᵢ, patch_dim+1]
        proj_in = (self._conv_nhwc(xi, u_i[:, :-1])
                   + u_i[:, -1])                     # [n, ot, of, Rᵢ]
        proj_sq_in = jnp.sum(
            proj_in.reshape(-1, u_i.shape[0]) ** 2, axis=0)
        mult = jnp.asarray(self._patch_multiplicity)
        x_sq = jnp.sum((in_value * in_value) @ mult) + n_rows

        # output-side quadratic stats via the [F, F] Gram
        m = jnp.einsum("nf,ng->fg", d2, d2,
                       preferred_element_type=jnp.float32)
        d_sq = jnp.trace(m)
        u_o = state_out.u                            # [Rₒ, F]
        proj_sq_out = jnp.sum((u_o @ m) * u_o, axis=1)

        # deterministic-stride row samples for the state updates,
        # matching OnlineNaturalGradient.sample_rows on the flat
        # [n_rows] patch-row space
        s_i = min(n_rows, state_in.u.shape[0])
        stride_i = max(n_rows // s_i, 1)
        rows_i = np.arange(s_i) * stride_i
        n_idx, pos_idx = np.divmod(rows_i, self.num_patches)
        pidx = self._patch_indices()[pos_idx]        # [sᵢ, patch_dim]
        xs = jnp.take_along_axis(in_value[n_idx], jnp.asarray(pidx),
                                 axis=1)
        xs = jnp.concatenate(
            [xs, jnp.ones((s_i, 1), jnp.float32)], axis=1)
        s_o = min(n_rows, state_out.u.shape[0])
        stride_o = max(n_rows // s_o, 1)
        ds = d2[::stride_o][:s_o]

        delta, opt_in, opt_out = ng_delta_from_stats(
            ng_in, ng_out, state_in, state_out, g,
            x_sq, proj_sq_in, d_sq, proj_sq_out, xs, ds, n_rows)
        if self.max_change > 0:
            norm = jnp.sqrt(jnp.sum(delta * delta)) * jnp.abs(lr)
            scale = jnp.minimum(1.0,
                                self.max_change / jnp.maximum(norm, 1e-20))
        else:
            scale = 1.0
        step = lr * scale
        return ({"w": params["w"] + step * delta[:, :-1],
                 "b": params["b"] + step * delta[:, -1]},
                {"ng_in": opt_in, "ng_out": opt_out})


@dataclass(frozen=True)
class Maxpooling3DComponent:
    """3-D max pooling over (time, freq, channel) — the fork's
    MaxpoolingComponent (per BASELINE.json: 3-D pooling with custom CUDA
    kernels; here a reshape+max with exact subgradient backprop).  Pool
    sizes must divide the dims."""

    in_t: int
    in_f: int
    in_c: int
    pool_t: int = 1
    pool_f: int = 1
    pool_c: int = 1
    trainable: bool = False

    def __post_init__(self):
        assert self.in_t % self.pool_t == 0
        assert self.in_f % self.pool_f == 0
        assert self.in_c % self.pool_c == 0

    @property
    def out_t(self):
        return self.in_t // self.pool_t

    @property
    def out_f(self):
        return self.in_f // self.pool_f

    @property
    def out_c(self):
        return self.in_c // self.pool_c

    @property
    def input_dim(self):
        return self.in_t * self.in_f * self.in_c

    @property
    def output_dim(self):
        return self.out_t * self.out_f * self.out_c

    def init(self, key) -> Params:
        return {}

    def _blocks(self, x):
        n = x.shape[0]
        v = x.reshape(n, self.out_t, self.pool_t, self.out_f, self.pool_f,
                      self.out_c, self.pool_c)
        return v

    def _window_iota(self):
        """Flat within-window index on the 7-D block view (fused iota
        arithmetic, no materialized transpose)."""
        shape = (1, self.out_t, self.pool_t, self.out_f, self.pool_f,
                 self.out_c, self.pool_c)
        pt = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
        pf = jax.lax.broadcasted_iota(jnp.int32, shape, 4)
        pc = jax.lax.broadcasted_iota(jnp.int32, shape, 6)
        return (pt * self.pool_f + pf) * self.pool_c + pc

    def forward(self, params, x, train=False, key=None):
        n = x.shape[0]
        v = self._blocks(x)
        y = v.max(axis=(2, 4, 6))
        if not train:
            return y.reshape(n, self.output_dim), None
        # train: store the argmax WINDOW INDEX as aux so backprop never
        # re-reads the (503 MB at flagship mb) pre-pool activation or
        # the pooled output — with no backward consumer left, the
        # stored conv output drops out of the train step's HBM floor
        # (PERF.md §1 binding constraint 1).  First-index-wins on ties
        # (a valid subgradient; the reference's MaxpoolingComponent
        # assigns to every tied element — both choices are subgradients
        # of the same max).
        wid = self._window_iota()
        mask = v == y[:, :, None, :, None, :, None]
        big = jnp.int32(self.pool_t * self.pool_f * self.pool_c)
        idx = jnp.where(mask, wid, big).min(axis=(2, 4, 6))
        w = self.pool_t * self.pool_f * self.pool_c
        aux = (idx.astype(jnp.int8) if w < 128
               else idx.astype(jnp.int32))
        return y.reshape(n, self.output_dim), aux

    def backprop(self, params, in_value, out_value, out_deriv, aux):
        n = out_deriv.shape[0]
        d = out_deriv.reshape(n, self.out_t, 1, self.out_f, 1,
                              self.out_c, 1)
        if aux is not None:
            # scatter along the stored argmax index: reads the tiny
            # int8 aux + out_deriv instead of in_value AND out_value
            idx = aux.astype(jnp.int32).reshape(
                n, self.out_t, 1, self.out_f, 1, self.out_c, 1)
            dx = jnp.where(self._window_iota() == idx, d, 0.0)
            return dx.reshape(n, self.input_dim)
        # aux-free path (inference-style callers): recompute the mask,
        # splitting ties evenly
        v = self._blocks(in_value)
        y = out_value.reshape(n, self.out_t, 1, self.out_f, 1,
                              self.out_c, 1)
        mask = (v == y)
        count = jnp.sum(mask, axis=(2, 4, 6), keepdims=True)
        dx = jnp.where(mask, d / jnp.maximum(count, 1), 0.0)
        return dx.reshape(n, self.input_dim)

"""Nnet = ordered component list + the minibatch train step.

Mirrors src/nnet2/nnet-nnet.{h,cc} (Nnet), nnet-update.{h,cc}
(NnetUpdater::ComputeForMinibatch — THE training hot loop) and
am-nnet.{h,cc} (AmNnet = Nnet + pdf priors):

  forward:  x -> comp_0 -> ... -> comp_{L-1} (softmax posteriors)
  objf:     mean_n log p(label_n)   (cross-entropy, maximized)
  backward: out_deriv at the softmax OUTPUT is one_hot/(N*post) like the
            reference feeds its last component; each component's
            Backprop maps (in_value, out_value, out_deriv) -> in_deriv;
            trainable components update from their raw minibatch row
            spaces with NG-SGD.

The whole step — forward, backward, NG preconditioning, parameter
update — is one jit-compiled function; there is no Python in the loop
(the reference's DoBackpropParallel thread pool collapses into XLA
batch parallelism, SURVEY.md §2.2).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_cnn_tpu.core.backend import backend_policy
from kaldi_cnn_tpu.models.ng_sgd import OnlineNaturalGradient


class Nnet:
    def __init__(self, components: Sequence[Any],
                 ng_rank_in: int = 20, ng_rank_out: int = 80,
                 ng_update_period: int = 16,
                 train_storage_dtype: Optional[str] = None):
        self.components = list(components)
        # ranks per the reference defaults (train_pnorm_simple.sh:
        # --precondition-rank-in 20 --precondition-rank-out 80).
        # ng_update_period: the reference's update-period lever
        # (nnet-precondition-online.cc update_period_, default 4)
        # amortizes the Fisher-state eigenupdate; 16 here — the
        # (2R)x(2R) eigh chain is a serial, latency-bound step and the
        # preconditioner basis drifts slowly.  Convergence parity
        # vs period-4 is pinned by
        # tests/test_nnet_train.py::test_ng_update_period_16_parity.
        self.ng_in = OnlineNaturalGradient(rank=ng_rank_in,
                                           update_period=ng_update_period)
        self.ng_out = OnlineNaturalGradient(rank=ng_rank_out,
                                            update_period=ng_update_period)
        # dtype the TRAIN step stores activations / derivatives in
        # between components.  None = core.backend.backend_policy():
        # bfloat16 on an accelerator (the conv activation/derivative
        # tensors are the backward pass's memory floor — 503 MB each
        # in f32 at mb 4096), float32 on the CPU so the test oracle and
        # gradient checks are exact.  All cross-row reductions
        # accumulate in f32 regardless (the casts fuse into the
        # reducing op's operand read).
        self.train_storage_dtype = train_storage_dtype
        self._train_step_cache: Dict[Any, Any] = {}

    def _storage_dtype(self):
        """Resolved storage dtype for the train step, or None for f32
        (= store exactly what each component computes).  Rejects
        anything outside {None, f32, bf16}: a silent fallback would let
        a 'float16' typo train in f32 without anyone noticing."""
        dt = self.train_storage_dtype
        if dt is None:
            return backend_policy().train_storage_dtype
        if dt == jnp.bfloat16 or str(dt) in ("bfloat16", "bf16"):
            return jnp.bfloat16
        if dt == jnp.float32 or str(dt) in ("float32", "f32"):
            return None
        raise ValueError(
            f"train_storage_dtype={dt!r} unsupported; use None, "
            "'float32'/'f32', or 'bfloat16'/'bf16'")

    # -- dims --------------------------------------------------------------
    @property
    def input_dim(self) -> int:
        for c in self.components:
            d = getattr(c, "input_dim", None) or getattr(c, "dim", None)
            if d:
                return d
        raise ValueError("no dimensioned component")

    @property
    def output_dim(self) -> int:
        for c in reversed(self.components):
            d = getattr(c, "output_dim", None) or getattr(c, "dim", None)
            if d:
                return d
        raise ValueError("no dimensioned component")

    # -- params / opt state ------------------------------------------------
    def init(self, key) -> Tuple:
        # one jit for the whole init instead of one dispatch per op
        def _init(key):
            keys = jax.random.split(key, len(self.components))
            return tuple(c.init(k) for c, k in zip(self.components, keys))
        return jax.jit(_init)(key)

    def init_opt(self) -> Tuple:
        out = []
        for c in self.components:
            if getattr(c, "trainable", False):
                out.append(c.init_opt(self.ng_in, self.ng_out))
            else:
                out.append({})
        return tuple(out)

    # -- forward -----------------------------------------------------------
    def forward(self, params, x, train: bool = False, key=None,
                store_dtype=None):
        """Returns (output, activations, auxs); activations[i] is the
        INPUT of component i (activations[L] = final output).
        ``store_dtype`` (train step only) casts every stored activation
        — each component then consumes its predecessor's stored value,
        so backprop's in_value/out_value pairs stay self-consistent
        (e.g. the maxpool subgradient's v == y mask is exact)."""
        if store_dtype is not None:
            x = x.astype(store_dtype)
        acts = [x]
        auxs = []
        for i, c in enumerate(self.components):
            k = None
            if train and key is not None:
                k = jax.random.fold_in(key, i)
            y, aux = c.forward(params[i], acts[-1], train=train, key=k)
            if store_dtype is not None:
                y = y.astype(store_dtype)
            acts.append(y)
            auxs.append(aux)
        return acts[-1], acts, auxs

    def predict(self, params, x):
        """Inference forward pass (no dropout, no backprop auxs)."""
        y = x
        for c, p in zip(self.components, params):
            y, _ = c.forward(p, y, train=False)
        return y

    # -- the train step ----------------------------------------------------
    def _backward_update(self, params, opt, acts, auxs, out_deriv, lr,
                         store_dtype=None):
        """Shared backward walk + NG-SGD updates given the derivative at
        the network OUTPUT (the reference's NnetUpdater::Backprop).
        ``store_dtype`` casts each component's in_deriv before the next
        component consumes it (same rationale as forward's)."""
        new_params = list(params)
        new_opt = list(opt)
        deriv = out_deriv
        if store_dtype is not None:
            deriv = deriv.astype(store_dtype)
        for i in range(len(self.components) - 1, -1, -1):
            c = self.components[i]
            in_value, out_value = acts[i], acts[i + 1]
            if getattr(c, "trainable", False):
                new_params[i], new_opt[i] = c.update(
                    params[i], opt[i], in_value, deriv, lr,
                    self.ng_in, self.ng_out)
            if i > 0:
                deriv = c.backprop(params[i], in_value, out_value, deriv,
                                   auxs[i])
                if store_dtype is not None:
                    deriv = deriv.astype(store_dtype)
        return tuple(new_params), tuple(new_opt)

    def _train_step_impl(self, params, opt, x, labels, weights, lr, key):
        n = x.shape[0]
        sd = self._storage_dtype()
        out, acts, auxs = self.forward(params, x, train=True, key=key,
                                       store_dtype=sd)
        post = jnp.maximum(out.astype(jnp.float32), 1e-20)
        picked = jnp.take_along_axis(post, labels[:, None], axis=1)[:, 0]
        wsum = jnp.maximum(jnp.sum(weights), 1e-8)
        objf = jnp.sum(jnp.log(picked) * weights) / wsum
        # deriv of (sum_n w_n log out[n, label_n]) / wsum wrt out
        one_hot = jax.nn.one_hot(labels, out.shape[1], dtype=jnp.float32)
        out_deriv = one_hot * (weights / wsum)[:, None] / picked[:, None]
        new_params, new_opt = self._backward_update(
            params, opt, acts, auxs, out_deriv, lr, store_dtype=sd)
        return new_params, new_opt, objf

    def _discriminative_step_impl(self, params, opt, x, num_post,
                                  den_post, lr, key):
        """Lattice-based sequence-discriminative step
        (ref: nnet2/nnet-compute-discriminative.cc, MMI case): the
        objective gradient at the softmax output is
        (numerator occupancy - denominator occupancy) per (frame, pdf);
        through y that is (num - den) / y."""
        sd = self._storage_dtype()
        out, acts, auxs = self.forward(params, x, train=True, key=key,
                                       store_dtype=sd)
        y = jnp.maximum(out.astype(jnp.float32), 1e-20)
        n_frames = jnp.maximum(jnp.sum(num_post), 1e-8)
        objf = (jnp.sum(num_post * jnp.log(y))
                - jnp.sum(den_post * jnp.log(y))) / n_frames
        out_deriv = (num_post - den_post) / y / n_frames
        new_params, new_opt = self._backward_update(
            params, opt, acts, auxs, out_deriv, lr, store_dtype=sd)
        return new_params, new_opt, objf

    def discriminative_step(self, params, opt, x, num_post, den_post,
                            lr, key=None):
        """jit-cached MMI-style update; num_post/den_post [N, P]."""
        if key is None:
            key = np.zeros(2, np.uint32)
        shape_key = ("disc", x.shape, str(self._storage_dtype()))
        if shape_key not in self._train_step_cache:
            self._train_step_cache[shape_key] = jax.jit(
                self._discriminative_step_impl)
        return self._train_step_cache[shape_key](
            params, opt, x, num_post, den_post, np.float32(lr), key)

    def _train_step_impl_unweighted(self, params, opt, x, labels, lr, key):
        w = jnp.ones((x.shape[0],), jnp.float32)
        return self._train_step_impl(params, opt, x, labels, w, lr, key)

    def train_step(self, params, opt, x, labels, lr, key=None,
                   weights=None):
        """jit-cached minibatch update.  x [N, D] f32, labels [N] i32.
        Returns (params', opt', objf per frame).

        Scalars/constants cross into the jit as host values, so the
        wrapper issues no eager device op of its own: each step is one
        dispatch."""
        if key is None:
            key = np.zeros(2, np.uint32)
        sd = str(self._storage_dtype())
        if weights is None:
            shape_key = ("nw", x.shape, x.dtype, sd)
            if shape_key not in self._train_step_cache:
                self._train_step_cache[shape_key] = jax.jit(
                    self._train_step_impl_unweighted)
            return self._train_step_cache[shape_key](
                params, opt, x, labels, np.float32(lr), key)
        shape_key = (x.shape, x.dtype, sd)
        if shape_key not in self._train_step_cache:
            self._train_step_cache[shape_key] = jax.jit(self._train_step_impl)
        return self._train_step_cache[shape_key](
            params, opt, x, labels, weights, np.float32(lr), key)

    def _train_scan_impl(self, params, opt, xs, labels, weights, lr, keys):
        """K sequential SGD steps under ONE jit via lax.scan — the math
        is bit-identical to K train_step calls, but the host dispatches
        once per K steps instead of once per step (the loop stays
        inside XLA — SURVEY.md §7 design stance)."""
        def body(carry, batch):
            p, o = carry
            x, y, w, k, lr_t = batch
            p, o, objf = self._train_step_impl(p, o, x, y, w, lr_t, k)
            return (p, o), objf

        (p, o), objfs = jax.lax.scan(
            body, (params, opt), (xs, labels, weights, keys, lr))
        return p, o, objfs

    def train_steps(self, params, opt, xs, labels, lr, keys=None,
                    weights=None):
        """Scanned multi-step update.  xs [K, N, D] f32, labels [K, N]
        i32, lr scalar or [K], optional weights [K, N], keys [K, 2]
        uint32.  Returns (params', opt', objf per step [K])."""
        k_steps, n = xs.shape[0], xs.shape[1]
        if keys is None:
            keys = np.zeros((k_steps, 2), np.uint32)
        if weights is None:
            weights = np.ones((k_steps, n), np.float32)
        lrs = np.broadcast_to(np.asarray(lr, np.float32),
                              (k_steps,)).copy()
        shape_key = ("scan", xs.shape, xs.dtype,
                     str(self._storage_dtype()))
        if shape_key not in self._train_step_cache:
            self._train_step_cache[shape_key] = jax.jit(
                self._train_scan_impl)
        return self._train_step_cache[shape_key](
            params, opt, xs, labels, weights, lrs, keys)

    def _objf_impl(self, params, x, labels, weights):
        out, _, _ = self.forward(params, x, train=False)
        post = jnp.maximum(out, 1e-20)
        picked = jnp.take_along_axis(post, labels[:, None], axis=1)[:, 0]
        return jnp.sum(jnp.log(picked) * weights) / jnp.sum(weights)

    def _objf_impl_unweighted(self, params, x, labels):
        w = jnp.ones((x.shape[0],), jnp.float32)
        return self._objf_impl(params, x, labels, w)

    def objf(self, params, x, labels, weights=None):
        """Diagnostic log-prob per frame (ref: nnet-compute-prob).
        jit-cached per shape: one dispatch per call."""
        if weights is None:
            shape_key = ("objf-nw", x.shape)
            if shape_key not in self._train_step_cache:
                self._train_step_cache[shape_key] = jax.jit(
                    self._objf_impl_unweighted)
            return self._train_step_cache[shape_key](params, x, labels)
        shape_key = ("objf", x.shape)
        if shape_key not in self._train_step_cache:
            self._train_step_cache[shape_key] = jax.jit(self._objf_impl)
        return self._train_step_cache[shape_key](params, x, labels, weights)


class AmNnet:
    """Nnet + pdf priors (ref: src/nnet2/am-nnet.{h,cc}).  Decoding uses
    pseudo log-likelihoods log p(pdf|x) - log prior(pdf)
    (ref: decodable-am-nnet.cc DecodableAmNnet)."""

    def __init__(self, nnet: Nnet, num_pdfs: Optional[int] = None):
        self.nnet = nnet
        self.num_pdfs = num_pdfs or nnet.output_dim
        self.priors = np.full(self.num_pdfs, 1.0 / self.num_pdfs,
                              np.float64)
        # per-INSTANCE compiled predict: an lru_cache on the bound
        # method would be shared across AmNnets via the class, so two
        # live models (e.g. the wsj eval_dnn CNN-vs-DNN comparison)
        # would evict each other and retrace on every alternation
        self._predict_fn = jax.jit(
            lambda p, x: self.nnet.predict(p, x))

    def set_priors_from_counts(self, counts: np.ndarray,
                               smooth: float = 0.5) -> None:
        """(ref: nnet-adjust-priors; smoothed relative pdf frequencies)."""
        c = np.asarray(counts, np.float64) + smooth
        self.priors = c / c.sum()

    def loglikes(self, params, feats: np.ndarray,
                 batch_size: int = 512) -> np.ndarray:
        """[T, D] -> [T, num_pdfs] pseudo log-likelihoods (padded static
        batches so jit caches one shape)."""
        T = feats.shape[0]
        padded = -(-T // batch_size) * batch_size
        x = np.zeros((padded, feats.shape[1]), np.float32)
        x[:T] = feats
        outs = []
        fn = self._predict_jit()
        for i in range(0, padded, batch_size):
            outs.append(np.asarray(fn(params, jnp.asarray(x[i:i + batch_size]))))
        post = np.concatenate(outs)[:T]
        return (np.log(np.maximum(post, 1e-20))
                - np.log(self.priors)[None, :]).astype(np.float32)

    def _predict_jit(self):
        return self._predict_fn

    def loglikes_batch(self, params, feats: "Dict[str, np.ndarray]",
                       batch_size: int = 4096
                       ) -> "Dict[str, np.ndarray]":
        """Pseudo log-likelihoods for a keyed utterance set in ONE
        padded stream: frames from all utterances concatenate into
        [total, D] and run through predict in batch_size slices, then
        split back per utterance.  Versus per-utterance loglikes()
        calls this cuts both the per-call padding waste (a 230-frame
        utterance padded to 512) and the host dispatch count (~600
        round-trips -> ~total/4096) — the decode phases of the ledger
        recipes were dominated by exactly that loop."""
        keys = list(feats)
        if not keys:
            return {}
        lens = [int(feats[u].shape[0]) for u in keys]
        X = np.concatenate([np.asarray(feats[u], np.float32)
                            for u in keys])
        T = X.shape[0]
        padded = -(-T // batch_size) * batch_size
        if padded != T:
            X = np.concatenate(
                [X, np.zeros((padded - T, X.shape[1]), np.float32)])
        fn = self._predict_fn
        outs = []
        for i in range(0, padded, batch_size):
            outs.append(np.asarray(
                fn(params, jnp.asarray(X[i:i + batch_size]))))
        post = np.concatenate(outs)[:T]
        ll = (np.log(np.maximum(post, 1e-20))
              - np.log(self.priors)[None, :]).astype(np.float32)
        out = {}
        off = 0
        for u, n in zip(keys, lens):
            out[u] = ll[off:off + n]
            off += n
        return out

"""The nnet2 trainer loop.

Mirrors steps/nnet2/train_pnorm_simple.sh / train_convnet_accel2.sh
semantics in one process:
  - exponential learning-rate schedule initial_lr -> final_lr
    (ref: the scripts' --initial-learning-rate/--final-learning-rate)
  - per-iteration train/valid log-prob diagnostics
    (ref: nnet-compute-prob, exp/*/log/compute_prob_*.log)
  - per-iteration checkpoints (ref: exp/$dir/$iter.mdl)
  - final model combination over the last N iterates
    (ref: nnet-combine-fast) and prior adjustment
    (ref: nnet-adjust-priors)

Data-parallel scaling lives in parallel/dp.py; this loop calls a step
function that is either the single-chip jit or the mesh-sharded jit.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_cnn_tpu.core.backend import matmul_precision_scope
from kaldi_cnn_tpu.core.config import configclass
from kaldi_cnn_tpu.core.logging import MetricsWriter, Timer, get_logger
from kaldi_cnn_tpu.core.rng import stage_key
from kaldi_cnn_tpu.models.nnet import Nnet
from kaldi_cnn_tpu.train.checkpoint import save_checkpoint
from kaldi_cnn_tpu.train.egs import Egs, EgsBatcher

logger = get_logger(__name__)


@configclass
class TrainConfig:
    num_epochs: int = 10
    minibatch_size: int = 512
    initial_learning_rate: float = 0.02
    final_learning_rate: float = 0.002
    combine_num_models: int = 8
    valid_minibatches: int = 10
    checkpoint_dir: str = ""
    seed: int = 0
    # None = core.backend.backend_policy(): "bfloat16" on an
    # accelerator (convergence parity with f32 is pinned by
    # tests/test_nnet_train.py), no override on the CPU
    matmul_precision: Optional[str] = None
    # run this many sequential SGD steps per host dispatch via
    # Nnet.train_steps (lax.scan — bit-identical math to per-step
    # calls).  1 disables.
    scan_steps: int = 8


def lr_at(cfg: TrainConfig, frac_done: float) -> float:
    """Exponential decay like the reference scripts."""
    return (cfg.initial_learning_rate
            * (cfg.final_learning_rate / cfg.initial_learning_rate)
            ** min(max(frac_done, 0.0), 1.0))


def _valid_objf(net: Nnet, params, egs: Egs, cfg: TrainConfig) -> float:
    mb = cfg.minibatch_size
    n = min(len(egs), mb * cfg.valid_minibatches)
    tot, cnt = 0.0, 0
    for i in range(0, n, mb):
        x = egs.x[i:i + mb]
        if len(x) < mb:
            break
        o = float(net.objf(params, jnp.asarray(x),
                           jnp.asarray(egs.y[i:i + mb])))
        tot += o * mb
        cnt += mb
    return tot / max(cnt, 1)


def combine_models_per_component(net: Nnet, param_list: List,
                                 egs_valid: Egs, cfg: TrainConfig,
                                 steps: int = 80, lr: float = 0.3,
                                 reg: float = 1e-3) -> Tuple:
    """Per-component regularized model combination: one softmax weight
    vector over the candidate models PER component, optimized by
    gradient ascent on validation log-prob with an L2 pull toward
    uniform weights (ref: nnet2/nnet-combine-fast.cc, which optimizes
    per-updatable-component scales with preconditioned LBFGS and a
    regularizer; same objective and granularity, realized with jitted
    momentum gradient ascent).  Strictly generalizes whole-model
    combination — per-component weights can express any whole-model
    mix — which is what buys the final tenths of WER in the reference
    recipes."""
    if len(param_list) == 1:
        return param_list[0]
    m = len(param_list)
    c = len(param_list[0])
    mb = min(cfg.minibatch_size * 4, max(len(egs_valid), 1))
    x = jnp.asarray(egs_valid.x[:mb])
    y = jnp.asarray(egs_valid.y[:mb])
    # stacked: tuple (per component) of dicts of [M, ...] leaves
    stacked = jax.tree_util.tree_map(
        lambda *leaves: jnp.stack(leaves), *param_list)

    def mix(logits):
        return tuple(
            jax.tree_util.tree_map(
                lambda s, i=i: jnp.tensordot(
                    jax.nn.softmax(logits[:, i]), s, axes=1), stacked[i])
            for i in range(c))

    def loss(logits):
        return -net.objf(mix(logits), x, y) + reg * jnp.sum(logits ** 2)

    @jax.jit
    def opt_all(logits):
        def body(carry, _):
            lg, vel = carry
            val, g = jax.value_and_grad(loss)(lg)
            vel = 0.9 * vel - lr * g
            return (lg + vel, vel), val
        (lg, _), vals = jax.lax.scan(
            body, (logits, jnp.zeros_like(logits)), None, length=steps)
        return lg, vals

    logits, vals = opt_all(jnp.zeros((m, c)))
    w = np.asarray(jax.nn.softmax(np.asarray(logits), axis=0))
    logger.info("combine(per-component): weight range %.3f..%.3f",
                float(w.min()), float(w.max()))
    return jax.device_get(jax.jit(mix)(logits))


def combine_models(net: Nnet, param_list: List, egs_valid: Egs,
                   cfg: TrainConfig, steps: int = 60,
                   lr: float = 0.2) -> Tuple:
    """Learn a convex combination of the last models on validation egs
    (whole-model softmax weights — the coarse variant;
    combine_models_per_component is the production finalizer)."""
    if len(param_list) == 1:
        return param_list[0]
    mb = min(cfg.minibatch_size * 4, max(len(egs_valid), 1))
    x = jnp.asarray(egs_valid.x[:mb])
    y = jnp.asarray(egs_valid.y[:mb])
    stacked = jax.tree_util.tree_map(
        lambda *leaves: jnp.stack(leaves), *param_list)

    def mix(logits):
        w = jax.nn.softmax(logits)
        return jax.tree_util.tree_map(
            lambda s: jnp.tensordot(w, s, axes=1), stacked)

    def loss(logits):
        return -net.objf(mix(logits), x, y)

    logits = jnp.zeros(len(param_list))
    grad_fn = jax.jit(jax.value_and_grad(loss))
    for _ in range(steps):
        val, g = grad_fn(logits)
        logits = logits - lr * g
    w = np.asarray(jax.nn.softmax(logits))
    logger.info("combine: weights %s", np.round(w, 3))
    return jax.device_get(jax.jit(mix)(logits))


def train_nnet(
    net: Nnet,
    egs_train: Optional[Egs],
    egs_valid: Egs,
    cfg: Optional[TrainConfig] = None,
    step_fn: Optional[Callable] = None,
    metrics: Optional[MetricsWriter] = None,
    frames_per_second: float = 100.0,
    batcher=None,
) -> Tuple:
    """Returns (final params, opt state).  ``step_fn`` defaults to the
    single-chip net.train_step; parallel/dp.py provides the sharded
    variant with identical signature.  ``batcher`` overrides the
    in-memory EgsBatcher — e.g. a
    train.sharded_egs.StreamingEgsBatcher streaming shards from disk
    (then ``egs_train`` may be None)."""
    cfg = cfg or TrainConfig()
    with matmul_precision_scope(cfg.matmul_precision):
        return _train_nnet_impl(net, egs_train, egs_valid, cfg, step_fn,
                                metrics, frames_per_second, batcher)


def _train_nnet_impl(
    net: Nnet,
    egs_train: Optional[Egs],
    egs_valid: Egs,
    cfg: TrainConfig,
    step_fn: Optional[Callable],
    metrics: Optional[MetricsWriter],
    frames_per_second: float,
    batcher,
) -> Tuple:
    params = net.init(jax.random.PRNGKey(
        int(stage_key(cfg.seed, "init")[1])))
    opt = net.init_opt()
    step = step_fn or net.train_step
    batcher = batcher or EgsBatcher(egs_train, cfg.minibatch_size,
                                    cfg.seed)
    total_iters = cfg.num_epochs * batcher.num_batches()
    it = 0
    history: List = []
    timer = Timer()
    for epoch in range(cfg.num_epochs):
        # objf values stay on-device until the epoch ends: a float()
        # per step would sync host<->device every minibatch and stall
        # the pipeline (same class of overhead as eager wrapper ops —
        # see Nnet.train_step)
        timer.reset()
        it0 = it
        objfs: List = []
        frame_counts: List[float] = []
        # default single-chip path: group minibatches and run them as
        # ONE scanned dispatch (Nnet.train_steps — same math as K
        # train_step calls; EgsBatcher shapes are static so one jit
        # serves every group).  Custom step_fns (the sharded mesh
        # step) keep the per-step loop.
        k_scan = cfg.scan_steps if step_fn is None else 1
        pending: List = []

        def flush():
            nonlocal params, opt, it
            if not pending:
                return
            # partial trailing groups run per-step so the scan jit
            # compiles exactly one [K, ...] shape per recipe
            if len(pending) < k_scan or k_scan <= 1:
                for x, y, w in pending:
                    lr = lr_at(cfg, it / max(total_iters - 1, 1))
                    key = stage_key(cfg.seed, "train_step", it)
                    params, opt, objf = step(params, opt, x, y, lr,
                                             key=key, weights=w)
                    objfs.append(objf)
                    frame_counts.append(float(w.sum()))
                    it += 1
            else:
                k = len(pending)
                lrs = np.asarray(
                    [lr_at(cfg, (it + j) / max(total_iters - 1, 1))
                     for j in range(k)], np.float32)
                keys = np.stack(
                    [np.asarray(stage_key(cfg.seed, "train_step",
                                          it + j), np.uint32)
                     for j in range(k)])
                xs = np.stack([p[0] for p in pending])
                ys = np.stack([p[1] for p in pending])
                ws = np.stack([p[2] for p in pending])
                params, opt, objf_k = net.train_steps(
                    params, opt, xs, ys, lrs, keys=keys, weights=ws)
                objfs.extend(objf_k[j] for j in range(k))
                frame_counts.extend(float(w.sum()) for w in ws)
                it += k
            pending.clear()

        for batch in batcher.epoch(epoch):
            pending.append(batch)
            if len(pending) >= k_scan:
                flush()
        flush()
        # ONE stacked transfer for the epoch's objf scalars instead of
        # one device_get per scalar
        objf_host = jax.device_get(jnp.stack(objfs)) if objfs else []
        epoch_objf = sum(float(o) * n
                         for o, n in zip(objf_host, frame_counts))
        train_prob = epoch_objf / max(sum(frame_counts), 1)
        valid_prob = _valid_objf(net, params, egs_valid, cfg)
        # per-epoch rate: epoch 0 includes the train-step jit compile,
        # later epochs are steady-state
        elapsed = max(timer.elapsed(), 1e-9)
        audio_ss = ((it - it0) * cfg.minibatch_size
                    / frames_per_second) / elapsed
        logger.info(
            "epoch %d: train logprob %.4f valid %.4f lr %.4g "
            "(%.0f audio-s/s)", epoch, train_prob, valid_prob,
            lr_at(cfg, it / max(total_iters - 1, 1)), audio_ss)
        if metrics:
            metrics.write("train_epoch", epoch=epoch,
                          train_logprob=train_prob,
                          valid_logprob=valid_prob,
                          audio_seconds_per_sec=audio_ss)
        # history stays ON DEVICE: the combine pass consumes device
        # arrays directly, so no per-epoch copy of the model crosses to
        # the host; the window is bounded by combine_num_models
        history.append(params)
        if len(history) > cfg.combine_num_models:
            history.pop(0)
        if cfg.checkpoint_dir:
            save_checkpoint(
                os.path.join(cfg.checkpoint_dir, f"epoch{epoch}.npz"),
                params, opt, {"epoch": epoch, "iter": it})
    final = combine_models_per_component(net, history, egs_valid, cfg)
    final_valid = _valid_objf(net, final, egs_valid, cfg)
    last_valid = _valid_objf(net, history[-1], egs_valid, cfg)
    if final_valid < last_valid:
        logger.info("combine did not help (%.4f < %.4f); keeping last",
                    final_valid, last_valid)
        final = history[-1]
    logger.info("final valid logprob %.4f", max(final_valid, last_valid))
    if cfg.checkpoint_dir:
        save_checkpoint(os.path.join(cfg.checkpoint_dir, "final.npz"),
                        final, None, {"final": True})
    return final, opt

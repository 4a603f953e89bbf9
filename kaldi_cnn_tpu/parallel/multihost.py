"""Multi-host / multi-replica training driver (the Librispeech-960h
configuration).

The JAX replacement of the reference's cluster layer
(ref: utils/parallel/queue.pl submitting N jobs + per-iteration
nnet-am-average barrier, SURVEY.md §2.3): one Python process per host,
``jax.distributed`` process group, utterance lists sharded per host,
and a global jit'd train step over a ("replica", "data") mesh:

  - within a replica, the batch shards over the ``data`` axis and
    gradients are summed by a GSPMD-inserted psum (mode A);
  - across replicas, SGD streams are INDEPENDENT — exactly the
    reference's N parallel jobs — synchronized only by a parameter
    mean every ``average_every`` steps (= nnet-am-average, ref:
    src/nnet2bin/nnet-am-average.cc; Povey et al. ICLR WS 2015).  XLA
    inserts the replica-axis all-reduce from the sharding annotations
    alone, whether the replicas share a host or not.

With num_replicas == 1 (or average_every == 0) this degenerates to
mode A on the whole mesh, so the same driver runs everywhere (tested
on the virtual 8-device CPU mesh).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from kaldi_cnn_tpu.core.backend import matmul_precision_scope
from kaldi_cnn_tpu.core.config import configclass
from kaldi_cnn_tpu.core.logging import MetricsWriter, Timer, get_logger
from kaldi_cnn_tpu.models.nnet import Nnet
from kaldi_cnn_tpu.parallel.dp import make_dp_step, stack_replicas
from kaldi_cnn_tpu.train.egs import Egs, EgsBatcher
from kaldi_cnn_tpu.train.trainer import TrainConfig, lr_at

logger = get_logger(__name__)


@configclass
class MultihostConfig:
    coordinator: str = ""          # "host:port" of process 0
    num_processes: int = 1
    process_id: int = 0
    average_every: int = 0         # 0 = pure per-step psum (mode A)
    num_replicas: int = 1          # independent SGD streams (slices)
    mesh_axes: Tuple[str, ...] = ("replica", "data")


def initialize(cfg: MultihostConfig) -> Mesh:
    """Process-group init + global ("replica", "data") mesh over all
    devices (ref replacement for the $cmd scheduler)."""
    if cfg.coordinator and cfg.num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=cfg.coordinator,
            num_processes=cfg.num_processes,
            process_id=cfg.process_id)
    devices = np.array(jax.devices())
    r = max(cfg.num_replicas, 1)
    assert len(devices) % r == 0, \
        f"{len(devices)} devices not divisible into {r} replicas"
    return Mesh(devices.reshape(r, -1), ("replica", "data"))


def shard_utterances(utts: List[str], cfg: MultihostConfig) -> List[str]:
    """Deterministic per-host utterance shard
    (ref: utils/split_data.sh)."""
    return [u for i, u in enumerate(sorted(utts))
            if i % max(cfg.num_processes, 1) == cfg.process_id]


def make_replica_dp_step(net: Nnet, mesh: Mesh) -> Callable:
    """Hybrid step: independent replica streams over the ``replica``
    mesh axis (leading axis of stacked params / batches), per-step
    gradient psum over the ``data`` axis inside each replica."""
    rep = lambda spec: NamedSharding(mesh, spec)
    p_r = rep(P("replica"))
    p_rd = rep(P("replica", "data"))
    vstep = jax.vmap(net._train_step_impl,
                     in_axes=(0, 0, 0, 0, 0, None, 0))
    jitted = jax.jit(
        vstep,
        in_shardings=(p_r, p_r, p_rd, p_rd, p_rd, rep(P()), p_r),
        out_shardings=(p_r, p_r, p_r),
    )

    def step(params_r, opt_r, x_r, labels_r, lr, keys_r, weights_r):
        return jitted(params_r, opt_r, x_r, labels_r, weights_r,
                      jnp.asarray(lr, jnp.float32), keys_r)

    return step


def make_replica_average(mesh: Mesh) -> Callable:
    """The nnet-am-average point: mean over the replica axis,
    broadcast back — GSPMD lowers this to one all-reduce across
    replicas."""
    p_r = NamedSharding(mesh, P("replica"))

    def _avg(tree):
        return jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(jnp.mean(x, axis=0,
                                                keepdims=True), x.shape),
            tree)

    return jax.jit(_avg, in_shardings=(p_r,), out_shardings=p_r)


def _replica_keys(seed: int, it: int, r: int) -> np.ndarray:
    from kaldi_cnn_tpu.core.rng import stage_key
    return np.stack([np.asarray(stage_key(seed, "mh_step", it * r + i),
                                np.uint32) for i in range(r)])


def train_multihost(
    net: Nnet,
    egs_train: Optional[Egs],
    egs_valid: Egs,
    cfg: Optional[TrainConfig] = None,
    mh: Optional[MultihostConfig] = None,
    mesh: Optional[Mesh] = None,
    metrics: Optional[MetricsWriter] = None,
    batcher=None,
    return_replicas: bool = False,
):
    """Mesh training loop.  ``num_replicas > 1`` with
    ``average_every > 0`` reproduces the reference's semantics —
    independent streams + periodic parameter averaging; otherwise one
    globally-synchronous stream (mode A).  Per-step objf stays on
    device; the host reads it once per epoch (no per-minibatch
    device->host sync).  ``return_replicas`` (replica mode) returns the
    averaged params/opt with their leading replica axis instead of
    replica 0's copy: the one way a caller can see that the final
    average left every replica identical."""
    cfg = cfg or TrainConfig()
    mh = mh or MultihostConfig()
    mesh = mesh or initialize(mh)
    with matmul_precision_scope(cfg.matmul_precision):
        return _train_multihost_impl(net, egs_train, egs_valid, cfg, mh,
                                     mesh, metrics, batcher,
                                     return_replicas)


def _train_multihost_impl(net, egs_train, egs_valid, cfg, mh, mesh,
                          metrics, batcher, return_replicas):
    from kaldi_cnn_tpu.core.rng import stage_key
    params = net.init(jax.random.PRNGKey(
        int(stage_key(cfg.seed, "init")[1])))
    opt = net.init_opt()
    r = max(mh.num_replicas, 1)
    replica_mode = mh.average_every > 0 and r > 1
    if replica_mode:
        p_r = NamedSharding(mesh, P("replica"))
        params = jax.device_put(stack_replicas(params, r), p_r)
        opt = jax.device_put(stack_replicas(opt, r), p_r)
        step = make_replica_dp_step(net, mesh)
        average = make_replica_average(mesh)
    else:
        step = make_dp_step(net, mesh)

    batcher = batcher or EgsBatcher(egs_train, cfg.minibatch_size,
                                    cfg.seed)
    total = cfg.num_epochs * batcher.num_batches()
    it = 0
    timer = Timer()
    # XLA:CPU collectives abort with a fixed 40 s rendezvous timeout
    # when partition threads of DIFFERENT queued step executions
    # interleave on an oversubscribed host (measured: full-scale runs
    # on the 2-core CI box die on the first all-reduce).  Keeping at
    # most one step in flight bounds the skew; on an accelerator the
    # async queue stays (it is the throughput model).
    throttle = jax.default_backend() == "cpu"
    for epoch in range(cfg.num_epochs):
        ep_objf = jnp.zeros(())     # device accumulator, read per epoch
        ep_frames = 0
        for x, y, w in batcher.epoch(epoch):
            lr = lr_at(cfg, it / max(total - 1, 1))
            if replica_mode:
                n = x.shape[0] - x.shape[0] % r
                xs = x[:n].reshape(r, n // r, *x.shape[1:])
                ys = y[:n].reshape(r, n // r, *y.shape[1:])
                ws = w[:n].reshape(r, n // r, *w.shape[1:])
                keys = _replica_keys(cfg.seed, it, r)
                params, opt, objf = step(params, opt, xs, ys, lr, keys,
                                         ws)
                objf = jnp.mean(objf)
            else:
                key = stage_key(cfg.seed, "mh_step", it)
                params, opt, objf = step(params, opt, x, y, lr, key=key,
                                         weights=w)
            if throttle:
                jax.block_until_ready(objf)
            ep_objf = ep_objf + objf * float(w.sum())
            ep_frames += int(w.sum())
            it += 1
            if replica_mode and it % mh.average_every == 0:
                params = average(params)
        train_prob = float(ep_objf) / max(ep_frames, 1)
        audio_ss = (it * cfg.minibatch_size / 100.0) / timer.elapsed()
        logger.info("mh epoch %d: train logprob %.4f (%.2f audio-s/s, "
                    "%d devices, %d replicas)", epoch, train_prob,
                    audio_ss, len(mesh.devices.flatten()), r)
        if metrics:
            metrics.write("mh_epoch", epoch=epoch,
                          train_logprob=train_prob,
                          audio_seconds_per_sec=audio_ss)
    if replica_mode:
        params = average(params)
        if return_replicas:
            return params, opt
        params = jax.tree_util.tree_map(lambda x: x[0], params)
        opt = jax.tree_util.tree_map(lambda x: x[0], opt)
    return params, opt

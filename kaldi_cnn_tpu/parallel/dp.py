"""Data-parallel training step over a jax.sharding.Mesh.

The JAX successor of the reference's data parallelism
(ref: steps/nnet2/train_*.sh N parallel jobs + nnet2bin/nnet-am-average
per iteration; theory in Povey et al. ICLR WS 2015):

  mode A (default): ONE jitted train step over the global minibatch,
  batch sharded on the ``data`` mesh axis, params/opt replicated.  The
  NG-SGD delta contractions (deriv_hatᵀ @ in_hat) contract over the
  sharded row dimension, so GSPMD inserts the psum automatically —
  per-step gradient exchange without writing a single collective.

  mode B (reference semantics): independent per-device updates with
  periodic ``average_params`` (= nnet-am-average) — for infrequent
  cross-host sync or for reproducing the reference's training
  dynamics.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from kaldi_cnn_tpu.models.nnet import Nnet


def make_dp_step(net: Nnet, mesh: Mesh) -> Callable:
    """Returns step(params, opt, x, labels, lr, key=None, weights=None)
    with x/labels/weights sharded over the 'data' axis."""
    repl = NamedSharding(mesh, P())
    shard = NamedSharding(mesh, P("data"))

    jitted = jax.jit(
        net._train_step_impl,
        in_shardings=(repl, repl, shard, shard, shard, repl, repl),
        out_shardings=(repl, repl, repl),
    )
    # no-weights variant keeps the ones-vector INSIDE the jit, so the
    # wrapper issues no eager device op (see Nnet.train_step note)
    jitted_nw = jax.jit(
        net._train_step_impl_unweighted,
        in_shardings=(repl, repl, shard, shard, repl, repl),
        out_shardings=(repl, repl, repl),
    )

    def step(params, opt, x, labels, lr, key=None, weights=None):
        if key is None:
            key = np.zeros(2, np.uint32)
        if weights is None:
            return jitted_nw(params, opt, x, labels, np.float32(lr), key)
        return jitted(params, opt, x, labels, weights, np.float32(lr),
                      key)

    return step


def make_dp_tp_step(net: Nnet, mesh: Mesh) -> Callable:
    """Data parallelism over the ``data`` axis + tensor parallelism for
    the wide affine layers over the ``model`` axis: weight rows (output
    dim) shard, so each model shard computes its slice of the
    activations and GSPMD inserts the collectives (capability beyond
    the reference — SURVEY.md §2.2 TP row: 'provide via pjit param
    sharding on a model axis if the AM exceeds one chip')."""
    from kaldi_cnn_tpu.models.components import AffineComponent
    repl = NamedSharding(mesh, P())
    data = NamedSharding(mesh, P("data"))
    m = mesh.shape.get("model", 1)
    params0 = net.init(jax.random.PRNGKey(0))
    pspecs = []
    for comp, p in zip(net.components, params0):
        if (isinstance(comp, AffineComponent) and m > 1
                and comp.output_dim % m == 0):
            pspecs.append({"w": NamedSharding(mesh, P("model", None)),
                           "b": NamedSharding(mesh, P("model"))})
        else:
            pspecs.append(jax.tree_util.tree_map(lambda _: repl, p))
    pspecs = tuple(pspecs)

    jitted = jax.jit(
        net._train_step_impl,
        in_shardings=(pspecs, repl, data, data, data, repl, repl),
        out_shardings=(pspecs, repl, repl),
    )
    jitted_nw = jax.jit(
        net._train_step_impl_unweighted,
        in_shardings=(pspecs, repl, data, data, repl, repl),
        out_shardings=(pspecs, repl, repl),
    )

    def step(params, opt, x, labels, lr, key=None, weights=None):
        if key is None:
            key = np.zeros(2, np.uint32)
        if weights is None:
            return jitted_nw(params, opt, x, labels, np.float32(lr), key)
        return jitted(params, opt, x, labels, weights, np.float32(lr),
                      key)

    return step


def make_replica_step(net: Nnet, mesh: Mesh, num_replicas: int
                      ) -> Callable:
    """Mode B — the reference's exact semantics: ``num_replicas``
    independent SGD streams (one per mesh ``data`` slot), synchronized
    only by explicit ``average_params`` calls
    (ref: steps/nnet2/train_*.sh N parallel jobs + nnet-am-average;
    Povey et al. ICLR WS 2015 — NG-SGD makes the averaging work).

    Takes stacked params/opt (leading replica axis, e.g. from
    ``stack_replicas``) and per-replica batches x [R, B, D]."""
    repl_axis = NamedSharding(mesh, P("data"))

    vstep = jax.vmap(net._train_step_impl,
                     in_axes=(0, 0, 0, 0, 0, None, 0))
    jitted = jax.jit(
        vstep,
        in_shardings=(repl_axis, repl_axis, repl_axis, repl_axis,
                      repl_axis, NamedSharding(mesh, P()), repl_axis),
        out_shardings=(repl_axis, repl_axis, repl_axis),
    )

    def step(params_r, opt_r, x_r, labels_r, lr, keys_r=None,
             weights_r=None):
        r, n = x_r.shape[0], x_r.shape[1]
        if weights_r is None:
            weights_r = jnp.ones((r, n), jnp.float32)
        if keys_r is None:
            keys_r = np.zeros((r, 2), np.uint32)
        # inputs may be committed with another sharding (e.g. fresh
        # replicated stacks): move them onto the replica layout first
        put = lambda t: jax.device_put(t, repl_axis)
        return jitted(put(params_r), put(opt_r), put(jnp.asarray(x_r)),
                      put(jnp.asarray(labels_r)),
                      put(jnp.asarray(weights_r)),
                      jnp.asarray(lr, jnp.float32),
                      put(jnp.asarray(keys_r)))

    return step


def stack_replicas(tree, num_replicas: int):
    """Replicate a pytree along a new leading axis."""
    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(jnp.asarray(x)[None],
                                   (num_replicas,) + jnp.asarray(x).shape),
        tree)


def average_replicas(tree_r):
    """nnet-am-average over the leading replica axis (the once-per-
    outer-iteration sync of the reference)."""
    return jax.tree_util.tree_map(lambda x: jnp.mean(x, axis=0), tree_r)


def average_params(param_list):
    """nnet-am-average equivalent: elementwise mean over model copies
    (ref: src/nnet2bin/nnet-am-average.cc)."""
    n = len(param_list)
    return jax.tree_util.tree_map(
        lambda *leaves: sum(leaves) / n, *param_list)


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-host process-group init (ref replacement for queue.pl job
    launching; SURVEY.md §2.3).  No-op when single-process."""
    if coordinator is None:
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)

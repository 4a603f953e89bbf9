"""Device mesh + sharding helpers.

JAX replacement for Kaldi's shell-scheduler parallelism
(ref: utils/parallel/{run.pl,queue.pl}, SURVEY.md §2.2/§2.3): instead of
N independent processes synchronized through files, we build a
``jax.sharding.Mesh`` over the available devices and annotate arrays
with ``NamedSharding``; XLA inserts the collectives.  The devices of one
host are joined all to all, so the mesh is shaped by the algorithm
alone (devices in ``jax.devices()`` order).

Axes:
  - ``data``  : utterance/minibatch data parallelism (the reference's
                N parallel SGD jobs; ref steps/nnet2/train_*.sh).
  - ``model`` : parameter sharding if the acoustic model exceeds one
                chip (absent in the reference; BASELINE.json asks for it).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    data: Optional[int] = None,
    model: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (data, model) mesh over the given (default: all) devices."""
    devs = list(devices) if devices is not None else jax.devices()
    n = len(devs)
    if data is None:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"data*model = {data * model} != {n} devices")
    arr = np.array(devs).reshape(data, model)
    return Mesh(arr, axis_names=("data", "model"))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Batch-dim sharding over the data axis (leading dim)."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, batch):
    """Place a host-local pytree of arrays batch-sharded over ``data``."""
    sh = data_sharding(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), batch)


def local_slice(n: int, axis_size: int, axis_index: int) -> Tuple[int, int]:
    """[start, end) of this host's slice of a length-n global batch."""
    per = n // axis_size
    return axis_index * per, (axis_index + 1) * per

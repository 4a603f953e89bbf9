"""Parallel scaling: device-mesh data parallelism, model averaging,
multi-host init.

Replaces the reference's shell-scheduler parallelism (SURVEY.md §2.2:
N independent SGD jobs + nnet-am-average per outer iteration,
utils/parallel/{run.pl,queue.pl}) with jax.sharding over a Mesh: the
global minibatch is sharded over the ``data`` axis and XLA inserts the
collectives inside the one jitted train step.  The reference's exact
periodic-averaging semantics remain available via ``average_params``
for infrequent cross-host synchronization.
"""

from kaldi_cnn_tpu.parallel.dp import make_dp_step, average_params
from kaldi_cnn_tpu.core.mesh import make_mesh, data_sharding, replicated

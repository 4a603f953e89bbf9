"""kaldi_cnn_tpu — a JAX hybrid ASR framework.

A from-scratch JAX/XLA re-design of the capabilities of
hwaranlee/kaldi-cnn (Kaldi + nnet2 CNN acoustic models):

- ``features``  : fbank/MFCC extraction (framing + rfft + mel), plain
                  jnp on every backend.  [ref: src/feat/]
- ``lang``      : lexicon/ARPA -> WFSTs, HMM topology, transition model,
                  phonetic decision trees, HCLG graph build. [ref: src/{fstext,hmm,tree,lm}/]
- ``gmm``       : diagonal-GMM acoustic models for the bootstrap
                  (flat-start mono -> deltas -> LDA+MLLT).  [ref: src/gmm/]
- ``models``    : nnet2-style component acoustic models (Splice, Conv2D,
                  Maxpool3D, AffinePreconditionedOnline/NG-SGD, Pnorm,
                  Normalize, Softmax) as pure-functional JAX modules.
                  [ref: src/nnet2/]
- ``decode``    : WFST beam-search decoding — host lattice decoder +
                  batched on-device Viterbi.  [ref: src/decoder/]
- ``train``     : egs pipeline, NG-SGD trainer, periodic model averaging,
                  checkpointing.  [ref: steps/nnet2/train_*.sh]
- ``parallel``  : jax.sharding Mesh / pjit data-parallel scaling in place
                  of Kaldi's shell scheduler.  [ref: utils/parallel/]
- ``core``      : config, logging, RNG, mesh helpers, and the backend
                  policy + compile cache (core/backend.py).
                  [ref: src/base/, src/cudamatrix/cu-device.cc]
- ``io``        : Kaldi-compatible ark/scp Table I/O + wave reader.
                  [ref: src/util/kaldi-table.h]
- ``recipes``   : end-to-end corpus recipes (synthetic yesno/rm/wsj-style).
                  [ref: egs/]
"""

__version__ = "0.1.0"

"""I/O: wave reading, Kaldi-compatible ark/scp Table I/O, egs datasets.

JAX replacement for Kaldi's ``src/util/`` Table I/O
(kaldi-table.h SequentialTableReader/RandomAccessTableReader/TableWriter,
kaldi-io.h extended filenames) and ``src/feat/wave-reader.{h,cc}``.
The ark/scp formats are bit-compatible with the reference so alignments,
features and models can be exchanged for differential testing
(SURVEY.md §7 'ark-interop layer').
"""

from kaldi_cnn_tpu.io.wave import read_wave, write_wave
from kaldi_cnn_tpu.io.kaldi_io import (
    read_ark, write_ark, read_scp, ArkWriter,
    read_vec_int_ark, read_mat_ark,
)
from kaldi_cnn_tpu.io.native_io import (
    RandomAccessArkReader, SequentialArkReader,
)

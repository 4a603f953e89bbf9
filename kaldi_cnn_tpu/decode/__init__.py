"""Decoding: compiled graphs, host Viterbi (align + best path),
batched on-device beam search, lattices, scoring/WER.

Re-design of src/decoder/ (FasterDecoder, LatticeFasterDecoder) and
src/bin/compute-wer.cc.  The host decoder is the correctness baseline;
the device decoders (decode/topk_decoder, and the dense
decode/tpu_decoder) batch token passing on-device (SURVEY.md §7 step 8).
"""

from kaldi_cnn_tpu.decode.graph import CompiledGraph
from kaldi_cnn_tpu.decode.decoder import viterbi_align, viterbi_decode
from kaldi_cnn_tpu.decode.score import edit_distance, wer_details
from kaldi_cnn_tpu.decode.topk_decoder import TopKGraph, TpuTopKDecoder

"""Core runtime: config, logging/metrics, RNG discipline, mesh helpers.

JAX replacement for Kaldi's ``src/base/`` (logging, kaldi-error.h)
and ``src/util/parse-options.{h,cc}`` (ParseOptions flag system).
"""

from kaldi_cnn_tpu.core.config import configclass, parse_cli, asdict_flat
from kaldi_cnn_tpu.core.logging import get_logger, MetricsWriter

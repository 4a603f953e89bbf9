"""Standard acoustic-model architectures, built from components.

Mirrors the config-generation phase of the reference training scripts
(ref: steps/nnet2/train_pnorm_simple.sh and the fork's convnet script,
SURVEY.md §3.3 phase 0): the shell scripts write an nnet.config text
spec listing SpliceComponent / Conv2DComponent / MaxpoolingComponent /
AffineComponentPreconditionedOnline / PnormComponent /
NormalizeComponent / SoftmaxComponent which nnet-am-init parses.  Here
the same architectures are plain Python builders returning an Nnet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from kaldi_cnn_tpu.core.config import configclass
from kaldi_cnn_tpu.models.components import (
    AffineComponent, Conv2DComponent, Maxpooling3DComponent,
    NormalizeComponent, PnormComponent, SoftmaxComponent)
from kaldi_cnn_tpu.models.nnet import Nnet


@configclass
class ConvnetConfig:
    """The fork's headline CNN AM over spliced fbank patches
    (ref: fork Conv2DComponent + 3-D MaxpoolingComponent per
    BASELINE.json; upstream steps/nnet2/train_convnet_accel2.sh)."""

    # input volume: (time, freq, channel) of spliced filterbank frames
    in_t: int = 11           # splice ±5 frames of fbank
    in_f: int = 36           # --num-mel-bins=36 style
    in_c: int = 3            # static + delta + delta-delta channels
    # conv layer
    filt_t: int = 4
    filt_f: int = 7
    num_filters: int = 128
    # 3-D maxpool over (time, freq, channel=filters)
    pool_t: int = 2
    pool_f: int = 3
    pool_c: int = 1
    # p-norm affine stack
    num_hidden_layers: int = 2
    pnorm_input_dim: int = 2000
    pnorm_output_dim: int = 400
    num_pdfs: int = 2000

    @property
    def input_dim(self) -> int:
        return self.in_t * self.in_f * self.in_c


def make_convnet(cfg: Optional[ConvnetConfig] = None) -> Nnet:
    cfg = cfg or ConvnetConfig()
    conv = Conv2DComponent(
        in_t=cfg.in_t, in_f=cfg.in_f, in_c=cfg.in_c,
        filt_t=cfg.filt_t, filt_f=cfg.filt_f,
        num_filters=cfg.num_filters)
    pool = Maxpooling3DComponent(
        in_t=conv.out_t, in_f=conv.out_f, in_c=cfg.num_filters,
        pool_t=cfg.pool_t, pool_f=cfg.pool_f, pool_c=cfg.pool_c)
    comps = [conv, pool]
    dim = pool.output_dim
    for _ in range(cfg.num_hidden_layers):
        comps += [
            AffineComponent(dim, cfg.pnorm_input_dim),
            PnormComponent(cfg.pnorm_input_dim, cfg.pnorm_output_dim),
            NormalizeComponent(cfg.pnorm_output_dim),
        ]
        dim = cfg.pnorm_output_dim
    comps += [
        AffineComponent(dim, cfg.num_pdfs, param_stddev=0.0),
        SoftmaxComponent(cfg.num_pdfs),
    ]
    return Nnet(comps)


def make_convnet_ivector(cfg: Optional[ConvnetConfig] = None,
                         ivector_dim: int = 16) -> Nnet:
    """CNN AM with an appended speaker iVector that bypasses the conv
    front end (the Switchboard CNN + online-iVector configuration;
    ref: egs/swbd local/online convnet scripts — the iVector rides
    every input row and joins before the affine stack)."""
    from kaldi_cnn_tpu.models.components import (
        IdentityComponent, SliceParallelComponent)
    cfg = cfg or ConvnetConfig()
    conv = Conv2DComponent(
        in_t=cfg.in_t, in_f=cfg.in_f, in_c=cfg.in_c,
        filt_t=cfg.filt_t, filt_f=cfg.filt_f,
        num_filters=cfg.num_filters)
    pool = Maxpooling3DComponent(
        in_t=conv.out_t, in_f=conv.out_f, in_c=cfg.num_filters,
        pool_t=cfg.pool_t, pool_f=cfg.pool_f, pool_c=cfg.pool_c)
    front = SliceParallelComponent(parts=(
        conv, IdentityComponent(ivector_dim)))
    mid = SliceParallelComponent(parts=(
        pool, IdentityComponent(ivector_dim)))
    comps = [front, mid]
    dim = pool.output_dim + ivector_dim
    for _ in range(cfg.num_hidden_layers):
        comps += [
            AffineComponent(dim, cfg.pnorm_input_dim),
            PnormComponent(cfg.pnorm_input_dim, cfg.pnorm_output_dim),
            NormalizeComponent(cfg.pnorm_output_dim),
        ]
        dim = cfg.pnorm_output_dim
    comps += [
        AffineComponent(dim, cfg.num_pdfs, param_stddev=0.0),
        SoftmaxComponent(cfg.num_pdfs),
    ]
    return Nnet(comps)


@configclass
class PnormDnnConfig:
    """p-norm DNN on (typically fMLLR) features
    (ref: steps/nnet2/train_pnorm_simple.sh, the RM config)."""

    input_dim: int = 360     # 40-d fMLLR spliced ±4
    num_hidden_layers: int = 3
    pnorm_input_dim: int = 1000
    pnorm_output_dim: int = 200
    num_pdfs: int = 1500


def make_pnorm_dnn(cfg: Optional[PnormDnnConfig] = None) -> Nnet:
    cfg = cfg or PnormDnnConfig()
    comps = []
    dim = cfg.input_dim
    for _ in range(cfg.num_hidden_layers):
        comps += [
            AffineComponent(dim, cfg.pnorm_input_dim),
            PnormComponent(cfg.pnorm_input_dim, cfg.pnorm_output_dim),
            NormalizeComponent(cfg.pnorm_output_dim),
        ]
        dim = cfg.pnorm_output_dim
    comps += [
        AffineComponent(dim, cfg.num_pdfs, param_stddev=0.0),
        SoftmaxComponent(cfg.num_pdfs),
    ]
    return Nnet(comps)

"""Inference scoring of the conv + 3-D maxpool front end (Nnet.predict,
plain XLA) against a float64 numpy im2col reference, under precision
"highest"."""

import jax
import numpy as np
import pytest

from kaldi_cnn_tpu.models.components import (Conv2DComponent,
                                             Maxpooling3DComponent)
from kaldi_cnn_tpu.models.nnet import Nnet


def _np_conv_maxpool(x, w, b, in_t, in_f, in_c, ft, ff, pt, pf, pc):
    n = x.shape[0]
    v = x.astype(np.float64).reshape(n, in_t, in_f, in_c)
    ot, of = in_t - ft + 1, in_f - ff + 1
    # im2col: patch (t, f) flattened in (filt_t, filt_f, in_c) order
    cols = np.stack([v[:, t:t + ft, f:f + ff, :].reshape(n, -1)
                     for t in range(ot) for f in range(of)], axis=1)
    y = cols @ w.astype(np.float64).T + b.astype(np.float64)
    nf = w.shape[0]
    y = y.reshape(n, ot // pt, pt, of // pf, pf, nf // pc, pc)
    return y.max(axis=(2, 4, 6)).reshape(n, -1)


@pytest.mark.parametrize("shape", [
    # (rows, in_t, in_f, in_c, filt_t, filt_f, filters, pool t/f/c)
    (16, 6, 12, 1, 3, 5, 16, 2, 2, 1),
    (16, 7, 10, 2, 2, 3, 12, 3, 4, 2),
    (8, 11, 36, 3, 4, 7, 128, 2, 3, 1),      # flagship width
], ids=["small", "small_pool_c", "flagship"])
def test_conv_maxpool_predict_matches_im2col(shape):
    n, in_t, in_f, in_c, ft, ff, nf, pt, pf, pc = shape
    conv = Conv2DComponent(in_t, in_f, in_c, ft, ff, nf)
    pool = Maxpooling3DComponent(conv.out_t, conv.out_f, nf, pt, pf, pc)
    net = Nnet([conv, pool])
    params = net.init(jax.random.PRNGKey(3))
    x = np.random.default_rng(5).normal(
        size=(n, conv.input_dim)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        got = np.asarray(jax.jit(net.predict)(params, x), np.float64)
    ref = _np_conv_maxpool(x, np.asarray(params[0]["w"]),
                           np.asarray(params[0]["b"]), in_t, in_f, in_c,
                           ft, ff, pt, pf, pc)
    assert got.shape == ref.shape == (n, pool.output_dim)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())

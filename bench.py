"""Headline benchmark: CNN acoustic-model training throughput on the GPU.

Measures the full nnet2-equivalent training hot loop (forward, backward,
NG-SGD preconditioning, parameter update; ref:
src/nnet2/nnet-update.cc NnetUpdater::ComputeForMinibatch) on the
flagship Conv2D+Maxpool3D+p-norm model, and reports audio-seconds of
speech processed per wall-second per chip (frames / 100 frames-per-sec).
Besides the headline it times the train step under float32 storage, the
feature, conv and conv+maxpool paths, inference scoring, and the decode
paths.

Baseline: the reference's K20-era CUDA nnet2 convnet training runs
~2-4k frames/s per GPU (exp/*/log/train.*.log frames-per-sec lines;
BASELINE.md "Train throughput" row — not published directly, so we take
3000 frames/s = 30 audio-s/s as the comparison point).

Needs a GPU (fails otherwise).  Prints the cards' name and power limit,
then ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device", "roofline"}; "device" carries the same nvidia-smi lines, since
the peaks below are the 700 W figures and a card with a lower power
limit runs slower under load.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from gpu_check import nvidia_smi_cards, require_gpu
from kaldi_cnn_tpu.core.backend import (matmul_precision_scope,
                                        setup_compile_cache)
from kaldi_cnn_tpu.models.factory import ConvnetConfig, make_convnet

BASELINE_AUDIO_SS = 30.0     # K20-era CUDA reference, see module docstring
FRAMES_PER_SECOND = 100.0    # 10 ms frame shift
MINIBATCH = 4096
# warmup must clear the NG preconditioner's warmup_updates horizon
# (64 every-step Fisher refreshes) so the timed window measures the
# steady state (eigh every 16th step)
WARMUP = 80
STEPS = 30  # at mb 4096

# Dense peaks by device_kind: NVIDIA H100 SXM data sheet (no sparsity),
# at its full 700 W power limit.  A device not listed is an error.
# float32 matmuls at the default precision run on TF32 tensor cores, so
# float32 rows are held against the TF32 peak.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "tf32_flops": 495e12,
                              "hbm_bytes": 3.35e12},
}


def _peaks(bf16: bool = True):
    kind = jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise KeyError(f"no peak figures for device kind {kind!r}")
    p = PEAKS[kind]
    return p["bf16_flops" if bf16 else "tf32_flops"], p["hbm_bytes"]


def _time_fn(fn, *args, steps: int = 20, warmup: int = 3) -> float:
    out = None
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(steps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / steps


def forward_flops(net, batch: int) -> float:
    """Matmul/conv flops of one forward pass (elementwise work and the
    NG-SGD preconditioner are not counted).  Computed from shapes: XLA's
    cost analysis does not see inside cuBLAS/cuDNN calls."""
    fl = 0.0
    for c in net.components:
        if hasattr(c, "num_patches"):
            fl += 2.0 * batch * c.num_patches * c.patch_dim * c.num_filters
        elif getattr(c, "trainable", False) and hasattr(c, "output_dim"):
            fl += 2.0 * batch * c.input_dim * c.output_dim
    return fl


def _entry(ms, flops, nbytes, peak_f, peak_b):
    """One row: measured ms, and against the peaks the flops and the
    least bytes the operation needs (both computed from shapes)."""
    e = {"ms": round(ms * 1e3, 4)}
    if flops:
        e["gflops"] = round(flops / 1e9, 3)
        e["mfu"] = round(flops / ms / peak_f, 4)
    if nbytes:
        e["min_mb"] = round(nbytes / 1e6, 2)
        e["hbm_frac"] = round(nbytes / ms / peak_b, 4)
    if "mfu" in e or "hbm_frac" in e:
        e["roofline_frac"] = max(e.get("mfu", 0.0), e.get("hbm_frac", 0.0))
    return e


def roofline() -> dict:
    """Per-path speed-of-light accounting at flagship shapes (SURVEY.md
    §7 step 10).  Every path here is float32 at the default precision:
    roofline_frac = achieved fraction of the binding resource (TF32
    tensor-core flops or memory bandwidth)."""
    from kaldi_cnn_tpu.features import functional as F
    from kaldi_cnn_tpu.models.components import (
        Conv2DComponent, Maxpooling3DComponent)

    peak_f, peak_b = _peaks(bf16=False)
    rng = np.random.default_rng(0)
    out = {}

    # ---- fbank / STFT (120 s of 16 kHz audio = 12000 frames)
    opts = F.FbankOptions()
    opts.frame_opts.dither = 0.0
    wave = jnp.asarray(rng.normal(size=16000 * 120).astype(np.float32)
                       * 1000)
    f_xla = jax.jit(lambda w: F.compute_fbank(w, opts))
    ms = _time_fn(f_xla, wave)
    frames = F.num_frames(wave.shape[0], opts.frame_opts)
    out["fbank_xla"] = _entry(
        ms, None, 4 * (wave.shape[0] + frames * opts.mel_opts.num_bins),
        peak_f, peak_b)

    # ---- conv2d and conv + 3-D maxpool at the flagship shape and
    # minibatch (inference: float32 activations)
    cfg = ConvnetConfig()
    conv = Conv2DComponent(cfg.in_t, cfg.in_f, cfg.in_c, cfg.filt_t,
                           cfg.filt_f, cfg.num_filters)
    pool = Maxpooling3DComponent(conv.out_t, conv.out_f,
                                 conv.num_filters, cfg.pool_t,
                                 cfg.pool_f, cfg.pool_c)
    p = conv.init(jax.random.PRNGKey(0))
    B = MINIBATCH
    x = jnp.asarray(rng.normal(size=(B, conv.input_dim)), jnp.float32)
    conv_flops = 2.0 * B * conv.num_patches * conv.patch_dim \
        * conv.num_filters
    c_xla = jax.jit(lambda x: conv.forward(p, x)[0])
    cp_xla = jax.jit(lambda x: pool.forward({}, conv.forward(p, x)[0])[0])
    # least bytes (float32): conv reads x and writes its output; the
    # pair reads x and writes the pooled output
    for name, fn, nbytes in (
            ("conv_xla", c_xla, 4 * B * (conv.input_dim + conv.output_dim)),
            ("conv_maxpool_xla", cp_xla,
             4 * B * (conv.input_dim + pool.output_dim))):
        out[name] = _entry(_time_fn(fn, x), conv_flops, nbytes, peak_f,
                           peak_b)
    # the unfused pair also writes and re-reads the conv output
    unfused = 4 * B * (conv.input_dim + 2 * conv.output_dim
                       + pool.output_dim)
    out["conv_maxpool_xla"]["unfused_floor_ms"] = round(
        unfused / peak_b * 1e3, 4)

    # ---- whole-model inference scoring (Nnet.predict) at mb 4096
    net = make_convnet(cfg)
    params = net.init(jax.random.PRNGKey(1))
    pred = jax.jit(net.predict)
    n_params = sum(leaf.size for leaf in jax.tree_util.tree_leaves(params))
    out["predict"] = _entry(
        _time_fn(pred, params, x), forward_flops(net, B),
        4 * (B * (net.input_dim + net.output_dim) + n_params),
        peak_f, peak_b)
    return out


def decode_bench() -> dict:
    """Batched on-device decode RTF at >=1M-arc graph scale vs the host
    decoder (ref: nnet-latgen-faster per-utterance RTF logging).  Rows:
    best-path (the align/endpointing path), raw lattice, the SHIPPED
    production path (decode_utterances: bucketed batching + on-device
    lattice emission + host word-level determinization) over
    mixed-length utterances, and streaming."""
    from kaldi_cnn_tpu.decode.biggraph import make_big_graph, \
        sample_loglikes
    from kaldi_cnn_tpu.decode.decoder import lattice_decode
    from kaldi_cnn_tpu.decode.topk_decoder import (TpuTopKDecoder,
                                                   decode_utterances)
    P = 256
    g = make_big_graph(num_words=90_000, num_pdfs=P, min_len=4,
                       max_len=8, seed=3)
    B, T = 16, 200
    lls = [sample_loglikes(g, P, T=T, seed=s) for s in range(B)]
    audio_s = B * T / FRAMES_PER_SECOND
    out = {"graph_states": g.num_states,
           "graph_arcs": int(g.num_emitting_arcs + g.num_eps_arcs)}
    # reference decode settings (steps/nnet2/decode.sh: --beam 15
    # --lattice-beam 8 --max-active 7000; SURVEY.md §3.4).
    # lattice_arcs_per_frame=None: derived from max_active
    # (_derive_lattice_arcs -> 16384 at K=7000), sized so the COLD
    # decode pays zero auto-grow re-decodes/re-compiles.
    dec = TpuTopKDecoder(g, beam=15.0, max_active=7000,
                         acoustic_scale=1.0, lattice_beam=8.0,
                         lattice_arcs_per_frame=None)
    out["lattice_arcs_per_frame"] = int(dec.A_lat)
    dec.decode_batch(lls)                      # compile
    t0 = time.perf_counter()
    dec.decode_batch(lls)
    best_s = time.perf_counter() - t0
    out["device_best_path"] = {"s": round(best_s, 3),
                               "rtf": round(best_s / audio_s, 4),
                               "audio_s": audio_s}
    # cold = first lattice decode ever on this decoder: includes jit
    # compilation and any buffer growth re-decodes (there must be none
    # at the derived default sizing)
    t0 = time.perf_counter()
    dec.decode_batch_lattice(lls, determinize=False)
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lats = dec.decode_batch_lattice(lls, determinize=False)
    lat_s = time.perf_counter() - t0
    dropped, oframes = dec.last_overflow
    out["device_lattice"] = {"s": round(lat_s, 3),
                             "rtf": round(lat_s / audio_s, 4),
                             "cold_s": round(cold_s, 3),
                             "cold_rtf": round(cold_s / audio_s, 4),
                             "overflow_arcs_dropped": int(dropped),
                             "arcs": int(sum(l.num_arcs for l in lats))}
    # the SHIPPED path: keyed mixed-length utterances through
    # decode_utterances with determinization ON (its default), so the
    # bench measures what recipes/latgen-faster actually run
    mixed = {f"utt{i:02d}": sample_loglikes(
        g, P, T=(100 if i % 2 else 200), seed=100 + i)
        for i in range(2 * B)}     # 16 per length bucket = full batches
    mixed_audio_s = sum(x.shape[0] for x in mixed.values()) \
        / FRAMES_PER_SECOND
    decode_utterances(g, mixed, acoustic_scale=1.0, beam=15.0,
                      lattice_beam=8.0, max_active=7000,
                      decoder=dec)             # compile (both buckets)
    t0 = time.perf_counter()
    shipped = decode_utterances(g, mixed, acoustic_scale=1.0,
                                beam=15.0, lattice_beam=8.0,
                                max_active=7000, decoder=dec)
    ship_s = time.perf_counter() - t0
    out["device_lattice_determinized"] = {
        "s": round(ship_s, 3),
        "rtf": round(ship_s / mixed_audio_s, 4),
        "audio_s": mixed_audio_s,
        "utts": len(shipped)}
    # streaming decode: a 64 s stream fed in 320 ms chunks through
    # TpuStreamingDecoder at the same reference settings (ref: the
    # online2 pipeline's per-utterance RTF logging, SURVEY.md §3.5);
    # scan-block jits dispatch once per chunk, the committed-prefix
    # machinery bounds the host window
    from kaldi_cnn_tpu.decode.topk_decoder import TpuStreamingDecoder
    sdec = TpuStreamingDecoder(dec, commit_every=24)
    prime = sample_loglikes(g, P, T=48, seed=9)
    sdec.advance(prime[:33])       # compiles the 32-frame scan block
    sdec.advance(prime[33:42])     # the 8-block
    sdec.advance(prime[42:44])     # the 1-block
    sdec.finalize()
    sdec.reset()
    T_s = 6400
    ll_s = sample_loglikes(g, P, T=T_s, seed=11)
    max_window = 0
    t0 = time.perf_counter()
    for i in range(0, T_s, 32):
        sdec.advance(ll_s[i:i + 32])
        max_window = max(max_window, len(sdec._buf))
    sdec.finalize()
    _, words_s, _ = sdec.best_path()
    stream_s = time.perf_counter() - t0
    import resource
    rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    out["device_streaming"] = {
        "s": round(stream_s, 3), "audio_s": T_s / FRAMES_PER_SECOND,
        "rtf": round(stream_s / (T_s / FRAMES_PER_SECOND), 4),
        "max_window_levels": int(max_window),
        "words": int(len(words_s)),
        "host_rss_mb": round(rss_mb, 0)}

    # host decoder (serial python) on 3 utterances — a sample of the
    # 16-utt batch the device rows decode
    n_host = 3
    t0 = time.perf_counter()
    for i in range(n_host):
        lattice_decode(g, lls[i], acoustic_scale=1.0, beam=15.0,
                       lattice_beam=8.0, max_active=7000)
    host_s = time.perf_counter() - t0
    host_rtf = host_s / (n_host * T / FRAMES_PER_SECOND)
    out["host_lattice"] = {
        "s": round(host_s, 3), "utts": n_host,
        "rtf": round(host_rtf, 4),
        "sampled_from_batch": True}
    out["device_vs_host_speedup"] = round(host_rtf / (lat_s / audio_s), 2)
    return out


def _train_step_ms(net, params, opt, x, labels, lr, precision=None):
    """Steady-state step time; the step is traced under ``precision``
    (None = the backend policy's train-step precision)."""
    with matmul_precision_scope(precision):
        for _ in range(WARMUP):
            params, opt, objf = net.train_step(params, opt, x, labels, lr)
        jax.block_until_ready((params, opt, objf))
        t0 = time.perf_counter()
        for _ in range(STEPS):
            params, opt, objf = net.train_step(params, opt, x, labels, lr)
        jax.block_until_ready((params, opt, objf))
    return (time.perf_counter() - t0) / STEPS


def main() -> None:
    setup_compile_cache()
    device = require_gpu()
    device["nvidia_smi"] = nvidia_smi_cards()
    for line in device["nvidia_smi"]:
        print(line, flush=True)
    net = make_convnet(ConvnetConfig())
    params = net.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(MINIBATCH, net.input_dim)),
                    jnp.float32)
    labels = jnp.asarray(rng.integers(0, net.output_dim, MINIBATCH),
                         jnp.int32)
    lr = 0.01
    # the trainer's program: backend-policy storage and precision
    step_s = _train_step_ms(net, params, net.init_opt(), x, labels, lr)
    audio_ss = MINIBATCH / step_s / FRAMES_PER_SECOND

    # train-step MFU: forward + input-grad + weight-grad matmul flops
    # (3x forward) over the measured time
    step_flops = 3 * forward_flops(net, MINIBATCH)
    peak_f, peak_b = _peaks()
    rl = {"train_step": _entry(step_s, step_flops, None, peak_f, peak_b)}
    rl["train_step"]["audio_s_per_s"] = round(audio_ss, 2)
    # the same step with float32 storage and default precision (TF32
    # tensor cores), against the TF32 peak
    net32 = make_convnet(ConvnetConfig())
    net32.train_storage_dtype = "float32"
    s32 = _train_step_ms(net32, params, net32.init_opt(), x, labels, lr,
                         precision="default")
    rl["train_step_f32_storage"] = _entry(s32, step_flops, None,
                                          *_peaks(bf16=False))
    rl["train_step_f32_storage"]["audio_s_per_s"] = round(
        MINIBATCH / s32 / FRAMES_PER_SECOND, 2)
    rl.update(roofline())
    rl["decode"] = decode_bench()
    rl["peak_bytes_in_use"] = int(
        jax.devices()[0].memory_stats()["peak_bytes_in_use"])

    print(json.dumps({
        "metric": "train_audio_seconds_per_sec_per_chip",
        "value": round(audio_ss, 2),
        "unit": "audio-s/s/chip",
        "vs_baseline": round(audio_ss / BASELINE_AUDIO_SS, 3),
        "device": device,
        "roofline": rl,
    }))


if __name__ == "__main__":
    main()

"""Smoke test of the main path on the GPU, at the flagship model's width.

    python chip_smoke.py                # one card: phases device..recipe
    python chip_smoke.py --four-cards   # four cards: the multi-card phases

One JAX process runs every phase through the library's normal entry
points; the only other process is the ``nvidia-smi`` query.  Each phase
prints one JSON line with its seconds and its comparison results:
``cold_s`` (first run, compilation included), ``compile_s`` (XLA
compilation inside the phase, from jax.monitoring; set-up time, not
work) and ``run_s`` (cold_s minus compile_s).  A failed phase raises,
so the script exits non-zero and never prints the final line, which is
exactly
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

Without a GPU the device phase fails: nothing runs on the CPU instead.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from gpu_check import nvidia_smi_cards, require_gpu
from kaldi_cnn_tpu.core.backend import (matmul_precision_scope,
                                        setup_compile_cache)

COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"
# Limits on one-step update comparisons (_update_diffs), set from
# readings on an H100 and on 4 virtual CPU devices (PERF.md, Findings).
# NG-SGD's per-component norm rescale amplifies rounding: the bf16
# policy moves the output layer's bias update by up to 0.18 of its
# largest entry, and one float32 program vs another (CPU backend, dp+tp
# sharding) moves the first affine layer's update by up to 0.09; the
# update limits are about twice that.  What the one factor does not
# explain ("direction") read at most 3.6e-4 for dp+tp; the preconditioned
# delta is itself a difference of near-equal terms, so its limit keeps
# a wider margin.
POLICY_UPDATE_TOL = 0.35
F32_UPDATE_TOL = 0.2
F32_DIRECTION_TOL = 5e-3
_compile_s = [0.0]


def _on_duration(event: str, duration: float, **_) -> None:
    if event == COMPILE_EVENT:
        _compile_s[0] += duration


def emit(rec: Dict) -> None:
    print(json.dumps(rec), flush=True)


def run_phase(name: str, fn, *args, **kwargs):
    """Run one phase; print its line; return its carried state."""
    c0, t0 = _compile_s[0], time.perf_counter()
    report, state = fn(*args, **kwargs)
    cold = time.perf_counter() - t0
    comp = _compile_s[0] - c0
    emit({"phase": name, "cold_s": cold, "compile_s": comp,
          "run_s": cold - comp, **report})
    return state


def _cpu():
    return jax.devices("cpu")[0]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _peak_bytes() -> Optional[int]:
    stats = jax.devices()[0].memory_stats()
    return None if stats is None else int(stats.get("peak_bytes_in_use", 0))


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------

def phase_device(count: int = 1):
    dev = require_gpu(count)
    cards = nvidia_smi_cards()
    for line in cards:
        print(line, flush=True)
    return {**dev, "nvidia_smi": cards}, dev


def speech_like_audio(seconds: float, seed: int = 0,
                      rate: int = 16000) -> np.ndarray:
    """Seeded int16-scale audio: gliding harmonics over broadband noise
    (no spectral hole, so log-mel values are well conditioned)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    f0 = 120.0 + 40.0 * np.sin(2 * np.pi * 0.3 * t)
    phase = 2 * np.pi * np.cumsum(f0) / rate
    wave = sum(np.sin(k * phase) / k for k in range(1, 12)) * 3000.0
    wave += rng.normal(0.0, 300.0, size=t.shape)
    return wave.astype(np.float32)


def phase_features(seconds: float = 120.0, num_bins: int = 36,
                   seed: int = 0):
    """fbank + deltas as recipes/wsj.py extracts them, on the default
    device vs the CPU backend.  Tolerance 1e-2 absolute: cuFFT and the
    CPU FFT sum in a different order."""
    from kaldi_cnn_tpu.features import functional as F
    from kaldi_cnn_tpu.features.extractor import FeatureExtractor
    from kaldi_cnn_tpu.core.rng import stage_key
    opts = F.FbankOptions()
    opts.frame_opts.dither = 1.0
    opts.mel_opts.num_bins = num_bins
    wave = speech_like_audio(seconds, seed)
    key = stage_key(seed, "fbank_dither")
    ex = FeatureExtractor("fbank", opts, bucket_seconds=1.0,
                          deltas_order=2)
    t0 = time.perf_counter()
    got = ex(wave, key)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = ex(wave, key)
    warm = time.perf_counter() - t0
    ref = FeatureExtractor("fbank", opts, bucket_seconds=1.0,
                           device="cpu", deltas_order=2)(wave, key)
    assert got.shape == ref.shape == (F.num_frames(len(wave),
                                                   opts.frame_opts),
                                      3 * num_bins), (got.shape, ref.shape)
    assert np.isfinite(got).all()
    err = float(np.max(np.abs(got - ref)))
    assert err <= 1e-2, f"fbank device vs CPU: max abs diff {err}"
    return {"frames": int(got.shape[0]), "extract_cold_s": cold,
            "extract_warm_s": warm, "max_abs_diff_vs_cpu": err}, None


def _labelled_batch(net, n: int, seed: int,
                    classes: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded inputs with labels that are a fixed function of the input
    (argmax of a random projection onto the first ``classes`` pdfs), so
    there is something to learn within a few steps."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, net.input_dim)).astype(np.float32)
    proj = np.random.default_rng(12345).normal(
        size=(net.input_dim, min(classes, net.output_dim))
    ).astype(np.float32)
    y = np.argmax(x @ proj, axis=1).astype(np.int32)
    return x, y


def _update_diffs(p0, pa, pb) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Per parameter leaf ("<component>.<w|b>"), how far the update
    ``ua = pa - p0`` is from ``ub = pb - p0``, over ``max|ub|``: as is
    ("update"), and after scaling ``ub`` by the component's
    least-squares factor ("direction").  NG-SGD multiplies each
    component's update by one norm-preserving factor that amplifies
    rounding (PERF.md, Findings); "direction" sees every other
    difference.  Neither counts the part of the gap that rounding
    ``p0 + update`` to float32 explains (half a spacing of the new
    value on each side): an update smaller than a weight's spacing is
    not stored at all."""
    upd, dirn = {}, {}
    for i, (l0, la, lb) in enumerate(zip(p0, pa, pb)):
        leaves = {}
        for k in sorted(l0):
            a = np.asarray(la[k], np.float32)
            b = np.asarray(lb[k], np.float32)
            w0 = np.asarray(l0[k], np.float64)
            leaves[k] = (a - w0, b - w0,
                         np.spacing(np.maximum(np.abs(a), np.abs(b))))
        num = sum(np.vdot(ua, ub) for ua, ub, _ in leaves.values())
        den = sum(np.vdot(ub, ub) for _, ub, _ in leaves.values())
        s = float(num / den) if den > 0 else 1.0
        for k, (ua, ub, spacing) in leaves.items():
            scale = max(np.abs(ub).max(), 1e-30)
            for out, gap, slack in ((upd, ua - ub, spacing),
                                    (dirn, ua - s * ub,
                                     0.5 * (1.0 + abs(s)) * spacing)):
                excess = np.maximum(np.abs(gap) - slack, 0.0)
                out[f"{i}.{k}"] = float(excess.max() / scale)
    return upd, dirn


def phase_train(cfg=None, minibatch: int = 4096, groups: int = 4,
                scan_steps: int = 8, seed: int = 0):
    """train_nnet at the given width for ``groups`` scan groups (one
    epoch each), then one train_step from the trained state under the
    backend policy vs the float32 reference (f32 storage, precision
    "highest"), with the reference run again and on the CPU backend as
    rounding controls."""
    from kaldi_cnn_tpu.core.logging import MetricsWriter
    from kaldi_cnn_tpu.models.factory import ConvnetConfig, make_convnet
    from kaldi_cnn_tpu.train.egs import Egs
    from kaldi_cnn_tpu.train.trainer import TrainConfig, train_nnet
    cfg = cfg or ConvnetConfig()
    net = make_convnet(cfg)
    n = minibatch * scan_steps
    x, y = _labelled_batch(net, n, seed)
    egs = Egs(x, y, np.ones(n, np.float32))
    xv, yv = _labelled_batch(net, minibatch, seed + 1)
    egs_valid = Egs(xv, yv, np.ones(minibatch, np.float32))
    log = io.StringIO()
    tcfg = TrainConfig(num_epochs=groups, minibatch_size=minibatch,
                       valid_minibatches=1, scan_steps=scan_steps,
                       seed=seed)
    t0 = time.perf_counter()
    params, opt = train_nnet(net, egs, egs_valid, tcfg,
                             metrics=MetricsWriter(stream=log))
    params = jax.block_until_ready(params)
    train_s = time.perf_counter() - t0
    objfs = [json.loads(ln)["train_logprob"]
             for ln in log.getvalue().splitlines()]
    assert len(objfs) == groups and np.isfinite(objfs).all(), objfs
    assert objfs[-1] > objfs[0], f"objf did not rise: {objfs}"

    # one step from identical params, opt state and batch
    xb, yb = jnp.asarray(x[:minibatch]), jnp.asarray(y[:minibatch])
    lr = tcfg.final_learning_rate
    with matmul_precision_scope():
        p_pol, _, o_pol = net.train_step(params, opt, xb, yb, lr)
    ref = make_convnet(cfg)
    ref.train_storage_dtype = "float32"
    with jax.default_matmul_precision("highest"):
        p_ref, _, o_ref = ref.train_step(params, opt, xb, yb, lr)
        p_rep, _, _ = ref.train_step(params, opt, xb, yb, lr)
        on_cpu = jax.device_put((params, opt, xb, yb), _cpu())
        p_cpu, _, _ = ref.train_step(*on_cpu, lr)
    o_pol, o_ref = float(o_pol), float(o_ref)
    objf_rel = abs(o_pol - o_ref) / abs(o_ref)
    assert objf_rel <= 1e-2, (o_pol, o_ref)
    d_pol, dir_pol = _update_diffs(params, p_pol, p_ref)
    d_rep = max(_update_diffs(params, p_rep, p_ref)[0].values())
    d_cpu, dir_cpu = _update_diffs(params, p_cpu, p_ref)
    assert d_rep <= F32_UPDATE_TOL, f"float32 step rerun: {d_rep}"
    assert max(d_cpu.values()) <= F32_UPDATE_TOL, f"float32 CPU: {d_cpu}"
    assert max(d_pol.values()) <= POLICY_UPDATE_TOL, f"policy: {d_pol}"
    return {"minibatch": minibatch, "steps": groups * scan_steps,
            "train_nnet_s": train_s, "objf_per_group": objfs,
            "step_objf_policy": o_pol, "step_objf_f32_highest": o_ref,
            "step_objf_rel_diff": objf_rel,
            "step_update_rel_diff_policy": d_pol,
            "step_direction_rel_diff_policy": dir_pol,
            "step_update_rel_diff_f32_rerun": d_rep,
            "step_update_rel_diff_f32_cpu": d_cpu,
            "step_direction_rel_diff_f32_cpu": dir_cpu,
            "peak_bytes_in_use": _peak_bytes()}, (net, params)


def phase_score(net, params, frames: int = 3 * 4096, utt_frames: int = 1024,
                cpu_frames: int = 256, seed: int = 2):
    """AmNnet.loglikes_batch on the default device vs the same call
    under precision "highest" (a float32 product may run in TF32
    otherwise), and that result vs the CPU backend."""
    from kaldi_cnn_tpu.models.nnet import AmNnet
    rng = np.random.default_rng(seed)
    feats = {f"utt{i:03d}": rng.normal(size=(utt_frames, net.input_dim)
                                       ).astype(np.float32)
             for i in range(-(-frames // utt_frames))}
    am = AmNnet(net)
    ll = am.loglikes_batch(params, feats)
    with jax.default_matmul_precision("highest"):
        ll_hi = AmNnet(net).loglikes_batch(params, feats)
    a = np.concatenate([ll[u] for u in sorted(feats)])
    b = np.concatenate([ll_hi[u] for u in sorted(feats)])
    assert a.shape == (len(feats) * utt_frames, net.output_dim)
    assert np.isfinite(a).all() and np.isfinite(b).all()
    ll_err = float(np.max(np.abs(a - b)))
    agree = float(np.mean(np.argmax(a, 1) == np.argmax(b, 1)))
    assert ll_err <= 5e-2, f"loglikes default vs highest: {ll_err}"
    assert agree >= 0.99, f"argmax agreement {agree}"
    first = sorted(feats)[0]
    with jax.default_device(_cpu()):
        p_cpu = jax.device_put(params, _cpu())
        ll_cpu = AmNnet(net).loglikes_batch(
            p_cpu, {first: feats[first][:cpu_frames]},
            batch_size=cpu_frames)[first]
    cpu_rel = _rel(ll_hi[first][:cpu_frames], ll_cpu)
    assert cpu_rel <= 1e-4, f"highest vs CPU: rel {cpu_rel}"
    return {"frames": int(a.shape[0]), "max_abs_diff_vs_highest": ll_err,
            "argmax_agreement": agree, "rel_diff_highest_vs_cpu": cpu_rel},\
        None


def phase_decode(num_words: int = 90_000, num_pdfs: int = 256,
                 batch: int = 16, frames: int = 200,
                 stream_frames: int = 2000, chunk: int = 32,
                 beam: float = 15.0, lattice_beam: float = 8.0,
                 max_active: int = 7000, host_check: int = 2,
                 graph_seed: int = 3):
    """Best-path, lattice (decode_utterances, determinized) and
    streaming decode on the big graph; best paths vs the host lattice
    decoder, streaming words vs offline words."""
    from kaldi_cnn_tpu.decode.biggraph import make_big_graph, \
        sample_loglikes
    from kaldi_cnn_tpu.decode.decoder import lattice_decode
    from kaldi_cnn_tpu.decode.lattice import shortest_path
    from kaldi_cnn_tpu.decode.topk_decoder import (
        TpuStreamingDecoder, TpuTopKDecoder, decode_utterances)
    P = num_pdfs
    g = make_big_graph(num_words=num_words, num_pdfs=P, min_len=4,
                       max_len=8, seed=graph_seed)
    lls = [sample_loglikes(g, P, T=frames, seed=s) for s in range(batch)]
    dec = TpuTopKDecoder(g, beam=beam, max_active=max_active,
                         acoustic_scale=1.0, lattice_beam=lattice_beam,
                         lattice_arcs_per_frame=None)
    out = {"graph_states": int(g.num_states),
           "graph_arcs": int(g.num_emitting_arcs + g.num_eps_arcs)}
    audio_s = batch * frames / 100.0

    t0 = time.perf_counter()
    best = dec.decode_batch(lls)
    out["best_path_cold_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    best = dec.decode_batch(lls)
    out["best_path_rtf"] = (time.perf_counter() - t0) / audio_s
    for i in range(host_check):
        lat_h = lattice_decode(g, lls[i], acoustic_scale=1.0, beam=beam,
                               lattice_beam=lattice_beam,
                               max_active=max_active)
        _, w_h, c_h = shortest_path(lat_h, acoustic_scale=1.0)
        _, w, c = best[i]
        assert list(w) == list(w_h), f"utt {i}: words differ from host"
        assert abs(c - c_h) <= 1e-4 * abs(c_h), (i, c, c_h)
    out["host_checked_utts"] = host_check

    # lattice: mixed 100/200-frame utterances, one decode_utterances
    # call per length bucket so each call's overflow count is read
    half = max(frames // 2, 1)
    mixed = {f"utt{i:02d}": sample_loglikes(
        g, P, T=(half if i % 2 else frames), seed=100 + i)
        for i in range(2 * batch)}
    by_len: Dict[int, Dict[str, np.ndarray]] = {}
    for u, ll in mixed.items():
        by_len.setdefault(ll.shape[0], {})[u] = ll
    mixed_audio_s = sum(x.shape[0] for x in mixed.values()) / 100.0
    overflow = 0
    lats = {}
    t0 = time.perf_counter()
    for T in sorted(by_len):
        lats.update(decode_utterances(
            g, by_len[T], acoustic_scale=1.0, beam=beam,
            lattice_beam=lattice_beam, max_active=max_active,
            batch_size=batch, bucket_frames=T, decoder=dec))
        overflow += int(dec.last_overflow[0])
    out["lattice_cold_s"] = time.perf_counter() - t0
    assert set(lats) == set(mixed)
    assert all(lat.num_arcs > 0 for lat in lats.values())
    assert overflow == 0, f"{overflow} lattice arcs dropped"
    t0 = time.perf_counter()
    for T in sorted(by_len):
        decode_utterances(
            g, by_len[T], acoustic_scale=1.0, beam=beam,
            lattice_beam=lattice_beam, max_active=max_active,
            batch_size=batch, bucket_frames=T, decoder=dec)
        overflow += int(dec.last_overflow[0])
    out["lattice_rtf"] = (time.perf_counter() - t0) / mixed_audio_s
    assert overflow == 0, f"{overflow} lattice arcs dropped"
    out["overflow_arcs"] = overflow

    # streaming: chunks through TpuStreamingDecoder vs offline best path
    ll_s = sample_loglikes(g, P, T=stream_frames, seed=11)
    sdec = TpuStreamingDecoder(dec)
    t0 = time.perf_counter()
    for i in range(0, stream_frames, chunk):
        sdec.advance(ll_s[i:i + chunk])
    sdec.finalize()
    _, words_s, _ = sdec.best_path()
    out["stream_cold_rtf"] = (time.perf_counter() - t0) / (
        stream_frames / 100.0)
    (_, words_off, _), = dec.decode_batch([ll_s])
    assert list(words_s) == list(words_off), "streaming != offline words"
    out["stream_words"] = int(len(words_s))
    return out, None


def phase_recipe():
    from kaldi_cnn_tpu.recipes import yesno
    res = yesno.run()
    assert res["wer"] == 0.0, f"yesno WER {res['wer']}"
    return {"wer": res["wer"], "words": res["words"]}, None


# ---------------------------------------------------------------------------
# four-card phases
# ---------------------------------------------------------------------------

def _devices_of(tree) -> set:
    out = set()
    for leaf in jax.tree_util.tree_leaves(tree):
        out |= set(leaf.sharding.device_set)
    return out


def phase_dp_tp(devices, cfg=None, minibatch: int = 4096,
                warm_steps: int = 4, seed: int = 0):
    """make_dp_tp_step on a (data=2, model=2) mesh vs the one-device
    train_step on the same batch and state, both float32 (f32 storage,
    precision "highest") so that only the sharding differs.  A few
    one-device steps first give every layer a non-zero gradient (the
    output layer starts at zero).  Limits: objf 1e-2 relative; each
    leaf's update F32_UPDATE_TOL (_update_diffs)."""
    from kaldi_cnn_tpu.core.mesh import make_mesh
    from kaldi_cnn_tpu.models.factory import ConvnetConfig, make_convnet
    from kaldi_cnn_tpu.parallel.dp import make_dp_tp_step
    net = make_convnet(cfg or ConvnetConfig())
    net.train_storage_dtype = "float32"
    mesh = make_mesh(data=2, model=2, devices=devices)
    params, opt = net.init(jax.random.PRNGKey(seed)), net.init_opt()
    xw, yw = _labelled_batch(net, minibatch * warm_steps, seed + 1)
    x, y = _labelled_batch(net, minibatch, seed)
    lr = 0.02
    with jax.default_matmul_precision("highest"):
        for s in range(0, len(xw), minibatch):
            params, opt, _ = net.train_step(
                params, opt, jnp.asarray(xw[s:s + minibatch]),
                jnp.asarray(yw[s:s + minibatch]), lr)
        p_tp, _, o_tp = make_dp_tp_step(net, mesh)(params, opt, x, y, lr)
        p_1, _, o_1 = net.train_step(params, opt, jnp.asarray(x),
                                     jnp.asarray(y), lr)
    assert _devices_of(p_tp) == set(devices), "params not spread"
    o_tp, o_1 = float(o_tp), float(o_1)
    objf_rel = abs(o_tp - o_1) / abs(o_1)
    assert objf_rel <= 1e-2, (o_tp, o_1)
    d, dirn = _update_diffs(params, p_tp, p_1)
    assert max(d.values()) <= F32_UPDATE_TOL, f"dp+tp updates: {d}"
    assert max(dirn.values()) <= F32_DIRECTION_TOL, f"dp+tp: {dirn}"
    return {"mesh": dict(mesh.shape), "objf_tp": o_tp, "objf_1": o_1,
            "objf_rel_diff": objf_rel, "update_rel_diff": d,
            "direction_rel_diff": dirn}, None


def phase_replicas(devices, cfg=None, minibatch: int = 4096,
                   steps_per_epoch: int = 8, epochs: int = 2,
                   seed: int = 0):
    """train_multihost with 2 replicas x 2 data devices, averaging every
    2 steps, vs the same loop on one device.  After the final average
    the replicas must hold identical finite parameters, and the last
    epoch's train objf must lie within 0.1 nats/frame of the one-device
    run's."""
    from jax.sharding import Mesh
    from kaldi_cnn_tpu.core.logging import MetricsWriter
    from kaldi_cnn_tpu.models.factory import ConvnetConfig, make_convnet
    from kaldi_cnn_tpu.parallel.multihost import (MultihostConfig,
                                                  train_multihost)
    from kaldi_cnn_tpu.train.egs import Egs
    from kaldi_cnn_tpu.train.trainer import TrainConfig
    cfg = cfg or ConvnetConfig()
    net = make_convnet(cfg)
    n = minibatch * steps_per_epoch
    x, y = _labelled_batch(net, n, seed)
    egs = Egs(x, y, np.ones(n, np.float32))
    tcfg = TrainConfig(num_epochs=epochs, minibatch_size=minibatch,
                       seed=seed)

    def run(mesh, mh, **kw):
        log = io.StringIO()
        params, _ = train_multihost(net, egs, egs, tcfg, mh, mesh=mesh,
                                    metrics=MetricsWriter(stream=log),
                                    **kw)
        objfs = [json.loads(ln)["train_logprob"]
                 for ln in log.getvalue().splitlines()]
        return params, objfs

    mesh_r = Mesh(np.array(devices).reshape(2, -1), ("replica", "data"))
    params_r, objf_r = run(mesh_r, MultihostConfig(average_every=2,
                                                   num_replicas=2),
                           return_replicas=True)
    assert len(_devices_of(params_r)) == len(devices), "params not spread"
    leaves = [np.asarray(leaf) for leaf in
              jax.tree_util.tree_leaves(params_r)]
    assert all(np.isfinite(leaf).all() for leaf in leaves)
    assert all(np.array_equal(leaf[0], leaf[1]) for leaf in leaves), \
        "replicas differ after averaging"
    _, objf_1 = run(Mesh(np.array(devices[:1]), ("data",)),
                    MultihostConfig())
    gap = abs(objf_r[-1] - objf_1[-1])
    assert gap <= 0.1, f"replica objf {objf_r} vs one device {objf_1}"
    return {"objf_replicas": objf_r, "objf_one_device": objf_1,
            "final_objf_gap": gap}, None


def phase_sharded_decode(devices, num_words: int = 90_000,
                         num_pdfs: int = 256, batch: int = 16,
                         frames: int = 200, max_active: int = 7000):
    """TpuTopKDecoder over a 4-device ``data`` mesh vs one device: the
    same words and costs for every utterance."""
    from jax.sharding import Mesh
    from kaldi_cnn_tpu.decode.biggraph import make_big_graph, \
        sample_loglikes
    from kaldi_cnn_tpu.decode.topk_decoder import TpuTopKDecoder
    g = make_big_graph(num_words=num_words, num_pdfs=num_pdfs, min_len=4,
                       max_len=8, seed=3)
    lls = [sample_loglikes(g, num_pdfs, T=frames, seed=s)
           for s in range(batch)]
    mesh = Mesh(np.array(devices), ("data",))
    kw = dict(beam=15.0, max_active=max_active, acoustic_scale=1.0)
    sharded = TpuTopKDecoder(g, mesh=mesh, **kw)
    r, _, _ = sharded._run(lls, a_lat=0, to_host=False)
    assert set(r["fs"].sharding.device_set) == set(devices), \
        "decode state not spread over the mesh"
    res_m = sharded.decode_batch(lls)
    res_1 = TpuTopKDecoder(g, **kw).decode_batch(lls)
    for i, ((_, wm, cm), (_, w1, c1)) in enumerate(zip(res_m, res_1)):
        assert list(wm) == list(w1), f"utt {i}: sharded words differ"
        assert abs(cm - c1) <= 1e-4 * abs(c1), (i, cm, c1)
    return {"mesh": dict(mesh.shape), "utts": batch}, None


# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phases")
    args = ap.parse_args(argv)
    setup_compile_cache()
    # the CPU backend is the reference for two comparisons
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        jax.config.update("jax_platforms", plats + ",cpu")
    jax.monitoring.register_event_duration_secs_listener(_on_duration)

    count = 4 if args.four_cards else 1
    dev = run_phase("device", phase_device, count)
    if args.four_cards:
        devices = jax.devices()[:4]
        run_phase("dp_tp_train_step", phase_dp_tp, devices)
        run_phase("replica_training", phase_replicas, devices)
        run_phase("sharded_decode", phase_sharded_decode, devices)
        dev = {**dev, "count": len(devices)}
    else:
        run_phase("features", phase_features)
        net, params = run_phase("train", phase_train)
        run_phase("score", phase_score, net, params)
        run_phase("decode", phase_decode)
        run_phase("recipe", phase_recipe)
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

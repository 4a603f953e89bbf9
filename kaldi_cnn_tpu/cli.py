"""The command-line multitool: the reference's ~200 thin binaries as
verbs of one entry point (SURVEY.md §2 disposition for src/*bin/).

    python -m kaldi_cnn_tpu.cli <verb> [--flag=value ...] args...

Verbs mirror the load-bearing reference binaries (same names, same
ark/scp piping model via the io layer):

  compute-mfcc-feats   featbin/compute-mfcc-feats.cc
  compute-fbank-feats  featbin/compute-fbank-feats.cc
  apply-cmvn           featbin/apply-cmvn.cc (global per-ark here)
  add-deltas           featbin/add-deltas.cc
  splice-feats         featbin/splice-feats.cc
  copy-feats           featbin/copy-feats.cc
  compute-wer          bin/compute-wer.cc
  run-recipe           egs/<corpus>/run.sh equivalents
  bench                the bench.py harness verbs

Every verb self-documents with --help (ref: ParseOptions usage
strings).
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List

import numpy as np


def _feat_opts(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--sample-frequency", type=float, default=16000.0)
    parser.add_argument("--frame-length", type=float, default=25.0)
    parser.add_argument("--frame-shift", type=float, default=10.0)
    parser.add_argument("--num-mel-bins", type=int, default=23)
    parser.add_argument("--dither", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=0)


def _make_opts(args, kind: str):
    from kaldi_cnn_tpu.features import functional as F
    opts = F.MfccOptions() if kind == "mfcc" else F.FbankOptions()
    opts.frame_opts.samp_freq = args.sample_frequency
    opts.frame_opts.frame_length_ms = args.frame_length
    opts.frame_opts.frame_shift_ms = args.frame_shift
    opts.frame_opts.dither = args.dither
    opts.mel_opts.num_bins = args.num_mel_bins
    return opts


def cmd_compute_feats(argv: List[str], kind: str) -> int:
    import jax
    from kaldi_cnn_tpu.features import functional as F
    from kaldi_cnn_tpu.io.kaldi_io import ArkWriter
    from kaldi_cnn_tpu.io.wave import read_wave
    p = argparse.ArgumentParser(prog=f"compute-{kind}-feats")
    _feat_opts(p)
    p.add_argument("wav_scp", help="scp file: <utt> <wav path>")
    p.add_argument("out_ark")
    p.add_argument("--out-scp", default=None)
    args = p.parse_args(argv)
    opts = _make_opts(args, kind)
    fn = F.compute_mfcc if kind == "mfcc" else F.compute_fbank
    n = 0
    with ArkWriter(args.out_ark, args.out_scp) as w:
        for line in open(args.wav_scp):
            utt, path = line.split(None, 1)
            wave, rate = read_wave(path.strip())
            if wave.ndim == 2:
                wave = wave[0]   # channel 0 (ref: --channel default)
            opts.frame_opts.samp_freq = rate
            key = jax.random.PRNGKey(args.seed + n) \
                if args.dither > 0 else None
            w.write(utt, np.asarray(fn(wave, opts, key), np.float32))
            n += 1
    print(f"computed {kind} features for {n} utterances",
          file=sys.stderr)
    return 0


def cmd_compute_pitch(argv: List[str]) -> int:
    """(ref: featbin/compute-kaldi-pitch-feats.cc — NCCF + Viterbi
    lag track, two columns (nccf, pitch_hz) per frame.)"""
    from kaldi_cnn_tpu.features.pitch import PitchOptions, raw_pitch
    from kaldi_cnn_tpu.io.kaldi_io import ArkWriter
    from kaldi_cnn_tpu.io.wave import read_wave
    p = argparse.ArgumentParser(prog="compute-kaldi-pitch-feats")
    p.add_argument("--sample-frequency", type=float, default=16000.0)
    p.add_argument("--frame-length", type=float, default=25.0)
    p.add_argument("--frame-shift", type=float, default=10.0)
    p.add_argument("--min-f0", type=float, default=50.0)
    p.add_argument("--max-f0", type=float, default=400.0)
    p.add_argument("--penalty-factor", type=float, default=0.1)
    p.add_argument("wav_scp")
    p.add_argument("out_ark")
    p.add_argument("--out-scp", default=None)
    args = p.parse_args(argv)
    n = 0
    with ArkWriter(args.out_ark, args.out_scp) as w:
        for line in open(args.wav_scp):
            utt, path = line.split(None, 1)
            wave, rate = read_wave(path.strip())
            if wave.ndim == 2:
                wave = wave[0]
            opts = PitchOptions(
                samp_freq=rate, frame_length_ms=args.frame_length,
                frame_shift_ms=args.frame_shift, min_f0=args.min_f0,
                max_f0=args.max_f0, penalty_factor=args.penalty_factor)
            w.write(utt, raw_pitch(wave, opts))
            n += 1
    print(f"computed pitch for {n} utterances", file=sys.stderr)
    return 0


def cmd_process_pitch(argv: List[str]) -> int:
    """(ref: featbin/process-kaldi-pitch-feats.cc — raw (nccf, pitch)
    -> 3-column (pov_feature, normalized_log_pitch, delta_pitch).)"""
    from kaldi_cnn_tpu.features.pitch import PitchOptions, process_pitch
    from kaldi_cnn_tpu.io.kaldi_io import ArkWriter, read_mat_ark
    p = argparse.ArgumentParser(prog="process-kaldi-pitch-feats")
    p.add_argument("--normalization-left-context", type=int, default=75)
    p.add_argument("--normalization-right-context", type=int, default=75)
    p.add_argument("--delta-pitch-scale", type=float, default=10.0)
    p.add_argument("in_ark")
    p.add_argument("out_ark")
    p.add_argument("--out-scp", default=None)
    args = p.parse_args(argv)
    opts = PitchOptions(
        normalization_left_context=args.normalization_left_context,
        normalization_right_context=args.normalization_right_context,
        delta_pitch_scale=args.delta_pitch_scale)
    n = 0
    with ArkWriter(args.out_ark, args.out_scp) as w:
        for utt, mat in read_mat_ark(args.in_ark):
            w.write(utt, process_pitch(mat, opts))
            n += 1
    print(f"processed pitch for {n} utterances", file=sys.stderr)
    return 0


def cmd_transform(argv: List[str], verb: str) -> int:
    from kaldi_cnn_tpu.features import functional as F
    from kaldi_cnn_tpu.io.kaldi_io import ArkWriter, read_mat_ark
    p = argparse.ArgumentParser(prog=verb)
    p.add_argument("in_ark")
    p.add_argument("out_ark")
    p.add_argument("--out-scp", default=None)
    p.add_argument("--norm-vars", action="store_true")
    p.add_argument("--delta-order", type=int, default=2)
    p.add_argument("--left-context", type=int, default=4)
    p.add_argument("--right-context", type=int, default=4)
    args = p.parse_args(argv)
    n = 0
    with ArkWriter(args.out_ark, args.out_scp) as w:
        for utt, mat in read_mat_ark(args.in_ark):
            if verb == "apply-cmvn":
                out = F.apply_cmvn(mat, args.norm_vars)
            elif verb == "add-deltas":
                out = F.compute_deltas(mat, args.delta_order)
            elif verb == "splice-feats":
                out = F.splice_frames(mat, args.left_context,
                                      args.right_context)
            else:  # copy-feats
                out = mat
            w.write(utt, np.asarray(out, np.float32))
            n += 1
    print(f"{verb}: processed {n} utterances", file=sys.stderr)
    return 0


def cmd_compute_wer(argv: List[str]) -> int:
    from kaldi_cnn_tpu.decode.score import wer_details
    p = argparse.ArgumentParser(
        prog="compute-wer",
        description="ref/hyp text files: '<utt> <word> <word> ...'")
    p.add_argument("ref_text")
    p.add_argument("hyp_text")
    args = p.parse_args(argv)

    def load(path: str) -> Dict[str, List[str]]:
        out = {}
        for line in open(path):
            parts = line.split()
            if parts:
                out[parts[0]] = parts[1:]
        return out

    r = wer_details(load(args.ref_text), load(args.hyp_text))
    print(f"%WER {r['wer']:.2f} [ {r['errors']} / {r['words']}, "
          f"{r['ins']} ins, {r['del']} del, {r['sub']} sub ]")
    return 0


def cmd_compute_cmvn_stats(argv: List[str]) -> int:
    """Per-utterance or per-speaker CMVN stats ark
    (ref: featbin/compute-cmvn-stats.cc with --spk2utt)."""
    from kaldi_cnn_tpu.features import functional as F
    from kaldi_cnn_tpu.io.kaldi_io import ArkWriter, read_mat_ark
    p = argparse.ArgumentParser(prog="compute-cmvn-stats")
    p.add_argument("--spk2utt", default=None,
                   help="text file '<spk> <utt1> <utt2> ...' -> "
                        "per-speaker stats")
    p.add_argument("in_ark")
    p.add_argument("out_ark")
    args = p.parse_args(argv)
    feats = dict(read_mat_ark(args.in_ark))
    with ArkWriter(args.out_ark) as w:
        if args.spk2utt:
            n = 0
            for line in open(args.spk2utt):
                parts = line.split()
                if not parts:
                    continue
                spk, utts = parts[0], parts[1:]
                stats = sum(F.cmvn_stats(feats[u]) for u in utts
                            if u in feats)
                w.write(spk, stats.astype(np.float64))
                n += 1
            print(f"wrote stats for {n} speakers", file=sys.stderr)
        else:
            for utt, mat in feats.items():
                w.write(utt, F.cmvn_stats(mat).astype(np.float64))
            print(f"wrote stats for {len(feats)} utterances",
                  file=sys.stderr)
    return 0


def cmd_apply_cmvn_stats(argv: List[str]) -> int:
    """Apply precomputed CMVN stats (ref: featbin/apply-cmvn.cc with
    --utt2spk; the stats-less per-utt mode is the apply-cmvn verb)."""
    from kaldi_cnn_tpu.features import functional as F
    from kaldi_cnn_tpu.io.kaldi_io import ArkWriter, read_ark, read_mat_ark
    p = argparse.ArgumentParser(prog="apply-cmvn-stats")
    p.add_argument("--utt2spk", default=None,
                   help="text file '<utt> <spk>' mapping to stats keys")
    p.add_argument("--norm-vars", action="store_true")
    p.add_argument("cmvn_ark")
    p.add_argument("in_ark")
    p.add_argument("out_ark")
    args = p.parse_args(argv)
    stats = dict(read_ark(args.cmvn_ark))
    utt2spk = {}
    if args.utt2spk:
        for line in open(args.utt2spk):
            parts = line.split()
            if len(parts) >= 2:
                utt2spk[parts[0]] = parts[1]
    n = 0
    with ArkWriter(args.out_ark) as w:
        for utt, mat in read_mat_ark(args.in_ark):
            key = utt2spk.get(utt, utt)
            out = F.apply_cmvn_stats(mat, stats[key], args.norm_vars)
            w.write(utt, np.asarray(out, np.float32))
            n += 1
    print(f"applied cmvn to {n} utterances", file=sys.stderr)
    return 0


# --------------------------------------------------------------------------
# lattice verbs (ref: src/latbin/*.cc; archives are the npz form of
# decode/lattice.py save_lattices)
# --------------------------------------------------------------------------

def _lat_scales(p: argparse.ArgumentParser) -> None:
    p.add_argument("--acoustic-scale", type=float, default=1.0)
    p.add_argument("--lm-scale", type=float, default=1.0)
    p.add_argument("--word-ins-penalty", type=float, default=0.0)


def _load_word_table(path):
    from kaldi_cnn_tpu.lang.symbols import SymbolTable
    if path is None:
        return None
    return SymbolTable.read(path)


def _words_str(words, table) -> str:
    if table is None:
        return " ".join(str(int(w)) for w in words)
    return " ".join(table.sym(int(w)) for w in words)


def cmd_lattice_best_path(argv: List[str]) -> int:
    from kaldi_cnn_tpu.decode.lattice import load_lattices, shortest_path
    p = argparse.ArgumentParser(prog="lattice-best-path")
    _lat_scales(p)
    p.add_argument("--word-table", default=None)
    p.add_argument("lat_npz")
    args = p.parse_args(argv)
    table = _load_word_table(args.word_table)
    for utt, lat in sorted(load_lattices(args.lat_npz).items()):
        _, words, cost = shortest_path(
            lat, args.lm_scale, args.acoustic_scale,
            args.word_ins_penalty)
        print(f"{utt} {_words_str(words, table)}")
        print(f"{utt} cost={cost:.4f}", file=sys.stderr)
    return 0


def cmd_lattice_copy(argv: List[str]) -> int:
    """Copy/convert lattice archives between the native npz form and
    Kaldi-binary CompactLattice arks (ref: latbin/lattice-copy.cc).
    Format is sniffed on read (npz = zip magic) and chosen on write by
    extension: ``.npz`` native, anything else Kaldi binary."""
    from kaldi_cnn_tpu.decode.lattice import load_lattices, save_lattices
    from kaldi_cnn_tpu.io.kaldi_lattice import (
        read_compact_lattice_ark, write_compact_lattice_ark)
    p = argparse.ArgumentParser(prog="lattice-copy")
    p.add_argument("lat_in")
    p.add_argument("lat_out", nargs="?", default=None,
                   help="omit to dump Kaldi text-lattice form to stdout")
    args = p.parse_args(argv)
    with open(args.lat_in, "rb") as f:
        is_npz = f.read(2) == b"PK"
    lats = (load_lattices(args.lat_in) if is_npz
            else read_compact_lattice_ark(args.lat_in))
    if args.lat_out is None:         # text dump (lattice-copy text mode)
        from kaldi_cnn_tpu.decode.lattice import write_lattice_text
        for utt, lat in sorted(lats.items()):
            print(utt)
            write_lattice_text(lat, sys.stdout)
            print()
    elif args.lat_out.endswith(".npz"):
        save_lattices(args.lat_out, lats)
    else:
        write_compact_lattice_ark(args.lat_out, lats)
    print(f"lattice-copy: {len(lats)} lattices", file=sys.stderr)
    return 0


def cmd_lattice_mbr(argv: List[str]) -> int:
    from kaldi_cnn_tpu.decode.lattice import load_lattices, mbr_decode
    p = argparse.ArgumentParser(prog="lattice-mbr-decode")
    _lat_scales(p)
    p.add_argument("--word-table", default=None)
    p.add_argument("lat_npz")
    args = p.parse_args(argv)
    table = _load_word_table(args.word_table)
    for utt, lat in sorted(load_lattices(args.lat_npz).items()):
        words = mbr_decode(lat, args.lm_scale, args.acoustic_scale)
        print(f"{utt} {_words_str(words, table)}")
    return 0


def cmd_lattice_nbest(argv: List[str]) -> int:
    from kaldi_cnn_tpu.decode.lattice import load_lattices, nbest
    p = argparse.ArgumentParser(prog="lattice-nbest")
    _lat_scales(p)
    p.add_argument("--n", type=int, default=10)
    p.add_argument("--word-table", default=None)
    p.add_argument("lat_npz")
    args = p.parse_args(argv)
    table = _load_word_table(args.word_table)
    for utt, lat in sorted(load_lattices(args.lat_npz).items()):
        for i, (words, cost) in enumerate(nbest(
                lat, args.n, args.lm_scale, args.acoustic_scale,
                args.word_ins_penalty), 1):
            print(f"{utt}-{i} {_words_str(words, table)}")
    return 0


def cmd_lattice_unary(argv: List[str], verb: str) -> int:
    """prune/push/minimize/determinize/scale: npz in -> npz out."""
    from kaldi_cnn_tpu.decode import lattice as L
    p = argparse.ArgumentParser(prog=verb)
    _lat_scales(p)
    if verb == "lattice-prune":
        p.add_argument("--beam", type=float, default=8.0)
    if verb == "lattice-determinize":
        p.add_argument("--max-paths", type=int, default=200)
    p.add_argument("lat_in")
    p.add_argument("lat_out")
    args = p.parse_args(argv)
    out = {}
    for utt, lat in L.load_lattices(args.lat_in).items():
        if verb == "lattice-prune":
            out[utt] = L.prune_lattice(lat, args.beam, args.lm_scale,
                                       args.acoustic_scale)
        elif verb == "lattice-push":
            out[utt] = L.push_lattice(lat)
        elif verb == "lattice-minimize":
            out[utt] = L.minimize_lattice(lat)
        elif verb == "lattice-determinize":
            out[utt] = L.determinize_lattice(
                lat, args.lm_scale, args.acoustic_scale,
                max_paths=args.max_paths)
        else:  # lattice-scale (ref: latbin/lattice-scale.cc)
            lat.arc_graph = (args.lm_scale * lat.arc_graph).astype(
                np.float32)
            lat.arc_acoustic = (args.acoustic_scale
                                * lat.arc_acoustic).astype(np.float32)
            lat.final_graph = np.where(
                np.isfinite(lat.final_graph),
                args.lm_scale * lat.final_graph,
                np.inf).astype(np.float32)
            out[utt] = lat
    L.save_lattices(args.lat_out, out)
    print(f"{verb}: {len(out)} lattices", file=sys.stderr)
    return 0


def cmd_lattice_lmrescore(argv: List[str]) -> int:
    """(ref: latbin/lattice-lmrescore-const-arpa.cc; use --scale=-1
    with the old LM first to swap LMs)."""
    from kaldi_cnn_tpu.decode.lattice import (
        lm_rescore, load_lattices, save_lattices)
    from kaldi_cnn_tpu.lang.arpa import parse_arpa
    from kaldi_cnn_tpu.lang.const_arpa import ConstArpaLm
    p = argparse.ArgumentParser(prog="lattice-lmrescore")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--word-table", default=None,
                   help="words.txt mapping LM words to lattice ids")
    p.add_argument("arpa_or_npz", help=".arpa text or const-arpa .npz")
    p.add_argument("lat_in")
    p.add_argument("lat_out")
    args = p.parse_args(argv)
    if args.arpa_or_npz.endswith(".npz"):
        lm = ConstArpaLm.load(args.arpa_or_npz)
    else:
        table = _load_word_table(args.word_table)
        vocab = dict(table._sym2id) if table is not None else None
        lm = ConstArpaLm.from_arpa(
            parse_arpa(open(args.arpa_or_npz).read()), vocab)
    out = {utt: lm_rescore(lat, lm, args.scale)
           for utt, lat in load_lattices(args.lat_in).items()}
    save_lattices(args.lat_out, out)
    print(f"rescored {len(out)} lattices", file=sys.stderr)
    return 0


def cmd_lattice_to_post(argv: List[str]) -> int:
    """Per-frame transition-id posteriors in Kaldi text posterior
    format ``utt [ tid w .. ] [ .. ]`` (ref: latbin/lattice-to-post.cc)."""
    from kaldi_cnn_tpu.decode.lattice import arc_posteriors, load_lattices
    p = argparse.ArgumentParser(prog="lattice-to-post")
    _lat_scales(p)
    p.add_argument("lat_npz")
    args = p.parse_args(argv)
    for utt, lat in sorted(load_lattices(args.lat_npz).items()):
        post = arc_posteriors(lat, args.lm_scale, args.acoustic_scale)
        frames: Dict[int, Dict[int, float]] = {}
        for a in range(lat.num_arcs):
            tid = int(lat.arc_ilabel[a])
            if tid <= 0:
                continue
            t = int(lat.state_time[lat.arc_src[a]])
            frames.setdefault(t, {})
            frames[t][tid] = frames[t].get(tid, 0.0) + float(post[a])
        chunks = []
        for t in range(max(frames) + 1 if frames else 0):
            items = frames.get(t, {})
            body = " ".join(f"{tid} {w:.6g}"
                            for tid, w in sorted(items.items()))
            chunks.append(f"[ {body} ]")
        print(f"{utt} {' '.join(chunks)}")
    return 0


# --------------------------------------------------------------------------
# model verbs (ref: src/nnet2bin/, src/gmmbin/)
# --------------------------------------------------------------------------

def cmd_nnet_am_info(argv: List[str]) -> int:
    from kaldi_cnn_tpu.io.kaldi_model import read_am_nnet
    p = argparse.ArgumentParser(prog="nnet-am-info")
    p.add_argument("mdl")
    args = p.parse_args(argv)
    tm, nnet, params, priors = read_am_nnet(args.mdl)
    n_params = sum(int(np.prod(np.shape(v)))
                   for pr in params for v in (pr or {}).values())
    print(f"num-components {len(nnet.components)}")
    print(f"num-pdfs {tm.num_pdfs}")
    print(f"input-dim {nnet.input_dim}")
    print(f"output-dim {nnet.output_dim}")
    print(f"parameter-count {n_params}")
    for i, (c, pr) in enumerate(zip(nnet.components, params)):
        dims = ""
        if hasattr(c, "input_dim"):
            dims = f" input-dim={c.input_dim}"
        if hasattr(c, "output_dim"):
            dims += f" output-dim={c.output_dim}"
        elif hasattr(c, "dim"):
            dims += f" dim={c.dim}"
        print(f"component {i} : {type(c).__name__}{dims}")
    return 0


def cmd_nnet_am_copy(argv: List[str]) -> int:
    from kaldi_cnn_tpu.io.kaldi_model import read_am_nnet, write_am_nnet
    p = argparse.ArgumentParser(prog="nnet-am-copy")
    p.add_argument("--learning-rate-scale", type=float, default=1.0,
                   help="kept for flag parity; learning rates live in "
                        "the trainer here")
    p.add_argument("mdl_in")
    p.add_argument("mdl_out")
    args = p.parse_args(argv)
    tm, nnet, params, priors = read_am_nnet(args.mdl_in)
    write_am_nnet(args.mdl_out, tm, nnet, params, priors)
    return 0


def cmd_nnet_am_average(argv: List[str]) -> int:
    """Parameter averaging across models — the reference's data-parallel
    'allreduce' (ref: nnet2bin/nnet-am-average.cc)."""
    from kaldi_cnn_tpu.io.kaldi_model import read_am_nnet, write_am_nnet
    p = argparse.ArgumentParser(prog="nnet-am-average")
    p.add_argument("mdl_in", nargs="+")
    p.add_argument("mdl_out")
    args = p.parse_args(argv)
    tm, nnet, params, priors = read_am_nnet(args.mdl_in[0])
    acc = [dict((k, v.astype(np.float64)) for k, v in (pr or {}).items())
           for pr in params]
    for path in args.mdl_in[1:]:
        _, _, other, _ = read_am_nnet(path)
        for a, o in zip(acc, other):
            for k in a:
                a[k] = a[k] + o[k]
    n = len(args.mdl_in)
    avg = tuple({k: (v / n).astype(np.float32) for k, v in a.items()}
                for a in acc)
    write_am_nnet(args.mdl_out, tm, nnet, avg, priors)
    print(f"averaged {n} models", file=sys.stderr)
    return 0


def cmd_gmm_info(argv: List[str]) -> int:
    from kaldi_cnn_tpu.io.kaldi_model import read_gmm_model
    p = argparse.ArgumentParser(prog="gmm-info")
    p.add_argument("mdl")
    args = p.parse_args(argv)
    tm, am = read_gmm_model(args.mdl)
    print(f"number of phones {len(tm.topo.phones)}")
    print(f"number of pdfs {tm.num_pdfs}")
    print(f"number of transition-ids {tm.num_transition_ids}")
    print(f"number of transition-states {tm.num_transition_states}")
    print(f"feature dimension {am.dim}")
    print(f"number of gaussians {sum(g.num_gauss for g in am.gmms)}")
    return 0


def cmd_ali_to_pdf(argv: List[str]) -> int:
    """transition-id alignments -> pdf-id alignments
    (ref: bin/ali-to-pdf.cc)."""
    from kaldi_cnn_tpu.io.kaldi_io import ArkWriter, read_vec_int_ark
    from kaldi_cnn_tpu.io.kaldi_model import read_am_nnet, read_gmm_model
    p = argparse.ArgumentParser(prog="ali-to-pdf")
    p.add_argument("mdl")
    p.add_argument("ali_ark")
    p.add_argument("out_ark")
    args = p.parse_args(argv)
    try:
        tm, _ = read_gmm_model(args.mdl)
    except ValueError:
        tm = read_am_nnet(args.mdl)[0]
    id2pdf = tm.trans_id_to_pdf_array()
    n = 0
    with ArkWriter(args.out_ark) as w:
        for utt, ali in read_vec_int_ark(args.ali_ark):
            w.write(utt, id2pdf[np.asarray(ali)].astype(np.int32))
            n += 1
    print(f"converted {n} alignments", file=sys.stderr)
    return 0


def cmd_arpa2fst(argv: List[str]) -> int:
    """ARPA -> G.fst in OpenFst text format (ref: bin/arpa2fst.cc +
    fstprint)."""
    from kaldi_cnn_tpu.lang.arpa import arpa_to_fst, parse_arpa
    from kaldi_cnn_tpu.lang.symbols import SymbolTable
    p = argparse.ArgumentParser(prog="arpa2fst")
    p.add_argument("arpa")
    p.add_argument("words_txt")
    p.add_argument("out_fst_txt")
    args = p.parse_args(argv)
    table = _load_word_table(args.words_txt) or SymbolTable()
    g = arpa_to_fst(parse_arpa(open(args.arpa).read()), table)
    with open(args.out_fst_txt, "w") as fh:
        g.write_text(fh)
    print(f"G: {g.num_states} states, {g.num_arcs} arcs",
          file=sys.stderr)
    return 0


def cmd_run_recipe(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="run-recipe")
    p.add_argument("recipe", choices=["yesno", "rm", "wsj", "swbd",
                                      "librispeech"])
    args = p.parse_args(argv)
    import importlib
    mod = importlib.import_module(f"kaldi_cnn_tpu.recipes.{args.recipe}")
    res = mod.run()
    print(res)
    return 0


VERBS = {
    "compute-mfcc-feats": lambda a: cmd_compute_feats(a, "mfcc"),
    "compute-fbank-feats": lambda a: cmd_compute_feats(a, "fbank"),
    "apply-cmvn": lambda a: cmd_transform(a, "apply-cmvn"),
    "add-deltas": lambda a: cmd_transform(a, "add-deltas"),
    "splice-feats": lambda a: cmd_transform(a, "splice-feats"),
    "copy-feats": lambda a: cmd_transform(a, "copy-feats"),
    "compute-wer": cmd_compute_wer,
    "run-recipe": cmd_run_recipe,
    "compute-cmvn-stats": cmd_compute_cmvn_stats,
    "apply-cmvn-stats": cmd_apply_cmvn_stats,
    "lattice-best-path": cmd_lattice_best_path,
    "lattice-copy": cmd_lattice_copy,
    "lattice-mbr-decode": cmd_lattice_mbr,
    "lattice-nbest": cmd_lattice_nbest,
    "lattice-prune": lambda a: cmd_lattice_unary(a, "lattice-prune"),
    "lattice-push": lambda a: cmd_lattice_unary(a, "lattice-push"),
    "lattice-minimize": lambda a: cmd_lattice_unary(a, "lattice-minimize"),
    "lattice-determinize":
        lambda a: cmd_lattice_unary(a, "lattice-determinize"),
    "lattice-scale": lambda a: cmd_lattice_unary(a, "lattice-scale"),
    "lattice-lmrescore": cmd_lattice_lmrescore,
    "lattice-to-post": cmd_lattice_to_post,
    "nnet-am-info": cmd_nnet_am_info,
    "nnet-am-copy": cmd_nnet_am_copy,
    "nnet-am-average": cmd_nnet_am_average,
    "gmm-info": cmd_gmm_info,
    "ali-to-pdf": cmd_ali_to_pdf,
    "arpa2fst": cmd_arpa2fst,
    "compute-kaldi-pitch-feats": cmd_compute_pitch,
    "process-kaldi-pitch-feats": cmd_process_pitch,
}

# training/alignment/decoding pipeline verbs (cli_train.py)
from kaldi_cnn_tpu.cli_train import TRAIN_VERBS

VERBS.update(TRAIN_VERBS)


def main(argv: List[str] = None) -> int:
    from kaldi_cnn_tpu.core.backend import setup_compile_cache
    setup_compile_cache()
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("verbs:", ", ".join(sorted(VERBS)))
        return 0
    verb, rest = argv[0], argv[1:]
    if verb not in VERBS:
        print(f"unknown verb {verb!r}; verbs: {', '.join(sorted(VERBS))}",
              file=sys.stderr)
        return 2
    return VERBS[verb](rest)


if __name__ == "__main__":
    sys.exit(main())

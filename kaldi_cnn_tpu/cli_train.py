"""Training/alignment/decoding CLI verbs — the reference's load-bearing
pipeline binaries as verbs (SURVEY.md §2.1 CLI row):

  prepare-lang          utils/prepare_lang.sh
  compile-train-graphs  bin/compile-train-graphs.cc
  gmm-train-mono        steps/train_mono.sh (gmm-init-mono + EM loop)
  gmm-align             bin/align-compiled-mapped.cc / gmm-align-compiled
  nnet-get-egs          nnet2bin/nnet-get-egs.cc
  nnet-train            nnet2bin/nnet-train-simple.cc
  mkgraph               utils/mkgraph.sh
  latgen-faster         nnet2bin/nnet-latgen-faster.cc / gmm-latgen-faster

Each reads/writes on-disk artifacts (ark/scp features, .mdl models,
text FSTs, npz egs/lattices) so the whole pipeline composes from the
shell exactly like the reference's recipes do.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional

import numpy as np


# ---------------------------------------------------------------- helpers

def _load_lang(lang_dir: str):
    """Rebuild Lang deterministically from <lang_dir>/lexicon.txt — the
    CLI's lang-dir contract (prepare-lang writes it)."""
    from kaldi_cnn_tpu.lang.hclg import Lang
    from kaldi_cnn_tpu.recipes.datadir import read_lexicon_file
    lex = read_lexicon_file(os.path.join(lang_dir, "lexicon.txt"))
    return Lang.create(lex)


def _read_text(path: str) -> Dict[str, List[str]]:
    out = {}
    for line in open(path):
        parts = line.split()
        if parts:
            out[parts[0]] = parts[1:]
    return out


def write_fst_archive(path: str, fsts: Dict[str, "object"]) -> None:
    """Keyed text-FST archive: '<key>\\n<arcs...>\\n\\n' per entry."""
    import io
    with open(path, "w", encoding="utf-8") as f:
        for key in sorted(fsts):
            f.write(key + "\n")
            buf = io.StringIO()
            fsts[key].write_text(buf)
            f.write(buf.getvalue())
            f.write("\n")


def read_fst_archive(path: str) -> Dict[str, "object"]:
    import io
    from kaldi_cnn_tpu.lang.fst import Fst
    out = {}
    key, lines = None, []
    for line in list(open(path)) + [""]:
        stripped = line.rstrip("\n")
        if key is None:
            if stripped:
                key = stripped
            continue
        if stripped == "":
            out[key] = Fst.read_text(io.StringIO("".join(lines)))
            key, lines = None, []
        else:
            lines.append(line)
    return out


# ------------------------------------------------------------------ verbs

def cmd_prepare_lang(argv: List[str]) -> int:
    """lexicon.txt -> lang dir with phones.txt/words.txt (ref:
    utils/prepare_lang.sh)."""
    from kaldi_cnn_tpu.lang.hclg import Lang
    from kaldi_cnn_tpu.recipes.datadir import read_lexicon_file
    p = argparse.ArgumentParser(prog="prepare-lang")
    p.add_argument("lexicon", help="lexicon.txt: word phone phone ...")
    p.add_argument("lang_dir")
    args = p.parse_args(argv)
    os.makedirs(args.lang_dir, exist_ok=True)
    lex = read_lexicon_file(args.lexicon)
    lang = Lang.create(lex)
    import shutil
    dst = os.path.join(args.lang_dir, "lexicon.txt")
    if os.path.abspath(args.lexicon) != os.path.abspath(dst):
        shutil.copyfile(args.lexicon, dst)
    lang.phone_table.write(os.path.join(args.lang_dir, "phones.txt"))
    lang.word_table.write(os.path.join(args.lang_dir, "words.txt"))
    print(f"prepare-lang: {len(lex.entries)} words, "
          f"{len(lex.phones)} phones, "
          f"{lang.trans_model.num_transition_ids} transition-ids",
          file=sys.stderr)
    return 0


def cmd_compile_train_graphs(argv: List[str]) -> int:
    """Per-utterance training graphs from transcripts (ref:
    bin/compile-train-graphs.cc TrainingGraphCompiler::CompileGraphs)."""
    from kaldi_cnn_tpu.lang.hclg import compile_training_graph
    p = argparse.ArgumentParser(prog="compile-train-graphs")
    p.add_argument("--transition-scale", type=float, default=1.0)
    p.add_argument("--self-loop-scale", type=float, default=0.1)
    p.add_argument("lang_dir")
    p.add_argument("text", help="<utt> <word> ... per line")
    p.add_argument("out_archive")
    args = p.parse_args(argv)
    lang = _load_lang(args.lang_dir)
    text = _read_text(args.text)
    graphs = {
        utt: compile_training_graph(
            lang, words, transition_scale=args.transition_scale,
            self_loop_scale=args.self_loop_scale)
        for utt, words in text.items()}
    write_fst_archive(args.out_archive, graphs)
    print(f"compile-train-graphs: {len(graphs)} graphs",
          file=sys.stderr)
    return 0


def cmd_gmm_train_mono(argv: List[str]) -> int:
    """Flat-start monophone EM training (ref: steps/train_mono.sh:
    gmm-init-mono + align/acc/est iterations)."""
    from kaldi_cnn_tpu.gmm.train import MonoTrainOptions, train_mono
    from kaldi_cnn_tpu.io.kaldi_io import ArkWriter, read_scp_dict
    from kaldi_cnn_tpu.io.kaldi_model import write_gmm_model
    p = argparse.ArgumentParser(prog="gmm-train-mono")
    p.add_argument("--num-iters", type=int, default=25)
    p.add_argument("--totgauss", type=int, default=400)
    p.add_argument("--beam", type=float, default=128.0)
    p.add_argument("lang_dir")
    p.add_argument("feats_scp")
    p.add_argument("text")
    p.add_argument("out_mdl")
    p.add_argument("out_ali_ark")
    args = p.parse_args(argv)
    lang = _load_lang(args.lang_dir)
    feats = read_scp_dict(args.feats_scp)
    text = _read_text(args.text)
    am, ali = train_mono(
        feats, text, lang,
        MonoTrainOptions(num_iters=args.num_iters,
                         totgauss=args.totgauss, beam=args.beam))
    write_gmm_model(args.out_mdl, lang.trans_model, am)
    with ArkWriter(args.out_ali_ark) as w:
        for utt in sorted(ali):
            w.write(utt, np.asarray(ali[utt], np.int32))
    print(f"gmm-train-mono: {len(ali)} alignments, "
          f"{am.total_gauss()} gaussians", file=sys.stderr)
    return 0


def cmd_gmm_align(argv: List[str]) -> int:
    """Viterbi alignment of features to transcripts with a trained GMM
    (ref: gmmbin/gmm-align-compiled.cc over compile-train-graphs
    output)."""
    from kaldi_cnn_tpu.decode.decoder import viterbi_align
    from kaldi_cnn_tpu.decode.graph import CompiledGraph
    from kaldi_cnn_tpu.io.kaldi_io import ArkWriter, read_scp_dict
    from kaldi_cnn_tpu.io.kaldi_model import read_gmm_model
    p = argparse.ArgumentParser(prog="gmm-align")
    p.add_argument("--beam", type=float, default=128.0)
    p.add_argument("--acoustic-scale", type=float, default=1.0)
    p.add_argument("mdl")
    p.add_argument("graphs_archive",
                   help="compile-train-graphs output")
    p.add_argument("feats_scp")
    p.add_argument("out_ali_ark")
    args = p.parse_args(argv)
    tm, am = read_gmm_model(args.mdl)
    tid2pdf = tm.trans_id_to_pdf_array()
    graphs = read_fst_archive(args.graphs_archive)
    feats = read_scp_dict(args.feats_scp)
    n_done, n_fail = 0, 0
    with ArkWriter(args.out_ali_ark) as w:
        for utt in sorted(feats):
            if utt not in graphs:
                n_fail += 1
                continue
            g = CompiledGraph(graphs[utt], tid2pdf)
            ll = am.loglikes(feats[utt])
            ali = viterbi_align(g, ll, acoustic_scale=args.acoustic_scale,
                                beam=args.beam)
            if ali is None:
                n_fail += 1
                continue
            w.write(utt, np.asarray(ali, np.int32))
            n_done += 1
    print(f"gmm-align: {n_done} done, {n_fail} failed", file=sys.stderr)
    return 0 if n_done > 0 else 1


def cmd_nnet_get_egs(argv: List[str]) -> int:
    """Spliced frame chunks + pdf labels -> egs.npz (ref:
    nnet2bin/nnet-get-egs.cc + nnet-shuffle-egs)."""
    from kaldi_cnn_tpu.core.rng import np_rng
    from kaldi_cnn_tpu.io.kaldi_io import read_scp_dict, read_vec_int_ark
    from kaldi_cnn_tpu.io.kaldi_model import read_gmm_model
    from kaldi_cnn_tpu.train.egs import Egs
    p = argparse.ArgumentParser(prog="nnet-get-egs")
    p.add_argument("--left-context", type=int, default=4)
    p.add_argument("--right-context", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("mdl", help="GMM .mdl supplying the tid->pdf map")
    p.add_argument("feats_scp")
    p.add_argument("ali_ark")
    p.add_argument("out_egs")
    args = p.parse_args(argv)
    tm, _ = read_gmm_model(args.mdl)
    tid2pdf = tm.trans_id_to_pdf_array()
    feats = read_scp_dict(args.feats_scp)
    ali = {u: np.asarray(a, np.int64)
           for u, a in read_vec_int_ark(args.ali_ark)}
    xs, ys = [], []
    n_no_ali, n_len_mismatch = 0, 0
    for utt in sorted(feats):
        if utt not in ali:
            n_no_ali += 1
            continue
        f = feats[utt]
        a = ali[utt]
        if len(a) != f.shape[0]:
            # e.g. unspliced vs delta feats, or alignments from a
            # different feature pipeline (the reference's nnet-get-egs
            # logs and skips these the same way)
            print(f"nnet-get-egs: skipping {utt}: alignment length "
                  f"{len(a)} != {f.shape[0]} feature frames",
                  file=sys.stderr)
            n_len_mismatch += 1
            continue
        T = f.shape[0]
        idx = np.clip(
            np.arange(T)[:, None] + np.arange(
                -args.left_context, args.right_context + 1)[None],
            0, T - 1)
        xs.append(f[idx].reshape(T, -1))
        ys.append(tid2pdf[a])
    if n_no_ali or n_len_mismatch:
        print(f"nnet-get-egs: skipped {n_no_ali} utts without alignment, "
              f"{n_len_mismatch} with feature/alignment length mismatch",
              file=sys.stderr)
    if not xs:
        raise SystemExit(
            "nnet-get-egs: no usable utterances — every utterance was "
            "skipped (missing alignments or feature/alignment length "
            "mismatch; check that feats and alignments come from the "
            "same feature pipeline)")
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.int32)
    perm = np_rng(args.seed, "cli_egs_shuffle").permutation(len(y))
    Egs(x[perm], y[perm], np.ones(len(y), np.float32)).save(args.out_egs)
    print(f"nnet-get-egs: {len(y)} examples, dim {x.shape[1]}",
          file=sys.stderr)
    return 0


def cmd_nnet_train(argv: List[str]) -> int:
    """Train a p-norm DNN AM on egs and write the .mdl (ref:
    nnet2bin/nnet-train-simple.cc + nnet-am-init + nnet-adjust-priors
    collapsed into one verb; NG-SGD on by default like the scripts)."""
    from kaldi_cnn_tpu.io.kaldi_model import read_gmm_model, write_am_nnet
    from kaldi_cnn_tpu.models.factory import PnormDnnConfig, make_pnorm_dnn
    from kaldi_cnn_tpu.train.egs import Egs
    from kaldi_cnn_tpu.train.trainer import TrainConfig, train_nnet
    p = argparse.ArgumentParser(prog="nnet-train")
    p.add_argument("--num-epochs", type=int, default=8)
    p.add_argument("--minibatch-size", type=int, default=256)
    p.add_argument("--initial-learning-rate", type=float, default=0.02)
    p.add_argument("--final-learning-rate", type=float, default=0.004)
    p.add_argument("--num-hidden-layers", type=int, default=2)
    p.add_argument("--pnorm-input-dim", type=int, default=400)
    p.add_argument("--pnorm-output-dim", type=int, default=80)
    p.add_argument("--valid-fraction", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("gmm_mdl", help="bootstrap GMM .mdl (transition "
                                   "model + num-pdfs source)")
    p.add_argument("egs")
    p.add_argument("out_mdl")
    args = p.parse_args(argv)
    tm, _ = read_gmm_model(args.gmm_mdl)
    egs_all = Egs.load(args.egs)
    n_valid = max(int(len(egs_all) * args.valid_fraction), 128)
    egs_valid = Egs(egs_all.x[:n_valid], egs_all.y[:n_valid],
                    egs_all.weights[:n_valid])
    egs_train = Egs(egs_all.x[n_valid:], egs_all.y[n_valid:],
                    egs_all.weights[n_valid:])
    cfg = PnormDnnConfig(
        input_dim=egs_train.x.shape[1],
        num_hidden_layers=args.num_hidden_layers,
        pnorm_input_dim=args.pnorm_input_dim,
        pnorm_output_dim=args.pnorm_output_dim,
        num_pdfs=tm.num_pdfs)
    net = make_pnorm_dnn(cfg)
    params, _ = train_nnet(
        net, egs_train, egs_valid,
        TrainConfig(num_epochs=args.num_epochs,
                    minibatch_size=args.minibatch_size,
                    initial_learning_rate=args.initial_learning_rate,
                    final_learning_rate=args.final_learning_rate,
                    seed=args.seed))
    counts = np.bincount(egs_train.y, minlength=tm.num_pdfs) + 0.5
    priors = counts / counts.sum()
    write_am_nnet(args.out_mdl, tm, net, params, priors)
    print(f"nnet-train: {len(egs_train)} egs, {args.num_epochs} epochs "
          f"-> {args.out_mdl}", file=sys.stderr)
    return 0


def cmd_mkgraph(argv: List[str]) -> int:
    """lang + ARPA LM -> HCLG text FST (ref: utils/mkgraph.sh)."""
    from kaldi_cnn_tpu.lang.hclg import make_hclg_from_arpa
    p = argparse.ArgumentParser(prog="mkgraph")
    p.add_argument("lang_dir")
    p.add_argument("arpa", help=".arpa text LM")
    p.add_argument("out_fst")
    args = p.parse_args(argv)
    lang = _load_lang(args.lang_dir)
    hclg = make_hclg_from_arpa(lang, open(args.arpa).read())
    with open(args.out_fst, "w") as f:
        hclg.write_text(f)
    print(f"mkgraph: HCLG with {hclg.num_states} states, "
          f"{hclg.num_arcs} arcs", file=sys.stderr)
    return 0


def cmd_latgen_faster(argv: List[str]) -> int:
    """Lattice-generating decode with a GMM or nnet AM (ref:
    gmmbin/gmm-latgen-faster.cc, nnet2bin/nnet-latgen-faster.cc).
    Writes lattices (npz) and one-best transcripts.

    The default decode path is the batched on-device top-K beam search with
    on-device lattice emission + word-level determinization
    (decode/topk_decoder.py) — acoustic scoring AND token passing both
    on-device; ``--host-decode`` falls back to the host
    lattice decoder (the correctness baseline)."""
    import time
    from kaldi_cnn_tpu.decode.decoder import lattice_decode
    from kaldi_cnn_tpu.decode.graph import CompiledGraph
    from kaldi_cnn_tpu.decode.lattice import save_lattices, shortest_path
    from kaldi_cnn_tpu.io.kaldi_io import read_scp_dict
    from kaldi_cnn_tpu.lang.fst import Fst
    p = argparse.ArgumentParser(prog="latgen-faster")
    p.add_argument("--beam", type=float, default=16.0)
    p.add_argument("--lattice-beam", type=float, default=8.0)
    p.add_argument("--max-active", type=int, default=7000)
    p.add_argument("--acoustic-scale", type=float, default=0.1)
    p.add_argument("--word-ins-penalty", type=float, default=0.0)
    p.add_argument("--host-decode", action="store_true",
                   help="decode per-utterance on the host instead of "
                        "the batched device decoder")
    p.add_argument("--batch-size", type=int, default=16)
    # default None = derive from --max-active (no auto-grow re-decodes)
    p.add_argument("--lattice-arcs-per-frame", type=int, default=None)
    p.add_argument("--lang-dir", required=True,
                   help="for words.txt + transition model")
    p.add_argument("mdl", help=".mdl — GMM or am-nnet, sniffed")
    p.add_argument("graph_fst", help="mkgraph output")
    p.add_argument("feats_scp")
    p.add_argument("out_lats")
    p.add_argument("out_text")
    args = p.parse_args(argv)

    from kaldi_cnn_tpu.lang.symbols import SymbolTable
    words = SymbolTable.read(os.path.join(args.lang_dir, "words.txt"))
    tm, scorer, _ = _load_am(args.mdl)
    with open(args.graph_fst) as f:
        hclg = Fst.read_text(f)
    graph = CompiledGraph(hclg, tm.trans_id_to_pdf_array())
    feats = read_scp_dict(args.feats_scp)
    t0 = time.perf_counter()
    lls = {utt: np.asarray(scorer(feats[utt]), np.float32)
           for utt in sorted(feats)}
    if args.host_decode:
        lats = {utt: lattice_decode(graph, ll,
                                    acoustic_scale=args.acoustic_scale,
                                    beam=args.beam,
                                    lattice_beam=args.lattice_beam,
                                    max_active=args.max_active)
                for utt, ll in lls.items()}
    else:
        from kaldi_cnn_tpu.decode.topk_decoder import decode_utterances
        lats = decode_utterances(
            graph, lls, acoustic_scale=args.acoustic_scale,
            beam=args.beam, lattice_beam=args.lattice_beam,
            max_active=args.max_active,
            lattice_arcs_per_frame=args.lattice_arcs_per_frame,
            batch_size=args.batch_size)
    elapsed = time.perf_counter() - t0
    hyps = {}
    for utt, lat in lats.items():
        _, wids, _ = shortest_path(lat, 1.0, args.acoustic_scale,
                                   args.word_ins_penalty)
        hyps[utt] = " ".join(words.sym(int(w)) for w in wids)
    save_lattices(args.out_lats, lats)
    with open(args.out_text, "w") as f:
        for utt in sorted(hyps):
            f.write(f"{utt} {hyps[utt]}\n".rstrip() + "\n")
    audio_s = sum(ll.shape[0] for ll in lls.values()) / 100.0
    rtf = elapsed / max(audio_s, 1e-9)
    print(f"latgen-faster: decoded {len(lats)} utterances "
          f"({'host' if args.host_decode else 'device'} path, "
          f"{audio_s:.1f} audio-s in {elapsed:.2f}s, RTF {rtf:.4f})",
          file=sys.stderr)
    return 0


def cmd_online2_wav_latgen(argv: List[str]) -> int:
    """Streaming (online) decode straight from waveforms (ref:
    online2bin/online2-wav-nnet2-latgen-faster.cc): chunked audio ->
    OnlineFeaturePipeline (base features + online CMVN + deltas) ->
    chunked pseudo-loglikes -> incremental decode carrying token state
    across chunks (TpuStreamingDecoder by default; --host-decode uses
    the host incremental Viterbi).  Spliced nnet AMs are handled by a
    StreamingSplicer so results match offline decode of the same
    audio."""
    import time
    from kaldi_cnn_tpu.decode.graph import CompiledGraph
    from kaldi_cnn_tpu.features import functional as F
    from kaldi_cnn_tpu.lang.fst import Fst
    from kaldi_cnn_tpu.lang.symbols import SymbolTable
    from kaldi_cnn_tpu.recipes.datadir import read_key_value_file
    from kaldi_cnn_tpu.io.wave import read_wave
    from kaldi_cnn_tpu.online2 import (
        OnlineFeaturePipeline, OnlineRecognizer, StreamingSplicer)

    def load_wave(spec):
        spec = spec.strip()
        if spec.endswith("|"):      # extended rxfilename pipe
            import subprocess
            import tempfile
            data = subprocess.run(spec[:-1], shell=True, check=True,
                                  stdout=subprocess.PIPE).stdout
            with tempfile.NamedTemporaryFile(suffix=".wav") as tf:
                tf.write(data)
                tf.flush()
                samples, rate = read_wave(tf.name)
        else:
            samples, rate = read_wave(spec)
        return samples[0], rate

    p = argparse.ArgumentParser(prog="online2-wav-latgen")
    p.add_argument("--feature-type", default="mfcc",
                   choices=["mfcc", "fbank"])
    p.add_argument("--deltas-order", type=int, default=2)
    p.add_argument("--beam", type=float, default=16.0)
    p.add_argument("--max-active", type=int, default=7000)
    p.add_argument("--acoustic-scale", type=float, default=0.1)
    p.add_argument("--chunk-seconds", type=float, default=0.2,
                   help="audio chunk size fed to the recognizer")
    p.add_argument("--samp-freq", type=float, default=16000.0)
    p.add_argument("--dither", type=float, default=0.0)
    p.add_argument("--no-online-cmvn", action="store_true",
                   help="disable causal CMVN (for models trained on "
                        "un-normalized features)")
    p.add_argument("--host-decode", action="store_true")
    p.add_argument("--lattice-wspecifier", default=None,
                   help="also write lattices (npz): the accumulated "
                        "per-utterance loglikes are re-decoded through "
                        "the lattice path after streaming best-path "
                        "decode (ref: online2-wav-nnet2-latgen-faster "
                        "writes CompactLattices)")
    p.add_argument("--lattice-beam", type=float, default=8.0)
    p.add_argument("--lang-dir", required=True)
    p.add_argument("mdl")
    p.add_argument("graph_fst")
    p.add_argument("wav_scp")
    p.add_argument("out_text")
    args = p.parse_args(argv)

    words = SymbolTable.read(os.path.join(args.lang_dir, "words.txt"))
    tm, scorer, model_dim = _load_am(args.mdl)
    with open(args.graph_fst) as f:
        hclg = Fst.read_text(f)
    graph = CompiledGraph(hclg, tm.trans_id_to_pdf_array())

    if args.feature_type == "mfcc":
        opts = F.MfccOptions()
        base_dim = opts.num_ceps
    else:
        opts = F.FbankOptions()
        base_dim = opts.mel_opts.num_bins
    opts.frame_opts.samp_freq = args.samp_freq
    opts.frame_opts.dither = args.dither
    feat_dim = base_dim * (args.deltas_order + 1)
    context = 0
    if model_dim != feat_dim:
        if model_dim % feat_dim == 0 and (model_dim // feat_dim) % 2:
            context = (model_dim // feat_dim - 1) // 2
        else:
            print(f"online2-wav-latgen: model input dim {model_dim} is "
                  f"not an odd multiple of the feature dim {feat_dim}",
                  file=sys.stderr)
            return 2

    stream_dec = None
    if not args.host_decode:
        from kaldi_cnn_tpu.decode.topk_decoder import (TpuStreamingDecoder,
                                                       TpuTopKDecoder)
        dev_dec = TpuTopKDecoder(
            graph, beam=args.beam,
            max_active=args.max_active or graph.num_states,
            acoustic_scale=args.acoustic_scale)
        # ONE streaming decoder for the whole run: its per-frame jit
        # wrappers compile once; reset() clears token state between
        # utterances (constructing per-utterance re-traced the frame
        # kernel every time)
        stream_dec = TpuStreamingDecoder(dev_dec)

    class _AdvanceRecorder:
        """Records the loglike rows fed to a streaming decoder so the
        utterance can be re-decoded through the lattice path afterwards
        (the streaming kernel keeps no lattice records)."""

        def __init__(self, inner):
            object.__setattr__(self, "_inner", inner)
            object.__setattr__(self, "rows", [])

        def advance(self, ll):
            self.rows.append(np.asarray(ll, np.float32))
            self._inner.advance(ll)

        def __getattr__(self, name):
            return getattr(self._inner, name)

    scp = read_key_value_file(args.wav_scp)
    n_frames = 0
    utt_lls: Dict[str, np.ndarray] = {}
    t0 = time.perf_counter()
    with open(args.out_text, "w") as out:
        for utt in sorted(scp):
            wave, rate = load_wave(scp[utt])
            opts.frame_opts.samp_freq = rate   # like compute-*-feats:
            #                                    the file's actual rate
            cmvn = None
            if args.no_online_cmvn:
                from kaldi_cnn_tpu.online2 import OnlineCmvn
                cmvn = OnlineCmvn()
                cmvn.freeze(np.zeros(base_dim, np.float32))
            pipe = OnlineFeaturePipeline(args.feature_type, opts,
                                         cmvn=cmvn,
                                         deltas_order=args.deltas_order)
            fn = (StreamingSplicer(scorer, context, context)
                  if context else scorer)
            if stream_dec is not None:
                stream_dec.reset()
                dec = stream_dec
            else:
                dec = None
            if dec is not None or args.lattice_wspecifier:
                if dec is None:
                    from kaldi_cnn_tpu.online2.decoder import (
                        SingleUtteranceDecoder)
                    dec = SingleUtteranceDecoder(
                        graph, acoustic_scale=args.acoustic_scale,
                        beam=args.beam, max_active=args.max_active)
                if args.lattice_wspecifier:
                    dec = _AdvanceRecorder(dec)
                rec = OnlineRecognizer(graph, fn, pipeline=pipe,
                                       decoder=dec)
            else:
                rec = OnlineRecognizer(
                    graph, fn, pipeline=pipe,
                    acoustic_scale=args.acoustic_scale, beam=args.beam,
                    max_active=args.max_active)
            chunk = max(1, int(args.chunk_seconds * rate))
            for i in range(0, len(wave), chunk):
                rec.accept_waveform(wave[i:i + chunk])
            rec.input_finished()
            _, wids, _ = rec.result()
            n_frames += rec.decoder.num_frames if hasattr(
                rec.decoder, "num_frames") else 0
            if args.lattice_wspecifier:
                utt_lls[utt] = (np.concatenate(rec.decoder.rows)
                                if rec.decoder.rows
                                else np.zeros((0, 1), np.float32))
            text = " ".join(words.sym(int(w)) for w in wids)
            out.write(f"{utt} {text}".rstrip() + "\n")
    if args.lattice_wspecifier:
        from kaldi_cnn_tpu.decode.lattice import save_lattices
        if args.host_decode:
            from kaldi_cnn_tpu.decode.decoder import lattice_decode
            lats = {u: lattice_decode(
                graph, ll, acoustic_scale=args.acoustic_scale,
                beam=args.beam, lattice_beam=args.lattice_beam,
                max_active=args.max_active)
                for u, ll in utt_lls.items()}
        else:
            from kaldi_cnn_tpu.decode.topk_decoder import decode_utterances
            lats = decode_utterances(
                graph, utt_lls, acoustic_scale=args.acoustic_scale,
                beam=args.beam, lattice_beam=args.lattice_beam,
                max_active=args.max_active)
        save_lattices(args.lattice_wspecifier, lats)
    elapsed = time.perf_counter() - t0
    audio_s = n_frames / 100.0
    print(f"online2-wav-latgen: {len(scp)} utterances "
          f"({'host' if args.host_decode else 'device'} streaming path"
          + (f", {audio_s:.1f} audio-s in {elapsed:.2f}s, RTF "
             f"{elapsed / audio_s:.4f}" if audio_s else "") + ")",
          file=sys.stderr)
    return 0


def _load_am(mdl_path: str):
    """Sniff GMM vs am-nnet .mdl; return (trans_model,
    loglikes_fn(feats)->[T,num_pdfs], model_input_dim)."""
    from kaldi_cnn_tpu.io.kaldi_model import read_am_nnet, read_gmm_model
    try:
        tm, nnet, params, priors = read_am_nnet(mdl_path)
        from kaldi_cnn_tpu.models.nnet import AmNnet
        am = AmNnet(nnet, tm.num_pdfs)
        am.priors = np.asarray(priors, np.float64)
        return tm, lambda f: am.loglikes(params, f), nnet.input_dim
    except (ValueError, KeyError, EOFError):
        tm, am = read_gmm_model(mdl_path)
        return tm, am.loglikes, am.dim


TRAIN_VERBS = {
    "prepare-lang": cmd_prepare_lang,
    "compile-train-graphs": cmd_compile_train_graphs,
    "gmm-train-mono": cmd_gmm_train_mono,
    "gmm-align": cmd_gmm_align,
    "nnet-get-egs": cmd_nnet_get_egs,
    "nnet-train": cmd_nnet_train,
    "mkgraph": cmd_mkgraph,
    "latgen-faster": cmd_latgen_faster,
    "online2-wav-latgen": cmd_online2_wav_latgen,
}

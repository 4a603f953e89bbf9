"""VERDICT item 8 'done' criterion: a shell-only yesno pipeline
(features -> mono GMM -> align -> egs -> nnet train -> decode -> WER)
composed purely from CLI verbs, mirroring how the reference composes
its ~200 binaries from steps/*.sh."""

import os

import numpy as np
import pytest

from kaldi_cnn_tpu import cli
from kaldi_cnn_tpu.recipes import synthetic
from kaldi_cnn_tpu.recipes.datadir import write_data_dir, write_lexicon_file

pytestmark = pytest.mark.slow


def test_shell_only_yesno_pipeline(tmp_path, capsys):
    d = str(tmp_path)

    def p(name):
        return os.path.join(d, name)

    # -- data prep (the one non-shell step: corpus synthesis to disk)
    lex = synthetic.yesno_lexicon()
    wp = {"yes": 0.5, "no": 0.5}
    corpus = synthetic.make_corpus(lex, wp, 50, 1, 3, seed=23)
    train, test = corpus.split(0.2)
    write_data_dir(p("train"), train.waves, train.transcripts, None,
                   corpus.sample_rate)
    write_data_dir(p("test"), test.waves, test.transcripts, None,
                   corpus.sample_rate)
    write_lexicon_file(p("lexicon.txt"), lex)
    from kaldi_cnn_tpu.lang.arpa import make_unigram_arpa
    with open(p("unigram.arpa"), "w") as f:
        f.write(make_unigram_arpa(wp))

    # -- features (compute-mfcc-feats | add-deltas), both sets
    for part in ("train", "test"):
        assert cli.main([
            "compute-mfcc-feats", "--dither=0",
            os.path.join(p(part), "wav.scp"), p(f"{part}_mfcc.ark")]) == 0
        assert cli.main([
            "add-deltas", "--delta-order=2", p(f"{part}_mfcc.ark"),
            p(f"{part}_feats.ark"), f"--out-scp={p(f'{part}_feats.scp')}",
        ]) == 0

    # -- lang dir
    assert cli.main(["prepare-lang", p("lexicon.txt"), p("lang")]) == 0
    assert os.path.isfile(p("lang/words.txt"))

    # -- mono GMM flat-start EM
    assert cli.main([
        "gmm-train-mono", "--num-iters=18", "--totgauss=300",
        p("lang"), p("train_feats.scp"),
        os.path.join(p("train"), "text"),
        p("mono.mdl"), p("ali0.ark")]) == 0

    # -- compile training graphs + realign with the trained model
    assert cli.main([
        "compile-train-graphs", p("lang"),
        os.path.join(p("train"), "text"), p("graphs.txt")]) == 0
    assert cli.main([
        "gmm-align", "--beam=200", p("mono.mdl"), p("graphs.txt"),
        p("train_feats.scp"), p("ali.ark")]) == 0

    # -- egs + nnet train
    assert cli.main([
        "nnet-get-egs", "--left-context=4", "--right-context=4",
        p("mono.mdl"), p("train_feats.scp"), p("ali.ark"),
        p("egs.npz")]) == 0
    assert cli.main([
        "nnet-train", "--num-epochs=12", "--minibatch-size=128",
        "--initial-learning-rate=0.04", "--final-learning-rate=0.004",
        "--num-hidden-layers=1", "--pnorm-input-dim=200",
        "--pnorm-output-dim=40",
        p("mono.mdl"), p("egs.npz"), p("am.mdl")]) == 0

    # -- graph + decode (nnet input is spliced +-4 like its egs)
    assert cli.main(["mkgraph", p("lang"), p("unigram.arpa"),
                     p("HCLG.txt")]) == 0
    assert cli.main([
        "splice-feats", "--left-context=4", "--right-context=4",
        p("test_feats.ark"), p("test_spliced.ark"),
        f"--out-scp={p('test_spliced.scp')}"]) == 0
    assert cli.main([
        "latgen-faster", "--beam=1e9", "--max-active=0",
        "--acoustic-scale=0.1", f"--lang-dir={p('lang')}",
        p("am.mdl"), p("HCLG.txt"), p("test_spliced.scp"),
        p("lats.npz"), p("hyp.txt")]) == 0

    # -- score
    assert cli.main([
        "compute-wer", os.path.join(p("test"), "text"),
        p("hyp.txt")]) == 0
    out = capsys.readouterr().out
    wer_line = [ln for ln in out.splitlines() if ln.startswith("%WER")][-1]
    wer = float(wer_line.split()[1])
    assert wer <= 25.0, wer_line

    # GMM decode path through the same verb (model sniffing)
    assert cli.main([
        "latgen-faster", "--beam=1e9", "--max-active=0",
        "--acoustic-scale=1.0", f"--lang-dir={p('lang')}",
        p("mono.mdl"), p("HCLG.txt"), p("test_feats.scp"),
        p("lats_gmm.npz"), p("hyp_gmm.txt")]) == 0
    assert cli.main([
        "compute-wer", os.path.join(p("test"), "text"),
        p("hyp_gmm.txt")]) == 0
    out = capsys.readouterr().out
    wer_line = [ln for ln in out.splitlines() if ln.startswith("%WER")][-1]
    assert float(wer_line.split()[1]) <= 25.0, wer_line


def test_online2_wav_latgen_verb(tmp_path, capsys):
    """Streaming CLI decode (online2-wav-nnet2-latgen-faster analogue):
    wav.scp in, transcripts out, through the chunked online recognizer
    with the spliced nnet AM — WER must match the offline verb's
    ballpark on the same corpus."""
    d = str(tmp_path)

    def p(name):
        return os.path.join(d, name)

    lex = synthetic.yesno_lexicon()
    wp = {"yes": 0.5, "no": 0.5}
    corpus = synthetic.make_corpus(lex, wp, 40, 1, 3, seed=29)
    train, test = corpus.split(0.25)
    write_data_dir(p("train"), train.waves, train.transcripts, None,
                   corpus.sample_rate)
    write_data_dir(p("test"), test.waves, test.transcripts, None,
                   corpus.sample_rate)
    write_lexicon_file(p("lexicon.txt"), lex)
    from kaldi_cnn_tpu.lang.arpa import make_unigram_arpa
    with open(p("unigram.arpa"), "w") as f:
        f.write(make_unigram_arpa(wp))
    assert cli.main([
        "compute-mfcc-feats", "--dither=0",
        os.path.join(p("train"), "wav.scp"), p("train_mfcc.ark")]) == 0
    assert cli.main([
        "add-deltas", "--delta-order=2", p("train_mfcc.ark"),
        p("train_feats.ark"),
        f"--out-scp={p('train_feats.scp')}"]) == 0
    assert cli.main(["prepare-lang", p("lexicon.txt"), p("lang")]) == 0
    assert cli.main([
        "gmm-train-mono", "--num-iters=14", "--totgauss=200",
        p("lang"), p("train_feats.scp"),
        os.path.join(p("train"), "text"),
        p("mono.mdl"), p("ali0.ark")]) == 0
    assert cli.main(["mkgraph", p("lang"), p("unigram.arpa"),
                     p("HCLG.txt")]) == 0
    # GMM features are mfcc+deltas == the online pipeline's output, so
    # the verb streams with no splice; host + device streaming paths
    for tag, extra in (("host", ["--host-decode"]), ("device", [])):
        assert cli.main([
            "online2-wav-latgen", "--beam=200", "--max-active=0",
            "--acoustic-scale=1.0", f"--lang-dir={p('lang')}",
            "--no-online-cmvn",  # the GMM trained on raw mfcc+deltas
            f"--lattice-wspecifier={p('lats_' + tag + '.npz')}",
            *extra, p("mono.mdl"), p("HCLG.txt"),
            os.path.join(p("test"), "wav.scp"),
            p(f"hyp_{tag}.txt")]) == 0
        assert cli.main([
            "compute-wer", os.path.join(p("test"), "text"),
            p(f"hyp_{tag}.txt")]) == 0
        out = capsys.readouterr().out
        wer_line = [ln for ln in out.splitlines()
                    if ln.startswith("%WER")][-1]
        assert float(wer_line.split()[1]) <= 25.0, (tag, wer_line)
        # the verb now also emits real lattices (ADVICE round-3: the
        # reference tool writes CompactLattices, not just one-best);
        # each lattice's best path must reproduce the streamed one-best
        from kaldi_cnn_tpu.decode.lattice import (load_lattices,
                                                  shortest_path)
        from kaldi_cnn_tpu.lang.symbols import SymbolTable
        words = SymbolTable.read(p("lang") + "/words.txt")
        lats = load_lattices(p(f"lats_{tag}.npz"))
        hyps = dict(ln.split(None, 1) if " " in ln else (ln, "")
                    for ln in open(p(f"hyp_{tag}.txt"))
                    .read().splitlines())
        assert set(lats) == set(hyps), tag
        for utt, lat in lats.items():
            _, wids, _ = shortest_path(lat, 1.0, 1.0)
            txt = " ".join(words.sym(int(w)) for w in wids)
            assert txt == hyps[utt].strip(), (tag, utt)

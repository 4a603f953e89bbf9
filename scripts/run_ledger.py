"""The WER ledger runs behind RESULTS.md, one recipe after another in
ONE process (a second JAX process on the card would fail for want of
memory).  Results accumulate in chiprun_out/ledger.json under the
checkout.

Usage: python scripts/run_ledger.py [step ...]
  steps: wsj rm swbd swbd_pitch librispeech (default: all)
"""
import json
import os
import sys
import time

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "chiprun_out", "ledger.json")


def _load():
    try:
        with open(OUT) as f:
            return json.load(f)
    except Exception:
        return {}


def _save(d):
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(d, f, indent=1, default=str)


def _clean(res):
    return {k: v for k, v in res.items() if not isinstance(v, dict)}


def main():
    steps = sys.argv[1:] or ["wsj", "rm", "swbd", "swbd_pitch",
                             "librispeech"]
    import jax
    from kaldi_cnn_tpu.core.backend import setup_compile_cache
    setup_compile_cache()
    print("backend:", jax.default_backend(), flush=True)
    out = _load()
    for step in steps:
        t0 = time.time()
        print(f"=== {step} ===", flush=True)
        if step == "wsj":
            from kaldi_cnn_tpu.recipes import wsj
            res = wsj.run(eval_dnn=True, eval_utts=600)
        elif step == "rm":
            from kaldi_cnn_tpu.recipes import rm
            res = rm.run(eval_utts=900)
        elif step == "swbd":
            from kaldi_cnn_tpu.recipes import swbd
            res = swbd.run(eval_utts_per_speaker=34)
        elif step == "swbd_pitch":
            from kaldi_cnn_tpu.recipes import swbd
            res = swbd.run(eval_utts_per_speaker=34, use_pitch=True)
        elif step == "librispeech":
            from kaldi_cnn_tpu.recipes import librispeech
            res = librispeech.run(eval_utts=800)
        else:
            raise SystemExit(f"unknown step {step}")
        res = _clean(res)
        res["wall_s"] = round(time.time() - t0, 1)
        out[step] = res
        _save(out)
        print(step, "->", json.dumps(res, default=str), flush=True)
    print("ALL DONE", flush=True)


if __name__ == "__main__":
    main()

"""chip_smoke.py on the CPU: the script refuses to run without a GPU,
its train/score and decode phases pass their own comparisons at a tiny
width, and its update comparison tells a per-leaf factor, rounding and
a wrong entry apart."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]


def _load():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_device_phase_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_train_and_score_phases_tiny():
    from kaldi_cnn_tpu.models.factory import ConvnetConfig
    cs = _load()
    cfg = ConvnetConfig(in_t=5, in_f=10, in_c=2, filt_t=2, filt_f=3,
                        num_filters=8, pool_t=2, pool_f=2, pool_c=1,
                        num_hidden_layers=1, pnorm_input_dim=32,
                        pnorm_output_dim=8, num_pdfs=6)
    report, (net, params) = cs.phase_train(cfg, minibatch=64, groups=3,
                                           scan_steps=4)
    objfs = report["objf_per_group"]
    assert len(objfs) == 3 and objfs[-1] > objfs[0]
    assert report["steps"] == 12
    assert report["step_objf_rel_diff"] <= 1e-2
    score, _ = cs.phase_score(net, params, frames=96, utt_frames=32,
                              cpu_frames=16)
    assert score["frames"] == 96
    assert score["argmax_agreement"] >= 0.99


def test_decode_phase_tiny():
    cs = _load()
    report, _ = cs.phase_decode(num_words=300, num_pdfs=32, batch=4,
                                frames=40, stream_frames=150, chunk=16,
                                max_active=512, host_check=2)
    assert report["overflow_arcs"] == 0
    assert report["host_checked_utts"] == 2
    assert report["stream_words"] > 0


def test_update_diffs_separates_scale_and_rounding():
    cs = _load()
    rng = np.random.default_rng(0)
    p0 = ({"w": rng.normal(size=(8, 5)).astype(np.float32)}, {})
    u = rng.normal(size=(8, 5)) * 1e-2
    pb = ({"w": (p0[0]["w"] + u).astype(np.float32)}, {})
    # the same update, scaled by 1.1: all of it is a per-leaf factor
    pa = ({"w": (p0[0]["w"] + 1.1 * u).astype(np.float32)}, {})
    upd, dirn = cs._update_diffs(p0, pa, pb)
    assert upd["0.w"] == pytest.approx(0.1, rel=1e-2)
    assert dirn["0.w"] < 1e-4
    # one spacing of the new weight is rounding, not a difference
    pc = ({"w": np.nextafter(pb[0]["w"], np.inf)}, {})
    upd, dirn = cs._update_diffs(p0, pc, pb)
    assert upd["0.w"] == 0.0 and dirn["0.w"] < 1e-4
    # a wrong update in one entry shows in both
    pd = ({"w": pb[0]["w"].copy()}, {})
    pd[0]["w"][3, 2] -= 2 * u[3, 2]
    upd, dirn = cs._update_diffs(p0, pd, pb)
    assert upd["0.w"] > 0.1 and dirn["0.w"] > 0.1

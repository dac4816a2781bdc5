"""chip_smoke.py: each phase at tiny widths on the CPU, and its contract.

On the CPU the device under test and the reference are the same device,
so every comparison must come out exact; what these tests check is that
each phase drives its tools end to end and checks what they produce.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)  # chip_smoke.py and bench.py live at the root

import chip_smoke as cs  # noqa: E402


@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    cpu = jax.devices("cpu")[0]
    return cs.Ctx(str(tmp_path_factory.mktemp("smoke")), cs.TINY, 0, cpu,
                  cpu)


@pytest.fixture(scope="module")
def hvite_out(ctx):
    return cs.phase_hvite(ctx)


@pytest.fixture(scope="module")
def hdecode_out(ctx):
    return cs.phase_hdecode(ctx)


def _exact(r):
    assert r["max_dev"] == 0.0 and r["max_dev"] <= r["tol"]
    assert r["compile_s"] >= 0.0 and "run_s" in r


def test_phase_hcopy(ctx):
    _exact(cs.phase_hcopy(ctx))


def test_phase_herest(ctx):
    r = cs.phase_herest(ctx)
    _exact(r)
    assert r["logp_dev"] == 0.0
    assert r["logp_per_frame"][1] > r["logp_per_frame"][0]


def test_phase_hvite(ctx, hvite_out):
    _exact(hvite_out)
    recs = cs._mlf_entries(os.path.join(ctx.work, "v1k", "rec_dev.mlf"))
    assert len(recs) == ctx.w.n_utts


def test_phase_hdecode(ctx, hdecode_out):
    _exact(hdecode_out)
    lats = os.listdir(os.path.join(ctx.work, "d5k", "lat_dev"))
    assert sorted(lats) == sorted(f"d5k{i:02d}.lat"
                                  for i in range(ctx.w.n_utts))


def test_phase_hmmirest(ctx, hdecode_out):
    r = cs.phase_hmmirest(ctx)
    _exact(r)
    assert r["criterion"] == r["criterion"]  # a number, not NaN


def test_phase_hresults(ctx, hvite_out, hdecode_out):
    r = cs.phase_hresults(ctx)
    for tag in ("v1k", "d5k"):
        assert r[tag].startswith("WORD: %Corr=")


def test_phase_four_cards_on_virtual_devices(tmp_path):
    """The ShardedTrainer over every visible device (the tests' virtual
    CPU mesh) against the unsharded trainer."""
    cpu = jax.devices("cpu")[0]
    w = cs.Widths(n_utts=len(jax.devices()), n_ref=2, secs=0.6, n_phones=6,
                  nmix=2, n_tied=24, vocab_hvite=12, vocab_hdecode=16)
    r = cs.phase_four_cards(cs.Ctx(str(tmp_path), w, 0, cpu, cpu))
    assert r["n_devices"] == len(jax.devices()) > 1
    assert r["n_utts"] == w.n_utts
    assert r["max_dev"] <= r["tol"] and r["logp_dev"] <= r["logp_tol"]


def test_outp_highest_matches_float64(ctx):
    e = cs.outp_errors(ctx)["errors"]
    assert set(e) == {"highest", "high", "default"}
    assert e["highest"]["max_rel"] < 1e-5


def test_result_line_contract():
    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = cs.result_line([Dev(), Dev(), Dev(), Dev()])
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert "\n" not in line


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_exits_nonzero_without_a_gpu():
    r = _run_smoke(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_exits_nonzero_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout

"""``chip_smoke.py`` on the CPU: its comparison helper and bar, its exact
last line, its refusal to run without a GPU, and every phase rehearsed at a
tiny size (the references agree with the routes here too)."""

import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("got,ref,ok", [
    (np.array([1.0, 2.0 + 1e-5]), np.array([1.0, 2.0]), True),
    (np.array([1.0, 2.01]), np.array([1.0, 2.0]), False),
    (np.array([1.0, np.nan]), np.array([1.0, 2.0]), False),
    (np.ones(3), np.ones(2), False),
])
def test_compare_bar_is_relative_to_the_reference(got, ref, ok):
    line, passed = chip_smoke.compare("x", got, ref, 1e-4)
    assert passed is ok
    assert line.startswith("x: ")


def test_compare_f32_bar_rises_to_ten_times_the_cpu_floor():
    ref = np.array([100.0, 0.0])
    got = ref + np.array([0.05, 0.0])           # 5e-4 of max|ref|
    line, ok = chip_smoke.compare_f32("x", got, ref, ref)
    assert not ok                               # bar 1e-2: exact CPU twin
    line, ok = chip_smoke.compare_f32("x", got, ref + 0.01, ref)
    assert ok and "tol=1.000e-01" in line       # 10 x the CPU's 1e-2


def test_tf32_product_fails_the_f32_bar():
    """A product rounded like TF32 (10-bit mantissa) lands far above the
    bar that a float32 product passes."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 64)).astype(np.float32)
    b = rng.standard_normal((64, 64)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)

    def tf32(x):
        bits = x.view(np.uint32) & np.uint32(0xFFFFE000)
        return bits.view(np.float32)

    f32 = a @ b
    low = tf32(a).astype(np.float64) @ tf32(b).astype(np.float64)
    assert chip_smoke.compare_f32("f32", f32, f32, ref)[1]
    assert not chip_smoke.compare_f32("tf32", low, f32, ref)[1]


def test_result_line_is_exact():
    dev = types.SimpleNamespace(platform="gpu",
                                device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line([dev])
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_refuses_without_a_gpu(monkeypatch, capsys, argv):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert chip_smoke.main(argv) != 0
    captured = capsys.readouterr()
    assert '"ok"' not in captured.out
    assert "no GPU" in captured.err


def test_script_alone_in_a_directory_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.fixture(scope="module")
def reference_lines():
    return chip_smoke.reference_checks(32, 16)


@pytest.mark.parametrize("group", ["score", "gsm dense", "factor_gsm chol",
                                   "factor_gsm ns", "bam dense",
                                   "bam lowrank", "factor_bam eigh",
                                   "factor_bam svd", "advi grad"])
def test_reference_checks_pass_on_cpu(reference_lines, group):
    lines = [(line, ok) for line, ok in reference_lines
             if line.startswith(group + " ") or line.startswith(group + ":")]
    assert lines
    assert all(ok for _, ok in lines), [line for line, _ in lines]


def test_indefinite_proposal_is_reverted_on_cpu():
    line, ok = chip_smoke.indefinite_revert_check(16)
    assert ok, line


@pytest.fixture(scope="module")
def fit_lines():
    return chip_smoke.fit_checks(16, 16, niter=300, advi_niter=200,
                                 batch_d=8, batch_k=3, batch_niter=200)


@pytest.mark.parametrize("fit", ["gsm dense", "gsm factor", "bam dense",
                                 "bam factor", "advi",
                                 "factor_gsm fit_batch"])
def test_fit_checks_pass_on_cpu(fit_lines, fit):
    lines = [(line, ok) for line, ok in fit_lines
             if line.startswith(f"fit {fit} ")]
    assert len(lines) == 1
    assert lines[0][1], lines[0][0]


def test_four_card_phase_on_virtual_devices(eight_devices):
    lines = chip_smoke.four_checks(n_dev=4, d=16, b=8, niter=5, d_model=32)
    bad = [line for line, ok in lines if not ok]
    assert not bad, bad
    assert any("cov on 4 devices" in line for line, _ in lines)


def test_gpu_fixture_skips_on_the_cpu(request):
    """The ``chip`` tests decide in the ``gpu`` fixture, at run time, never
    at import: here it must skip."""
    with pytest.raises(pytest.skip.Exception, match="needs a GPU"):
        request.getfixturevalue("gpu")

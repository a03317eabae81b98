"""Smoke the fastest example scripts end-to-end (the public-surface spec).

Only the sub-second-per-iteration configs run here; the slower examples are
exercised piecewise by the fitter tests (PARITY.md C14).
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("script", ["example_gsm.py", "example_gsm_numpy.py"])
def test_example_runs_and_recovers(script):
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", script)],
        capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "mean error" in out.stdout


@pytest.mark.parametrize("script,marker", [
    ("example_factor.py", "FactorBaM  cov err"),
    ("example_fit_batch.py", "replicas fit in one compiled program"),
    ("example_zoo.py", "logreg_d32_n128"),
    ("example_advi.py", "(STL polish)"),
])
def test_example_runs(script, marker):
    """The factor, fit_batch, zoo and ADVI examples run to their last line
    on the public surface alone."""
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", script)],
        capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert marker in out.stdout

"""Tests that need an NVIDIA GPU (marker ``chip``; they skip elsewhere).

Run on the card with::

    JAX_PLATFORMS=cuda,cpu python -m pytest -m chip tests/test_gpu_hardware.py

At D=256 they repeat ``chip_smoke.py``'s reference comparisons (each route's
float32 step on the GPU against float64 numpy), the revert of an indefinite
proposal on the device's Cholesky, and one converging fit per fitter.
"""

import pytest

import chip_smoke

pytestmark = pytest.mark.chip

D, B = 256, 32

REFERENCE_GROUPS = ["score", "gsm dense", "factor_gsm chol", "factor_gsm ns",
                    "bam dense", "bam lowrank", "factor_bam eigh",
                    "factor_bam svd", "advi grad"]
FITS = ["gsm dense", "gsm factor", "bam dense", "bam factor", "advi",
        "factor_gsm fit_batch"]


@pytest.fixture(scope="module")
def reference_lines():
    return chip_smoke.reference_checks(D, B)


@pytest.fixture(scope="module")
def fit_lines():
    return chip_smoke.fit_checks(D, B, niter=1000, advi_niter=400,
                                 batch_d=64, batch_k=8, batch_niter=400)


@pytest.mark.parametrize("group", REFERENCE_GROUPS)
def test_reference_step_matches_float64(gpu, reference_lines, group):
    lines = [(line, ok) for line, ok in reference_lines
             if line.startswith(group + " ") or line.startswith(group + ":")]
    assert lines, f"no comparison named {group!r}"
    bad = [line for line, ok in lines if not ok]
    assert not bad, "\n".join(bad)


def test_indefinite_proposal_is_reverted(gpu):
    line, ok = chip_smoke.indefinite_revert_check(D)
    assert ok, line


@pytest.mark.parametrize("fit", FITS)
def test_fit_converges(gpu, fit_lines, fit):
    lines = [(line, ok) for line, ok in fit_lines
             if line.startswith(f"fit {fit} ")]
    assert len(lines) == 1, fit_lines
    assert lines[0][1], lines[0][0]

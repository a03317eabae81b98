"""Pin our kernels against the ACTUAL reference implementation.

Every other oracle in this suite is independently re-derived from the papers;
these tests close the remaining gap by feeding identical ``(samples, vs, mu0,
S0[, reg])`` into the reference's own jitted kernels (``gsmvi/gsm.py:31-58``
``gsm_update`` and ``gsmvi/bam.py:31-69`` ``bam_update``, CPU/x64 path) and
asserting agreement with ``ops/gsm.py`` / ``ops/bam.py`` to f64 precision.
An error in a *shared misreading* of the papers cannot slip past this.

The reference tree (read-only at ``/root/reference``) targets an older jax; a
minimal ``jax.lib.xla_bridge`` shim (removed in jax>=0.5, used by the
reference only to query the backend platform at ``gsmvi/bam.py:20``) makes it
importable.  Tests skip gracefully when the tree is absent.

The reference's *low-rank* BaM kernel cannot run here: its
``scipy.sparse.linalg.svds`` host callback (``gsmvi/bam.py:10-17``) crashes
against current scipy/jax ("type not understood" from ``aslinearoperator``) —
an upstream incompatibility in the reference itself.  Our low-rank kernel is
instead pinned transitively: ``tests/test_bam_kernels.py`` proves it equal to
our full-rank kernel, which this file pins to the reference's full-rank one.
"""

import os
import sys
import types

import numpy as np
import pytest

REF = "/root/reference"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(os.path.join(REF, "gsmvi")),
    reason="reference tree not mounted",
)


@pytest.fixture(scope="module")
def ref_mod():
    """Import the reference package with the xla_bridge compat shim."""
    import jax

    if "jax.lib.xla_bridge" not in sys.modules:
        shim = types.ModuleType("jax.lib.xla_bridge")

        class _Backend:
            platform = jax.default_backend()

        shim.get_backend = lambda: _Backend()
        sys.modules["jax.lib.xla_bridge"] = shim
        import jax.lib

        jax.lib.xla_bridge = shim
    sys.path.insert(0, REF)
    try:
        import gsmvi.bam as ref_bam
        import gsmvi.gsm as ref_gsm
        import gsmvi.gsm_numpy as ref_gsm_numpy
    finally:
        sys.path.remove(REF)
    return types.SimpleNamespace(gsm=ref_gsm, bam=ref_bam,
                                 gsm_numpy=ref_gsm_numpy)


def _spd(rng, d, scale=0.3):
    l = scale * rng.normal(size=(d, d))
    return l @ l.T + np.eye(d)


@pytest.mark.parametrize("b,d", [(2, 5), (8, 16), (32, 48), (1, 7)])
def test_gsm_update_matches_reference(ref_mod, rng, b, d):
    x = rng.normal(size=(b, d))
    v = rng.normal(size=(b, d))
    mu0 = rng.normal(size=d)
    s0 = _spd(rng, d)

    from gsmvi_jax.ops.gsm import gsm_update

    m_ref, s_ref = ref_mod.gsm.gsm_update(x, v, mu0, s0)
    m, s = gsm_update(x, v, mu0, s0)
    np.testing.assert_allclose(np.asarray(m), np.asarray(m_ref),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(np.asarray(s), np.asarray(s_ref),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("b,d,reg", [(2, 5, 100.0), (8, 16, 0.5),
                                     (32, 48, 5.0), (4, 12, 0.01)])
def test_bam_update_matches_reference(ref_mod, rng, b, d, reg):
    x = rng.normal(size=(b, d))
    v = rng.normal(size=(b, d))
    mu0 = rng.normal(size=d)
    s0 = _spd(rng, d)

    from gsmvi_jax.ops.bam import bam_update

    m_ref, s_ref = ref_mod.bam.bam_update(x, v, mu0, s0, reg)
    # jitter=0 to match; the reference applies its jitter on the host after
    # the update (gsmvi/bam.py:198), outside the kernel under test.
    m, s = bam_update(x, v, mu0, s0, reg, jitter=0.0, sqrt_method="eigh")
    np.testing.assert_allclose(np.asarray(m), np.asarray(m_ref),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(s), np.asarray(s_ref),
                               rtol=1e-9, atol=1e-9)


def test_lowrank_matches_reference_fullrank_transitively(ref_mod, rng):
    """Our low-rank kernel vs the reference FULL-rank kernel directly.

    (The reference low-rank kernel itself cannot run — see module docstring —
    but when B >= D both variants solve the same equation exactly, so the
    full-rank reference pins our low-rank path without the broken callback.)
    """
    b, d, reg = 16, 6, 2.0  # b + 1 > d: U is full rank, paths coincide
    x = rng.normal(size=(b, d))
    v = rng.normal(size=(b, d))
    mu0 = rng.normal(size=d)
    s0 = _spd(rng, d)

    from gsmvi_jax.ops.bam import bam_lowrank_update

    m_ref, s_ref = ref_mod.bam.bam_update(x, v, mu0, s0, reg)
    m, s = bam_lowrank_update(x, v, mu0, s0, reg, jitter=0.0,
                              sqrt_method="eigh")
    np.testing.assert_allclose(np.asarray(m), np.asarray(m_ref),
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(np.asarray(s), np.asarray(s_ref),
                               rtol=1e-8, atol=1e-8)


def test_gsm_numpy_update_matches_reference(ref_mod, rng):
    """Our zero-dep numpy twin vs the reference's numpy twin."""
    b, d = 6, 9
    x = rng.normal(size=(b, d))
    v = rng.normal(size=(b, d))
    mu0 = rng.normal(size=d)
    s0 = _spd(rng, d)

    from gsmvi_jax.compat.gsm_numpy import gsm_update as np_gsm_update

    m_ref, s_ref = ref_mod.gsm_numpy.gsm_update(x, v, mu0, s0)
    m, s = np_gsm_update(x, v, mu0, s0)
    np.testing.assert_allclose(m, m_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(s, s_ref, rtol=1e-12, atol=1e-12)

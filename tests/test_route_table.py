"""Route selection: what "auto" resolves to, and the options that are gone.

Every fitter picks its route from its arguments and the input shapes alone;
the platform JAX runs on plays no part.  The options whose only effect was a
device-specific kernel no longer exist: passing one raises ``TypeError``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsmvi_jax import ADVI, BaM, FactorBaM, FactorGSM, GSM, Regularizers
from gsmvi_jax.models import dense_gaussian


@pytest.fixture(scope="module")
def target():
    return dense_gaussian(jax.random.PRNGKey(7), 6, scale=0.5)


def _fake_devices(platform, kind):
    dev = types.SimpleNamespace(platform=platform, device_kind=kind, id=0)
    return lambda *a, **k: [dev]


PLATFORMS = [("cpu", "cpu"), ("gpu", "NVIDIA H100 80GB HBM3"),
             ("rocm", "AMD Instinct MI300X")]


@pytest.mark.parametrize("platform,kind", PLATFORMS)
def test_gsm_auto_resolves_to_dense_on_every_platform(monkeypatch, target,
                                                      platform, kind):
    monkeypatch.setattr(jax, "devices", _fake_devices(platform, kind))
    g = GSM(D=target.d, lp=target.lp, lp_g=target.lp_g)
    assert g.use_factor == "auto"
    assert not g._factor_route(True, 8)
    assert GSM(D=target.d, lp=target.lp, lp_g=target.lp_g,
               use_factor=True)._factor_route(True, 8)


@pytest.mark.parametrize("platform,kind", PLATFORMS)
def test_bam_auto_resolves_to_dense_eigh_on_every_platform(
        monkeypatch, target, platform, kind):
    monkeypatch.setattr(jax, "devices", _fake_devices(platform, kind))
    g = BaM(D=target.d, lp=target.lp, lp_g=target.lp_g)
    assert g.sqrt_method == "eigh"
    assert not g._factor_route(True)
    assert BaM(D=target.d, lp=target.lp, lp_g=target.lp_g,
               use_factor=True)._factor_route(True)


@pytest.mark.parametrize("platform,kind", PLATFORMS)
def test_factor_gsm_auto_solver_is_platform_free(monkeypatch, target,
                                                 platform, kind):
    """fit runs the exact Cholesky eps step, fit_batch the Newton-Schulz
    step (f32) — whatever the platform reports."""
    monkeypatch.setattr(jax, "devices", _fake_devices(platform, kind))
    g = FactorGSM(D=target.d, lp=target.lp, lp_g=target.lp_g,
                  dtype=jnp.float32)
    assert g.method == "eps"
    assert g._iters(8) == g._iters(32) != g._iters(64)


def test_auto_trajectories_match_explicit_dense(target):
    """"auto" and use_factor=False run the identical dense step."""
    t = target
    kw = dict(niter=50, batch_size=8, verbose=False)
    m_a, c_a = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g).fit(jax.random.PRNGKey(0),
                                                    **kw)
    m_d, c_d = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g, use_factor=False).fit(
        jax.random.PRNGKey(0), **kw)
    np.testing.assert_array_equal(np.asarray(m_a), np.asarray(m_d))
    np.testing.assert_array_equal(np.asarray(c_a), np.asarray(c_d))
    regf = Regularizers().linear(20.0)
    m_a, _ = BaM(D=t.d, lp=t.lp, lp_g=t.lp_g).fit(
        jax.random.PRNGKey(0), regf, **kw)
    m_d, _ = BaM(D=t.d, lp=t.lp, lp_g=t.lp_g, use_factor=False,
                 sqrt_method="eigh").fit(jax.random.PRNGKey(0), regf, **kw)
    np.testing.assert_array_equal(np.asarray(m_a), np.asarray(m_d))


REMOVED_INIT_KWARGS = [
    (GSM, "use_pallas", True),
    (GSM, "pallas_score", None),
    (BaM, "pallas_score", None),
    (FactorGSM, "use_pallas", "auto"),
    (FactorGSM, "pallas_score", None),
    (FactorGSM, "steps_per_call", 8),
    (FactorBaM, "use_pallas", "auto"),
    (FactorBaM, "pallas_score", None),
    (FactorBaM, "steps_per_call", 8),
    (FactorBaM, "lmax_gate", 1e4),
    (FactorBaM, "gu_gate", 5e4),
    (FactorBaM, "ns_iters", (20, 13, 16, 11, 6)),
    (FactorBaM, "ns_profile", "auto"),
]


@pytest.mark.parametrize("cls,kwarg,value", REMOVED_INIT_KWARGS,
                         ids=[f"{c.__name__}-{k}"
                              for c, k, _ in REMOVED_INIT_KWARGS])
def test_removed_constructor_kwarg_raises(target, cls, kwarg, value):
    with pytest.raises(TypeError, match=kwarg):
        cls(D=target.d, lp=target.lp, lp_g=target.lp_g, **{kwarg: value})


@pytest.mark.parametrize("kwarg,value", [("pallas_score", None),
                                         ("steps_per_call", 8)])
def test_removed_advi_kwarg_raises(target, kwarg, value):
    with pytest.raises(TypeError, match=kwarg):
        ADVI(D=target.d, lp=target.lp, **{kwarg: value})


@pytest.mark.parametrize("cls", [FactorGSM, FactorBaM])
def test_removed_audit_every_raises(target, cls):
    g = cls(D=target.d, lp=target.lp, lp_g=target.lp_g)
    args = (Regularizers().linear(20.0),) if cls is FactorBaM else ()
    with pytest.raises(TypeError, match="audit_every"):
        g.fit(jax.random.PRNGKey(0), *args, niter=2, batch_size=4,
              verbose=False, audit_every=1)


def test_removed_fit_fused_method(target):
    assert not hasattr(ADVI(D=target.d, lp=target.lp), "fit_fused")


def test_targets_carry_no_kernel_score(target):
    assert not hasattr(target, "pallas_score")

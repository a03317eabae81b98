"""GSM update kernel: fused Gram-matrix form vs independent per-sample math.

The oracle below is written directly from the GSM paper's closed-form update
(arXiv:2307.07849, eqs. for rho / mean / covariance) in plain numpy, per
sample, and pins down the fused kernel the same way the reference's numpy twin
pins its jax kernel (SURVEY.md §4b).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsmvi_jax.ops.gsm import gsm_update, gsm_update_lowmem, gsm_update_stats


def oracle_single(x, v, mu0, S0):
    """Per-sample GSM update straight from the paper (numpy, no batching)."""
    d = x.shape[0]
    S0v = S0 @ v
    rho = 0.5 * np.sqrt(1 + 4 * (v @ S0v + ((mu0 - x) @ v) ** 2)) - 0.5
    eps0 = S0v - mu0 + x
    den = 1 + rho + (mu0 - x) @ v
    dmu = (np.eye(d) - np.outer(mu0 - x, v) / den) @ eps0 / (1 + rho)
    mu = mu0 + dmu
    ds = np.outer(mu0 - x, mu0 - x) - np.outer(mu - x, mu - x)
    return dmu, ds


def oracle_batch(x, v, mu0, S0):
    outs = [oracle_single(x[i], v[i], mu0, S0) for i in range(x.shape[0])]
    dmu = np.mean([o[0] for o in outs], axis=0)
    ds = np.mean([o[1] for o in outs], axis=0)
    return mu0 + dmu, S0 + ds


def random_problem(rng, d, b, scale=1.0):
    mu0 = rng.normal(size=d)
    l = rng.normal(size=(d, d)) * scale
    s0 = l @ l.T + np.eye(d)
    x = rng.normal(size=(b, d))
    v = rng.normal(size=(b, d))
    return x, v, mu0, s0


@pytest.mark.parametrize("d,b", [(3, 1), (7, 2), (16, 8), (33, 5)])
def test_fused_matches_oracle(rng, d, b):
    x, v, mu0, s0 = random_problem(rng, d, b)
    mu_ref, s_ref = oracle_batch(x, v, mu0, s0)
    mu, s = gsm_update(x, v, mu0, s0)
    np.testing.assert_allclose(mu, mu_ref, atol=1e-10)
    np.testing.assert_allclose(s, s_ref, atol=1e-10)


def test_lowmem_blocked_matches(rng):
    x, v, mu0, s0 = random_problem(rng, 9, 13)
    mu_ref, s_ref = gsm_update(x, v, mu0, s0)
    mu, s = gsm_update_lowmem(x, v, mu0, s0, 4)
    np.testing.assert_allclose(mu, mu_ref, atol=1e-10)
    np.testing.assert_allclose(s, s_ref, atol=1e-10)


def test_output_exactly_symmetric(rng):
    x, v, mu0, s0 = random_problem(rng, 24, 6)
    _, s = gsm_update(x, v, mu0, s0)
    assert float(jnp.max(jnp.abs(s - s.T))) == 0.0


def test_fixed_point_on_true_target(rng):
    """If q == target, the expected GSM update vanishes; for samples AT the
    mean with matching scores the update must keep parameters finite and the
    symmetric structure intact (per-sample updates are zero only in
    expectation)."""
    d = 6
    mu = rng.normal(size=d)
    l = rng.normal(size=(d, d))
    cov = l @ l.T + np.eye(d)
    prec = np.linalg.inv(cov)
    # Large batch of target samples with exact scores: update ~ 0 by LLN.
    b = 200_000
    x = rng.multivariate_normal(mu, cov, size=b)
    v = -(x - mu) @ prec
    dmu, ds = gsm_update_stats(jnp.asarray(x), jnp.asarray(v),
                               jnp.asarray(mu), jnp.asarray(cov))
    assert float(jnp.linalg.norm(dmu)) < 2e-2
    assert float(jnp.max(jnp.abs(ds))) < 5e-2


def test_rejects_bad_rank(rng):
    x, v, mu0, s0 = random_problem(rng, 4, 3)
    with pytest.raises(ValueError):
        gsm_update(x[0], v[0], mu0, s0)


def test_grad_flows(rng):
    """Kernel is differentiable (enables future amortized/learned variants)."""
    x, v, mu0, s0 = random_problem(rng, 5, 3)

    def loss(mu0):
        mu, s = gsm_update(x, v, mu0, s0)
        return jnp.sum(mu ** 2) + jnp.sum(s ** 2)

    g = jax.grad(loss)(jnp.asarray(mu0))
    assert np.all(np.isfinite(g))

"""Variational-parameter initializers.

``lbfgs_init`` keeps parity with the reference (``gsmvi/initializers.py:5-17``):
a MAP find via L-BFGS-B whose *inverse-Hessian estimate* seeds the initial
covariance, with ``res.nfev`` feeding ``KLMonitor.offset_evals`` so the cost
axis accounts for warmup (``examples/example_initializers.py:44-45``).

Initialization runs once on the host, so scipy is the right tool (each f/g
evaluation still hits the user's jitted ``lp``/``lp_g`` on device).  For a
host-free alternative, ``map_init`` runs optax Adam fully on device and
returns an identity-scaled covariance.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def lbfgs_init(x0, lp, lp_g=None, maxiter=1000, maxfun=1000):
    """MAP-find with scipy L-BFGS-B; returns (mean, cov, result).

    Parity with reference ``gsmvi/initializers.py:5-17``: minimizes ``-lp``,
    covariance = dense inverse-Hessian approximation.  Note scipy's
    ``hess_inv`` is the limited-memory approximation, so the covariance is a
    warm start, not a Laplace approximation.
    """
    from scipy.optimize import minimize

    x0 = np.asarray(x0, dtype=np.float64)

    def f(x):
        return -float(np.asarray(lp(jnp.asarray(x))))

    f_g = None
    if lp_g is not None:
        def f_g(x):
            return -np.asarray(lp_g(jnp.asarray(x)), dtype=np.float64).reshape(-1)

    res = minimize(f, x0, method="L-BFGS-B", jac=f_g,
                   options={"maxiter": maxiter, "maxfun": maxfun})
    mu = res.x
    cov = res.hess_inv.todense()
    return mu, cov, res


def map_init(key, lp, d: int, x0=None, lr: float = 1e-2, niter: int = 500,
             cov_scale: float = 1.0):
    """On-device MAP initialization: Adam ascent on ``lp``; (mean, cov, nevals).

    A jit/scan loop with no host round-trips — the on-device warm start when
    scipy is undesirable.  Covariance is ``cov_scale * I`` (no Hessian
    estimate).  ``nevals`` counts gradient evaluations for monitor offsets.
    """
    import optax

    x = jnp.zeros(d) if x0 is None else jnp.asarray(x0)
    opt = optax.adam(lr)
    opt_state = opt.init(x)
    neg_lp_grad = jax.grad(lambda z: -jnp.sum(lp(z)))

    def step(carry, _):
        x, opt_state = carry
        g = neg_lp_grad(x)
        updates, opt_state = opt.update(g, opt_state, x)
        return (optax.apply_updates(x, updates), opt_state), None

    (x, _), _ = jax.lax.scan(step, (x, opt_state), None, length=niter)
    cov = cov_scale * jnp.eye(d, dtype=x.dtype)
    return x, cov, niter

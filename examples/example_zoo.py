"""Fit every target-zoo family with the factor-state GSM fitter.

Each zoo constructor returns a ``Target`` with jitted ``lp``/``lp_g``;
``FactorGSM`` runs the eps-coordinate step (sampling, score, rank-2B
update, exact PD check, select) as one compiled scan on any backend:

  PYTHONPATH=. JAX_PLATFORMS=cpu python examples/example_zoo.py

No reference equivalent: the reference's examples are numpyro-model MVNs
only (``/root/reference/examples/example_gsm.py:20-35``).
"""

import jax
import numpy as np

from gsmvi_jax import FactorGSM
from gsmvi_jax.models import (banana, dense_gaussian, funnel,
                              gaussian_mixture, logistic_regression,
                              student_t)

if __name__ == "__main__":
    D, B, NITER = 32, 32, 2000
    targets = [
        dense_gaussian(jax.random.PRNGKey(1), D),
        funnel(D),
        banana(D),
        student_t(jax.random.PRNGKey(2), D, df=6.0),
        gaussian_mixture(jax.random.PRNGKey(3), D, n_components=3),
        logistic_regression(jax.random.PRNGKey(4), D, n_data=128),
    ]
    for t in targets:
        fg = FactorGSM(D=D, lp=t.lp, lp_g=t.lp_g)
        mean, cov = fg.fit(jax.random.PRNGKey(0), niter=NITER, batch_size=B,
                           verbose=False)
        m = np.asarray(mean)
        pd = bool(np.all(np.linalg.eigvalsh(np.asarray(cov)) > 0))
        line = f"{t.name:24s} finite={bool(np.isfinite(m).all())} PD={pd}"
        if t.mean is not None:
            line += f"  max|mean err|={float(np.max(np.abs(m - np.asarray(t.mean)))):.4f}"
        print(line)

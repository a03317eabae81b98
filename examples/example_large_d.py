"""Large-D fit on a 2-D (data x model) mesh with a sharded covariance.

No reference equivalent (the reference is single-device with O(D^2) state
replicated by construction).  This is the large-D path:

- the MC batch shards over the ``data`` axis (score evals data-parallel);
- the (D, D) covariance column-shards over the ``model`` axis
  (``parallel.large_d.cov_sharding``) so per-chip HBM holds a D x D/n panel;
- the validity/sampling Cholesky runs as the BLOCKED right-looking
  factorization (``chol_block=``): the O(D^3) trailing rank-b GEMMs stay
  partitioned under GSPMD — no per-step all-gather of the full matrix
  (``parallel/chol.py``).

Try locally without a pod:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python examples/example_large_d.py
"""

import jax
import numpy as np

from gsmvi_jax import GSM
from gsmvi_jax.models import dense_gaussian
from gsmvi_jax.parallel import cov_sharding, make_mesh_2d

if __name__ == "__main__":
    n = len(jax.devices())
    n_model = 4 if n >= 8 else max(1, n // 2)
    n_data = max(1, n // n_model)
    print(f"devices: {n} -> mesh (data={n_data}, model={n_model})")
    mesh = make_mesh_2d(n_data, n_model)
    sh = cov_sharding(mesh)

    D = 512
    target = dense_gaussian(jax.random.PRNGKey(4), D)

    gsm = GSM(D=D, lp=target.lp, lp_g=target.lp_g, mesh=mesh,
              cov_sharding=sh, chol_block=128)
    mean, cov = gsm.fit(jax.random.PRNGKey(0), niter=4000, batch_size=32,
                        verbose=True, nprint=4)

    mean_err = float(np.max(np.abs(np.asarray(mean) - np.asarray(target.mean))))
    scale = float(np.abs(np.asarray(target.cov)).max())
    cov_err = float(np.max(np.abs(np.asarray(cov) - np.asarray(target.cov)))) / scale
    print(f"\nmax |mean error|    : {mean_err:.4f}")
    print(f"rel max |cov error| : {cov_err:.4f}")

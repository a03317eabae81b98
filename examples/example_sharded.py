"""Data-parallel GSM fit over all available devices.

No reference equivalent (the reference is single-device); this is the
scaling path: the Monte-Carlo batch shards over a 1-D device mesh and XLA
reduces the score statistics across devices (NVLink on one GPU host).

Try locally without a cluster:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python examples/example_sharded.py
On a multi-host cluster, first call
  from gsmvi_jax.parallel import initialize_distributed
  initialize_distributed(auto=True)
"""

import jax
import numpy as np

from gsmvi_jax import GSM
from gsmvi_jax.models import ill_conditioned_gaussian
from gsmvi_jax.parallel import make_mesh

if __name__ == "__main__":
    n = len(jax.devices())
    print(f"devices: {n} x {jax.devices()[0].device_kind}")
    mesh = make_mesh(n)

    D = 256
    target = ill_conditioned_gaussian(jax.random.PRNGKey(4), D, condition=1e4)

    gsm = GSM(D=D, lp=target.lp, lp_g=target.lp_g, mesh=mesh)
    mean_fit, cov_fit = gsm.fit(jax.random.PRNGKey(99), niter=2000,
                                batch_size=16 * n, nprint=5)

    err_mean = float(np.abs(mean_fit - target.mean).max())
    rel_cov = float(np.abs(cov_fit - target.cov).max()
                    / np.abs(np.asarray(target.cov)).max())
    print(f"\nmax |mean error|     : {err_mean:.4f}")
    print(f"rel max |cov error|  : {rel_cov:.4f}")

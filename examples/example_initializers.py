"""LBFGS initialization + KL monitoring for GSM and ADVI.

Mirrors the reference examples/example_initializers.py: initialize the
variational distribution from an LBFGS MAP fit, monitor reverse KL vs the
number of gradient evaluations (offset by the LBFGS cost), plot both fitters.

Run: python examples/example_initializers.py   (writes monitor_kl.png)
"""

import jax
import numpy as np
import optax

from gsmvi_jax import ADVI, GSM, KLMonitor, lbfgs_init
from gsmvi_jax.models import dense_gaussian


def gsm_fit(target, mean_init, cov_init, lbfgs_res):
    print("Now fit with GSM")
    monitor = KLMonitor(batch_size_kl=32, checkpoint=10,
                        offset_evals=lbfgs_res.nfev)
    gsm = GSM(D=target.d, lp=target.lp, lp_g=target.lp_g)
    mean_fit, cov_fit = gsm.fit(jax.random.PRNGKey(99), mean=mean_init,
                                cov=cov_init, niter=500, batch_size=1,
                                monitor=monitor)
    return mean_fit, cov_fit, monitor


def advi_fit(target, mean_init, cov_init, lbfgs_res):
    print("\nNow fit with ADVI")
    monitor = KLMonitor(batch_size_kl=32, checkpoint=10,
                        offset_evals=lbfgs_res.nfev)
    advi = ADVI(D=target.d, lp=target.lp)
    mean_fit, cov_fit, _ = advi.fit(jax.random.PRNGKey(99),
                                    optax.adam(1e-2), mean=mean_init,
                                    cov=cov_init, batch_size=1, niter=500,
                                    monitor=monitor)
    return mean_fit, cov_fit, monitor


if __name__ == "__main__":
    D = 16
    target = dense_gaussian(jax.random.PRNGKey(11), D)

    print("Initialize with LBFGS")
    mean_init, cov_init, lbfgs_res = lbfgs_init(np.ones(D), target.lp,
                                                target.lp_g)
    print(f"LBFGS MAP found in {lbfgs_res.nfev} evals")

    mean_gsm, cov_gsm, mon_gsm = gsm_fit(target, mean_init, cov_init, lbfgs_res)
    mean_advi, cov_advi, mon_advi = advi_fit(target, mean_init, cov_init,
                                             lbfgs_res)

    print("\nTrue mean : ", np.asarray(target.mean))
    print("Fit gsm   : ", np.asarray(mean_gsm))
    print("Fit advi  : ", np.asarray(mean_advi))

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.plot(mon_gsm.nevals, mon_gsm.rkl, label="GSM")
        plt.plot(mon_advi.nevals, mon_advi.rkl, label="ADVI")
        plt.legend()
        plt.xlabel("Number of gradient evaluations")
        plt.ylabel("Reverse KL")
        plt.savefig("monitor_kl.png")
        print("Wrote monitor_kl.png")
    except ImportError:
        print("matplotlib not installed; skipping plot")

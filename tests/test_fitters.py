"""End-to-end recovery tests mirroring the reference example configs
(BASELINE.md table: D=10 GSM, D=5 BaM low-rank, D=4 ADVI)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from gsmvi_jax import ADVI, BaM, GSM, Regularizers
from gsmvi_jax.models import dense_gaussian


@pytest.fixture(scope="module")
def target10():
    return dense_gaussian(jax.random.PRNGKey(3), 10)


class TestGSMFit:
    def test_recovers_mvn(self, target10):
        """Reference config: D=10, 500 iters (examples/example_gsm.py:30-42);
        success criterion from BASELINE.json: match within MC error."""
        t = target10
        gsm = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g)
        mean, cov = gsm.fit(jax.random.PRNGKey(99), niter=500, batch_size=8,
                            verbose=False)
        np.testing.assert_allclose(mean, t.mean, atol=1e-3)
        np.testing.assert_allclose(cov, t.cov, atol=1e-2)

    def test_default_batch_size_two(self, target10):
        """The reference default B=2 must also converge (slower)."""
        t = target10
        gsm = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g)
        mean, cov = gsm.fit(jax.random.PRNGKey(99), niter=2000, verbose=False)
        np.testing.assert_allclose(mean, t.mean, atol=1e-2)

    def test_warm_start(self, target10):
        """mean=/cov= kwargs (reference warm-start path, gsmvi/gsm.py:100-103)."""
        t = target10
        gsm = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g)
        mean, cov = gsm.fit(jax.random.PRNGKey(0), mean=t.mean, cov=t.cov,
                            niter=50, batch_size=16, verbose=False)
        # Starting at the optimum, we must stay there (within MC noise).
        np.testing.assert_allclose(mean, t.mean, atol=5e-3)
        np.testing.assert_allclose(cov, t.cov, atol=5e-2)

    def test_return_state_counters(self, target10):
        t = target10
        gsm = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g)
        state = gsm.fit(jax.random.PRNGKey(1), niter=20, batch_size=4,
                        verbose=False, return_state=True)
        assert int(state.step) == 21  # niter + 1 updates (reference range(niter+1))
        assert int(state.n_accepted) + int(state.n_rejected) == 21

    def test_eager_numpy_lp_g(self, target10):
        """Plain-numpy score functions use the host loop (reference supports
        arbitrary callables; README 'vanilla code ... no dependencies')."""
        t = target10
        mean_np = np.asarray(t.mean)
        prec = np.linalg.inv(np.asarray(t.cov))

        def lp_g_np(x):
            return -(np.asarray(x) - mean_np) @ prec

        gsm = GSM(D=t.d, lp=t.lp, lp_g=lp_g_np)
        mean, cov = gsm.fit(jax.random.PRNGKey(99), niter=300, batch_size=8,
                            verbose=False)
        np.testing.assert_allclose(mean, t.mean, atol=5e-3)


class TestBaMFit:
    def test_recovers_mvn_lowrank(self):
        """Reference config: D=5, 100 iters, B=2, low-rank, reg=100/(1+i),
        criterion np.allclose (examples/example_bam.py:47-75)."""
        t = dense_gaussian(jax.random.PRNGKey(5), 5)
        regf = Regularizers().custom(lambda i: 100.0 / (1 + i))
        bam = BaM(D=t.d, lp=t.lp, lp_g=t.lp_g, use_lowrank=True)
        mean, cov = bam.fit(jax.random.PRNGKey(99), regf=regf, niter=100,
                            batch_size=2, verbose=False)
        assert np.allclose(np.asarray(mean), np.asarray(t.mean), atol=1e-4)
        assert np.allclose(np.asarray(cov), np.asarray(t.cov), atol=1e-3)

    def test_recovers_mvn_fullrank(self):
        t = dense_gaussian(jax.random.PRNGKey(5), 5)
        bam = BaM(D=t.d, lp=t.lp, lp_g=t.lp_g)
        mean, cov = bam.fit(jax.random.PRNGKey(99),
                            regf=Regularizers().linear(100.0), niter=200,
                            batch_size=4, verbose=False)
        np.testing.assert_allclose(mean, t.mean, atol=1e-3)
        np.testing.assert_allclose(cov, t.cov, atol=1e-2)

    def test_newton_sqrt_path(self):
        t = dense_gaussian(jax.random.PRNGKey(5), 5)
        bam = BaM(D=t.d, lp=t.lp, lp_g=t.lp_g, sqrt_method="newton")
        mean, _ = bam.fit(jax.random.PRNGKey(99),
                          regf=Regularizers().linear(100.0), niter=200,
                          batch_size=4, verbose=False)
        np.testing.assert_allclose(mean, t.mean, atol=1e-2)

    def test_jit_compile_false_eager(self):
        t = dense_gaussian(jax.random.PRNGKey(5), 4)
        bam = BaM(D=t.d, lp=t.lp, lp_g=t.lp_g, jit_compile=False)
        mean, _ = bam.fit(jax.random.PRNGKey(99),
                          regf=Regularizers().linear(50.0), niter=80,
                          batch_size=4, verbose=False)
        np.testing.assert_allclose(mean, t.mean, atol=5e-2)


class TestADVIFit:
    def test_recovers_mvn(self):
        """Reference config: D=4, adam(1e-2), B=16 (examples/example_advi.py)."""
        t = dense_gaussian(jax.random.PRNGKey(7), 4)
        advi = ADVI(D=t.d, lp=t.lp)
        mean, cov, losses = advi.fit(jax.random.PRNGKey(1), optax.adam(1e-2),
                                     batch_size=16, niter=5000, verbose=False)
        np.testing.assert_allclose(mean, t.mean, atol=0.2)
        assert losses.shape == (5001,)
        # ELBO improves: late loss well below early loss.
        assert np.mean(losses[-100:]) < np.mean(losses[:100]) - 1.0

    def test_warm_start_at_optimum(self):
        t = dense_gaussian(jax.random.PRNGKey(7), 4)
        advi = ADVI(D=t.d, lp=t.lp)
        mean, cov, losses = advi.fit(
            jax.random.PRNGKey(1), optax.adam(1e-3), mean=t.mean, cov=t.cov,
            batch_size=32, niter=200, verbose=False)
        np.testing.assert_allclose(mean, t.mean, atol=5e-2)


def test_advi_return_losses_false_same_trajectory():
    """return_losses=False must skip the loss trace (None) without touching
    the optimization trajectory."""
    import optax

    from gsmvi_jax import ADVI
    from gsmvi_jax.models import dense_gaussian

    t = dense_gaussian(jax.random.PRNGKey(0), 6)
    kw = dict(niter=60, batch_size=8, verbose=False)
    a1 = ADVI(D=6, lp=t.lp)
    m1, c1, l1 = a1.fit(jax.random.PRNGKey(1), optax.adam(1e-2), **kw)
    a2 = ADVI(D=6, lp=t.lp)
    m2, c2, l2 = a2.fit(jax.random.PRNGKey(1), optax.adam(1e-2),
                        return_losses=False, **kw)
    assert l1.shape == (61,) and l2 is None
    np.testing.assert_allclose(np.asarray(m2), np.asarray(m1), atol=1e-10)
    np.testing.assert_allclose(np.asarray(c2), np.asarray(c1), atol=1e-10)

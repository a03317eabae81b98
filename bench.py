"""Benchmark: fit throughput across the fitter x D matrix.

Output contract (the driver records only a bounded TAIL of stdout, and
embedding the full matrix in the final line truncates it to unparseable):

1. the full evidence matrix is written to ``BENCH_MATRIX.json`` next to this
   file AND printed as its own (early) stdout line;
2. the LAST stdout line is a SHORT one-line JSON — only
   {"metric", "value", "unit", "vs_baseline", "path", "baseline_iters_per_s"}
   — guaranteed to survive any tail window >= ~200 bytes.

The primary metric is GSM iters/s at D=256, B=32 (the BASELINE.json
north-star axis), measured on the fastest GSM path this build ships.  The
matrix carries {gsm, factor_gsm, bam, bam_lowrank, factor_bam, advi,
advi_stl} x D in {64, 256, 1024} with iters/s, score-evals/s and final
moment errors, plus the ill-conditioned D=512 target.

The baseline is the reference's *structure* re-staged faithfully on this
machine (per SURVEY.md §6 the reference publishes no numbers): per-iteration
Python dispatch of a jitted update, host-side ``np.random.multivariate_
normal`` sampling, and a host ``np.linalg.cholesky`` goodness check per
iteration (``gsmvi/gsm.py:107-129``), timed as a median of 3 runs so the
ratio is a stable regression signal.

Each cell compiles and warms up with one untimed run, then times one run
ending in ``block_until_ready``.  Compiled programs persist in
``JAX_COMPILATION_CACHE_DIR`` when set, else in ``.jax_cache/`` here.  A
wall-clock budget skips remaining matrix cells gracefully, so the primary
metric always lands.
"""

import json
import os
import time

import numpy as np

B = 32
PRIMARY_D = 256
# Iteration budgets: GSM's rank-B steps need O(D/B) x mixing iterations, so
# the large-D cells get more; BaM and ADVI get their own tables.
NITER = {64: 60000, 256: 40000, 512: 20000, 1024: 16000, 2048: 24000}
NITER_BAM = {64: 40000, 256: 30000, 512: 12000, 1024: 10000}
NITER_ADVI = {64: 60000, 256: 40000, 512: 4000, 1024: 8000}
# Two-phase ADVI accuracy cell (analytic bulk + annealed STL polish, each
# leg an ``ADVI.fit`` warm-started from the previous leg's moments).
NITER_TWOPHASE = {64: 300_000, 256: 600_000}
NITER_BASE = 150
BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "2700"))
# "0"/"false" must mean OFF: bool("0") is True, and an accidental smoke
# run records a corrupted primary metric (no cell converges at 50 iters).
SMOKE = os.environ.get("BENCH_SMOKE", "") not in ("", "0", "false",
                                                  "False")
_T0 = time.time()


def _remaining():
    return BUDGET_S - (time.time() - _T0)


def _setup_cache():
    import jax

    from gsmvi_jax.config import use_compile_cache

    use_compile_cache(os.path.dirname(os.path.abspath(__file__)))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)


def _targets():
    import jax

    from gsmvi_jax.models import dense_gaussian, ill_conditioned_gaussian

    ds = [64, 256] if SMOKE else [64, 256, 1024]
    t = {d: dense_gaussian(jax.random.PRNGKey(3), d) for d in ds}
    if not SMOKE:
        t["ill512"] = ill_conditioned_gaussian(jax.random.PRNGKey(5), 512,
                                               1e4)
        t[2048] = dense_gaussian(jax.random.PRNGKey(7), 2048)
    return t


def _errs(mean, cov, target):
    m = float(np.max(np.abs(np.asarray(mean) - np.asarray(target.mean))))
    scale = max(1.0, float(np.abs(np.asarray(target.cov)).max()))
    c = float(np.max(np.abs(np.asarray(cov) - np.asarray(target.cov)))) / scale
    return round(m, 5), round(c, 5)


def _time_fit(run, niter, target):
    """(iters/s, mean_err, cov_err): one untimed warm-up run (compiles),
    then one timed run ending in ``block_until_ready``."""
    import jax

    jax.block_until_ready(run(niter))
    t0 = time.perf_counter()
    mean, cov = jax.block_until_ready(run(niter))
    wall = time.perf_counter() - t0
    em, ec = _errs(mean, cov, target)
    return (niter + 1) / max(wall, 1e-9), em, ec


def bench_matrix(targets):
    import jax

    from gsmvi_jax import (ADVI, BaM, FactorBaM, FactorGSM, GSM, Regularizers)

    results = {}

    def add(name, d, maker):
        if _remaining() < 120:
            results.setdefault(name, {})[str(d)] = None
            return
        t = targets[d] if d in targets else targets["ill512"]
        table = (NITER_TWOPHASE if name == "advi_twophase"
                 else NITER_ADVI if name.startswith("advi")
                 else NITER_BAM if "bam" in name else NITER)
        niter = table[t.d] if not SMOKE else 50
        try:
            ips, em, ec = _time_fit(maker(t), niter, t)
            cell = {
                "iters_per_s": round(ips, 1),
                "score_evals_per_s": round(ips * B, 1),
                "mean_err": em, "cov_err": ec,
                # Machine-readable convergence flag: a script filtering
                # regressions must not confuse a deliberately-short
                # throughput window with a convergence regression.
                "converged": bool(ec < 0.05),
            }
            if name in ("advi", "advi_stl"):
                # ELBO/Adam convergence on these stiff targets is method-
                # limited (the covariance scale must grow ~30x through
                # MC-noisy per-entry steps); the reference's estimator is
                # identical.  These rows are throughput cells; the ADVI
                # accuracy cell is advi_twophase.
                cell["throughput_only"] = True
                cell["note"] = "optimizer-limited convergence; same as ref"
            results.setdefault(name, {})[str(d)] = cell
        except Exception as e:  # record the failure, keep benching
            results.setdefault(name, {})[str(d)] = {"error": str(e)[:200]}

    def gsm_run(t, **kw):
        g = GSM(D=t.d, lp=t.lp, lp_g=t.lp_g, **kw)
        return lambda n: g.fit(jax.random.PRNGKey(0), niter=n, batch_size=B,
                               verbose=False)

    def fgsm_run(t, **kw):
        g = FactorGSM(D=t.d, lp=t.lp, lp_g=t.lp_g, **kw)
        return lambda n: g.fit(jax.random.PRNGKey(0), niter=n, batch_size=B,
                               verbose=False)

    def bam_run(t, **kw):
        g = BaM(D=t.d, lp=t.lp, lp_g=t.lp_g, **kw)
        return lambda n: g.fit(jax.random.PRNGKey(0),
                               regf=Regularizers().linear(100.0), niter=n,
                               batch_size=B, verbose=False, retries=0)

    def fbam_run(t, **kw):
        g = FactorBaM(D=t.d, lp=t.lp, lp_g=t.lp_g, **kw)
        return lambda n: g.fit(jax.random.PRNGKey(0),
                               regf=Regularizers().linear(100.0), niter=n,
                               batch_size=B, verbose=False, retries=0)

    def advi_run(t):
        import optax

        g = ADVI(D=t.d, lp=t.lp)
        # return_losses=False: the loss-trace host transfer scales with n.
        return lambda n: g.fit(jax.random.PRNGKey(0), optax.adam(1e-2),
                               niter=n, batch_size=B, verbose=False,
                               return_losses=False)[:2]

    def advi_stl_run(t):
        import optax

        g = ADVI(D=t.d, lp=t.lp)
        return lambda n: g.fit(jax.random.PRNGKey(0), optax.adam(1e-2),
                               niter=n, batch_size=B, verbose=False,
                               return_losses=False, estimator="stl")[:2]

    def advi_twophase(t):
        """Accuracy cell: analytic bulk (1/3 of the budget at lr 1e-2) +
        STL polish (2/9 at lr 3e-3, 4/9 at 1e-3), each leg warm-started
        from the previous leg's moments (Adam restarts per leg)."""
        import optax

        g = ADVI(D=t.d, lp=t.lp)

        def run(n):
            f = lambda frac: max(2, int(n * frac))
            mean, cov, _ = g.fit(jax.random.PRNGKey(0), optax.adam(1e-2),
                                 niter=f(1 / 3), batch_size=B,
                                 verbose=False, return_losses=False)
            for key, lr, frac in ((1, 3e-3, 2 / 9), (2, 1e-3, 4 / 9)):
                mean, cov, _ = g.fit(jax.random.PRNGKey(key),
                                     optax.adam(lr), mean=mean, cov=cov,
                                     niter=f(frac), batch_size=B,
                                     verbose=False, return_losses=False,
                                     estimator="stl")
            return mean, cov

        return run

    # Uniform 64/256/512/1024 coverage for every family; the 512 column
    # runs the ill-conditioned (cond 1e4) target.
    ds = [64, 256] if SMOKE else [64, 256, 512, 1024]
    for d in ds:
        # "gsm"/"bam" are the class defaults (the dense path); "factor_gsm"
        # and "factor_bam" the factor-coordinate routes.
        add("gsm", d, lambda t: gsm_run(t))
        add("factor_gsm", d, lambda t: fgsm_run(t))
        add("bam", d, lambda t: bam_run(t))
        add("bam_lowrank", d, lambda t: bam_run(t, use_lowrank=True))
        add("factor_bam", d, lambda t: fbam_run(t))
        add("advi", d, lambda t: advi_run(t))
        add("advi_stl", d, lambda t: advi_stl_run(t))
        if d in NITER_TWOPHASE:
            add("advi_twophase", d, lambda t: advi_twophase(t))
    if not SMOKE:
        add("gsm", 2048, lambda t: gsm_run(t))
    return results


def fit_batch_evidence(targets):
    """Aggregate-throughput evidence: K replicas in one compiled program,
    on both batched small-space solvers ("ns": Newton-Schulz matmuls,
    "chol": batched Cholesky)."""
    import jax

    from gsmvi_jax import FactorGSM

    out = {}
    cells = ((64, 8, 20000), (64, 32, 20000), (256, 8, 8000), (256, 32, 4000))
    for d, k, niter in cells:
        if _remaining() < 180:
            break
        if d not in targets:
            continue
        if SMOKE:
            niter = 50
        t = targets[d]
        for solver in ("ns", "chol"):
            if _remaining() < 120:
                break
            try:
                g = FactorGSM(D=t.d, lp=t.lp, lp_g=t.lp_g)
                keys = jax.random.split(jax.random.PRNGKey(0), k)

                def run(n):
                    m, c = g.fit_batch(keys, batch_size=B, niter=n,
                                       small_solver=solver)
                    return m[0], c[0]

                ips, em, ec = _time_fit(run, niter, t)
                out[f"D{d}_K{k}_{solver}"] = {
                    "iters_per_s_per_replica": round(ips, 1),
                    "aggregate_iters_per_s": round(ips * k, 1),
                    "aggregate_score_evals_per_s": round(ips * k * B, 1),
                    "mean_err": em, "cov_err": ec,
                    "converged": bool(ec < 0.05),
                }
            except Exception as e:
                out[f"D{d}_K{k}_{solver}"] = {"error": str(e)[:200]}
    return out


def batch_sweep(targets):
    """Monte-Carlo batch scaling of the factor routes: FactorGSM at
    B in {32, 128, 512} and D in {256, 1024}, FactorBaM at D=256."""
    import jax

    from gsmvi_jax import FactorBaM, FactorGSM, Regularizers

    out = {}
    for d in (256, 1024):
        if d not in targets:
            continue
        t = targets[d]
        for b in (32, 128, 512):
            if _remaining() < 240:
                return out
            niter = 50 if SMOKE else 3000
            try:
                g = FactorGSM(D=t.d, lp=t.lp, lp_g=t.lp_g)
                run = (lambda g: lambda n: g.fit(
                    jax.random.PRNGKey(0), niter=n, batch_size=b,
                    verbose=False))(g)
                ips, em, ec = _time_fit(run, niter, t)
                out[f"factor_gsm_D{d}_B{b}"] = {
                    "iters_per_s": round(ips, 1),
                    "score_evals_per_s": round(ips * b, 1),
                    "mean_err": em, "cov_err": ec,
                    "converged": bool(ec < 0.05),
                }
            except Exception as e:
                out[f"factor_gsm_D{d}_B{b}"] = {"error": str(e)[:200]}
            if d != 256:
                continue  # BaM sweep at the primary D only (compile budget)
            try:
                gb = FactorBaM(D=t.d, lp=t.lp, lp_g=t.lp_g)
                runb = (lambda gb: lambda n: gb.fit(
                    jax.random.PRNGKey(0), regf=Regularizers().linear(100.0),
                    niter=n, batch_size=b, verbose=False, retries=0))(gb)
                ips, em, ec = _time_fit(runb, niter, t)
                out[f"factor_bam_D{d}_B{b}"] = {
                    "iters_per_s": round(ips, 1),
                    "score_evals_per_s": round(ips * b, 1),
                    "mean_err": em, "cov_err": ec,
                    "converged": bool(ec < 0.05),
                }
            except Exception as e:
                out[f"factor_bam_D{d}_B{b}"] = {"error": str(e)[:200]}
    return out


def time_reference_structure(t):
    """Reference loop shape: host sampling + per-iter dispatch + host check;
    median of 3 runs (a single-shot timing is load-noisy)."""
    import jax

    from gsmvi_jax.ops.gsm import gsm_update

    d = t.d
    rates = []
    s = np.random.default_rng(0).normal(size=(B, d))
    jax.block_until_ready(
        gsm_update(s, np.asarray(t.lp_g(s)), np.zeros(d), np.eye(d)))
    nbase = 20 if SMOKE else NITER_BASE
    for rep in range(3):
        mean = np.zeros(d)
        cov = np.eye(d)
        key = jax.random.PRNGKey(0)
        t0 = time.perf_counter()
        for i in range(nbase + 1):
            key, key_sample = jax.random.split(key)
            np.random.seed(int(jax.random.randint(key_sample, (), 0,
                                                  2**31 - 1)))
            samples = np.random.multivariate_normal(mean=mean, cov=cov,
                                                    size=B)
            vs = t.lp_g(samples)
            mean_new, cov_new = gsm_update(samples, vs, mean, cov)
            mean_new, cov_new = np.asarray(mean_new), np.asarray(cov_new)
            try:
                good = not np.isnan(np.linalg.cholesky(cov_new)).any()
            except Exception:
                good = False
            if good:
                mean, cov = mean_new, cov_new
        rates.append((nbase + 1) / (time.perf_counter() - t0))
    return float(np.median(rates))


def main():
    _setup_cache()
    targets = _targets()

    matrix = bench_matrix(targets)
    base_ips = time_reference_structure(targets[PRIMARY_D])

    # Primary metric: best GSM-family path at D=256.
    candidates = []
    for name in ("gsm", "factor_gsm"):
        cell = matrix.get(name, {}).get(str(PRIMARY_D))
        if cell and "iters_per_s" in cell and cell["cov_err"] < 0.05:
            candidates.append((cell["iters_per_s"], name))
    best_ips, best_name = max(candidates) if candidates else (0.0, "none")

    # Full evidence grid: a file + its own stdout line, BEFORE the final
    # metric line (a bounded tail window truncates an embedded matrix).
    full = {"artifact": "bench_matrix",
            "baseline_iters_per_s": round(base_ips, 2),
            "fit_batch": fit_batch_evidence(targets),
            "batch_sweep": batch_sweep(targets),
            "matrix": matrix}
    matrix_path = os.environ.get("BENCH_MATRIX_PATH") or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "BENCH_MATRIX.json")
    try:
        with open(matrix_path, "w") as fh:
            json.dump(full, fh, indent=1)
    except OSError:
        pass
    print(json.dumps(full), flush=True)

    # LAST line: short, parse-safe under any bounded tail capture.
    print(json.dumps({
        "metric": f"gsm_iters_per_s_d{PRIMARY_D}_b{B}",
        "value": round(best_ips, 2),
        "unit": "iters/s",
        "vs_baseline": round(best_ips / base_ips, 2) if base_ips else None,
        "path": best_name,
        "baseline_iters_per_s": round(base_ips, 2),
    }), flush=True)


if __name__ == "__main__":
    main()

"""Smoke test of gsmvi_jax on an NVIDIA GPU, through the public API.

Phases, each printing its own lines:

1. device     — the devices JAX sees, and the card's name and power limit;
2. reference  — one update step of every fitter route on the GPU against
   the same step in float64 numpy, at D=1024 and B=32;
3. fits       — GSM and BaM on their dense and factor routes at D=1024 to
   cov_err < 0.05, ADVI at D=1024 (finite, loss falling), and
   ``FactorGSM.fit_batch`` with 32 replicas at D=256;
4. chip tests — ``pytest -m chip tests/test_gpu_hardware.py`` in this
   process (one JAX process on the card at a time).

``--four`` runs only the four-card phase instead: fits on a 4-way data mesh
and a 2x2 data x model mesh against the same fits on one card.

Exits non-zero, printing no result, when JAX finds no GPU or any phase
fails.  The last line of stdout is one JSON object::

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Usage: python chip_smoke.py [--four]
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
D, B = 1024, 32
COV_ERR_MAX = 0.05
# Bar for a float32 step against its float64 twin: 1e-4 of the largest
# entry of the reference result, or ten times what the same float32 step
# reaches on the host CPU (whose float32 products are exact) when the step's
# own conditioning puts the float32 floor above that.  A product run in TF32
# (~1e-3 relative) lands about 1e4 times above the float32 floor.
F32_RTOL = 1e-4
CPU_FLOOR_FACTOR = 10.0


def cov_err(cov, target_cov):
    """max|cov - target| / max(1, max|target|) — the repo's accuracy bar."""
    tc = np.asarray(target_cov, np.float64)
    return float(np.abs(np.asarray(cov, np.float64) - tc).max()
                 / max(1.0, np.abs(tc).max()))


def compare(name, got, ref, rtol, floor=0.0):
    """One reference comparison: (line, ok).  ``got``/``ref`` are
    same-shaped arrays; the bar is ``rtol`` times the largest |ref|, or
    ``floor`` when that is larger."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        return f"{name}: shape {got.shape} != {ref.shape}", False
    diff = max_abs_diff(got, ref)
    tol = max(rtol * float(np.abs(ref).max()), floor)
    ok = diff <= tol
    return (f"{name}: max_abs_diff={diff:.3e} tol={tol:.3e} "
            f"({'ok' if ok else 'FAIL'})"), ok


def max_abs_diff(a, b):
    a = np.asarray(a, np.float64)
    return float(np.abs(a - np.asarray(b, np.float64)).max()) \
        if np.all(np.isfinite(a)) else math.inf


def _gram64(f):
    f = np.asarray(f, np.float64)
    return f @ f.T


def compare_f32(name, got, got_cpu, ref):
    """``compare`` of a GPU result with the float32 bar (see F32_RTOL):
    ``got_cpu`` is the same float32 step computed on the host CPU."""
    line, ok = compare(name, got, ref, F32_RTOL,
                       CPU_FLOOR_FACTOR * max_abs_diff(got_cpu, ref))
    return f"{line} cpu_f32_diff={max_abs_diff(got_cpu, ref):.3e}", ok


# -- float64 numpy references ------------------------------------------------

def gsm_step_f64(samples, vs, mu0, s0):
    """One GSM update in float64 (the repo's numpy twin)."""
    from gsmvi_jax.compat.gsm_numpy import gsm_update

    return gsm_update(np.asarray(samples, np.float64),
                      np.asarray(vs, np.float64),
                      np.asarray(mu0, np.float64), np.asarray(s0, np.float64))


def bam_step_f64(samples, vs, mu0, s0, reg):
    """One BaM update in float64, written straight from the paper's closed
    form S = 2 (I + sqrtm(I + 4 V U))^{-1} V, evaluated through the
    symmetric similarity M = I + 4 L^T U L (L = chol V) and a numpy eigh."""
    x = np.asarray(samples, np.float64)
    g = np.asarray(vs, np.float64)
    mu0 = np.asarray(mu0, np.float64)
    s0 = np.asarray(s0, np.float64)
    b, d = x.shape
    xbar, gbar = x.mean(0), g.mean(0)
    xd, gd = x - xbar, g - gbar
    r1 = reg / (1.0 + reg)
    u = reg * (gd.T @ gd) / b + r1 * np.outer(gbar, gbar)
    v = s0 + reg * (xd.T @ xd) / b + r1 * np.outer(mu0 - xbar, mu0 - xbar)
    lv = np.linalg.cholesky(v)
    m = np.eye(d) + 4.0 * lv.T @ u @ lv
    w, q = np.linalg.eigh(0.5 * (m + m.T))
    inner = (q / (1.0 + np.sqrt(np.maximum(w, 0.0)))) @ q.T
    s = 2.0 * lv @ inner @ lv.T
    s = 0.5 * (s + s.T)
    return mu0 / (1.0 + reg) + r1 * (s @ gbar + xbar), s


def advi_grad_f64(loc, l, eps, score):
    """Gradient of the analytic-estimator negative ELBO in float64:
    d/dloc = -sum_b g_b,  d/dL = -tril(sum_b g_b eps_b^T) - B diag(1/L_ii),
    with g_b = score(loc + L eps_b)."""
    loc = np.asarray(loc, np.float64)
    l = np.asarray(l, np.float64)
    eps = np.asarray(eps, np.float64)
    g = score(loc + eps @ l.T)
    dl = -np.tril(g.T @ eps) - eps.shape[0] * np.diag(1.0 / np.diag(l))
    return -g.sum(0), dl


def reference_checks(d, b, seed=0, reg=0.1):
    """Every reference comparison of phase 2 at (d, b): list of (line, ok).

    The state is a late-fit one (mean and covariance 90% of the way from
    the standard normal to the target), so every term of each update is
    live.  Inputs are drawn once in float32; the float64 references see the
    same values."""
    import jax
    import jax.numpy as jnp

    from gsmvi_jax import ADVI, bam_lowrank_update, bam_update, gsm_update
    from gsmvi_jax.models import dense_gaussian
    from gsmvi_jax.ops.bam_eps import bam_eps_update
    from gsmvi_jax.ops.gsm_eps import apply_eps_step
    from gsmvi_jax.ops.gsm_eps_ns import gsm_eps_update_ns_xla

    f32 = jnp.float32
    t = dense_gaussian(jax.random.PRNGKey(3), d)
    tmean = np.asarray(t.mean, np.float64)
    tcov = np.asarray(t.cov, np.float64)
    prec64 = np.linalg.inv(tcov)

    def score64(x):
        return (tmean - x) @ prec64

    rng = np.random.default_rng(seed)
    mu0 = (0.9 * tmean).astype(np.float32)
    s0 = (0.1 * np.eye(d) + 0.9 * tcov).astype(np.float32)
    s0 = 0.5 * (s0 + s0.T)
    chol0 = np.linalg.cholesky(s0.astype(np.float64)).astype(np.float32)
    eps = rng.standard_normal((b, d)).astype(np.float32)
    x32 = (mu0.astype(np.float64) + eps.astype(np.float64)
           @ chol0.astype(np.float64).T).astype(np.float32)
    reg = np.float32(reg)
    cpu = jax.devices("cpu")[0]

    def both(fn, *args):
        """fn on the default device and on the host CPU, same inputs."""
        with jax.default_matmul_precision("float32"):
            got = fn(*[jnp.asarray(a) for a in args])
            with jax.default_device(cpu):
                got_cpu = fn(*[jnp.asarray(a) for a in args])
        return got, got_cpu

    vs, vs_cpu = both(lambda x: t.lp_g(x).astype(f32), x32)
    vs = np.asarray(vs)
    vs64 = score64(x32.astype(np.float64))
    out = [compare_f32("score", vs, vs_cpu, vs64)]

    def moments(name, fn, ref, *args, factor=False):
        got, got_cpu = both(fn, *args)
        if factor:  # covariance F F^T of the factor, formed in float64
            got = (got[0], _gram64(got[1]), got[2])
            got_cpu = (got_cpu[0], _gram64(got_cpu[1]))
        res = [compare_f32(f"{name} mean", got[0], got_cpu[0], ref[0]),
               compare_f32(f"{name} cov", got[1], got_cpu[1], ref[1])]
        if factor:
            res.append((f"{name} accepted: {bool(got[2])}", bool(got[2])))
        return res

    ref = gsm_step_f64(x32, vs64, mu0, s0)
    out += moments("gsm dense", gsm_update, ref, x32, vs, mu0, s0)
    # FactorGSM routes sample with the factor itself: x = mu0 + eps F^T.
    out += moments("factor_gsm chol",
                   lambda m, f, e, v: apply_eps_step(m, f, e, v), ref,
                   mu0, chol0, eps, vs, factor=True)
    out += moments("factor_gsm ns",
                   lambda e, v, m, f: gsm_eps_update_ns_xla(e, v, m, f), ref,
                   eps, vs, mu0, chol0, factor=True)

    ref = bam_step_f64(x32, vs64, mu0, s0, float(reg))
    out += moments("bam dense", bam_update, ref, x32, vs, mu0, s0, reg)
    out += moments("bam lowrank", bam_lowrank_update, ref, x32, vs, mu0, s0,
                   reg)
    for solver in ("eigh", "svd"):
        out += moments(f"factor_bam {solver}",
                       lambda e, v, m, f, r, s=solver: bam_eps_update(
                           e, v, m, f, r, solver=s), ref,
                       eps, vs, mu0, chol0, reg, factor=True)

    advi = ADVI(d, t.lp, dtype=f32)
    key = jax.random.PRNGKey(seed)
    eps_advi = np.asarray(jax.random.normal(key, (b, d), f32))
    grad, grad_cpu = both(
        jax.jit(jax.grad(lambda loc, l: advi.neg_elbo((loc, l), key, b),
                         argnums=(0, 1))), mu0, chol0)
    ref = advi_grad_f64(mu0, chol0, eps_advi, score64)
    out += [compare_f32("advi grad loc", grad[0], grad_cpu[0], ref[0]),
            compare_f32("advi grad L", jnp.tril(grad[1]),
                        jnp.tril(grad_cpu[1]), ref[1])]
    return out


def indefinite_revert_check(d):
    """Accept/revert on the device's Cholesky: an update whose proposal is
    indefinite must come back non-finite and be reverted.  Returns (line,
    ok)."""
    import jax
    import jax.numpy as jnp

    from gsmvi_jax.state import accept_or_revert, init_state

    st = init_state(jax.random.PRNGKey(0), d, dtype=jnp.float32)
    bad = jnp.eye(d, dtype=jnp.float32).at[0, 0].set(-1.0)
    chol = jnp.linalg.cholesky(bad)
    new = accept_or_revert(st, st.mean + 1.0, bad, st.key)
    ok = (not bool(jnp.all(jnp.isfinite(chol)))
          and int(new.n_rejected) == 1 and int(new.n_accepted) == 0
          and bool(jnp.all(new.cov == st.cov))
          and bool(jnp.all(new.mean == st.mean)))
    return (f"indefinite proposal: cholesky finite="
            f"{bool(jnp.all(jnp.isfinite(chol)))} rejected="
            f"{int(new.n_rejected)} reverted={ok}"), ok


# -- fits ---------------------------------------------------------------------

def timed_fit(run):
    """(result, first_call_s, second_call_s): the first call compiles, the
    second re-runs the same compiled program."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(run())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = jax.block_until_ready(run())
    return res, first, time.perf_counter() - t0


def fit_checks(d, b, niter, advi_niter, batch_d, batch_k, batch_niter):
    """Phase 3: list of (line, ok)."""
    import jax
    import jax.numpy as jnp
    import optax

    from gsmvi_jax import ADVI, BaM, FactorGSM, GSM, Regularizers
    from gsmvi_jax.models import dense_gaussian

    f32 = jnp.float32
    t = dense_gaussian(jax.random.PRNGKey(3), d)
    regf = Regularizers().linear(100.0)
    fits = [
        ("gsm dense", lambda: GSM(d, t.lp, t.lp_g, dtype=f32),
         lambda g: g.fit(jax.random.PRNGKey(0), batch_size=b, niter=niter,
                         verbose=False)),
        ("gsm factor", lambda: GSM(d, t.lp, t.lp_g, dtype=f32,
                                   use_factor=True),
         lambda g: g.fit(jax.random.PRNGKey(0), batch_size=b, niter=niter,
                         verbose=False)),
        ("bam dense", lambda: BaM(d, t.lp, t.lp_g, dtype=f32),
         lambda g: g.fit(jax.random.PRNGKey(0), regf, batch_size=b,
                         niter=niter, verbose=False)),
        ("bam factor", lambda: BaM(d, t.lp, t.lp_g, dtype=f32,
                                   use_factor=True),
         lambda g: g.fit(jax.random.PRNGKey(0), regf, batch_size=b,
                         niter=niter, verbose=False)),
    ]
    out = []
    for name, make, fit in fits:
        fitter = make()
        (mean, cov), first, wall = timed_fit(lambda: fit(fitter))
        err = cov_err(cov, t.cov)
        ok = bool(np.all(np.isfinite(np.asarray(cov)))) and err < COV_ERR_MAX
        out.append((f"fit {name} D={d} B={b} niter={niter}: "
                    f"it/s={(niter + 1) / wall:.1f} wall_s={wall:.3f} "
                    f"compile_s={max(first - wall, 0.0):.3f} "
                    f"cov_err={err:.5f} ({'ok' if ok else 'FAIL'})", ok))

    advi = ADVI(d, t.lp, dtype=f32)
    opt = optax.adam(1e-3)
    (mean, cov, losses), first, wall = timed_fit(
        lambda: advi.fit(jax.random.PRNGKey(0), opt, batch_size=b,
                         niter=advi_niter, verbose=False))
    losses = np.asarray(losses)
    w = max(advi_niter // 10, 1)
    head, tail = float(losses[:w].mean()), float(losses[-w:].mean())
    ok = bool(np.all(np.isfinite(losses))
              and np.all(np.isfinite(np.asarray(cov))) and tail < head)
    out.append((f"fit advi D={d} B={b} niter={advi_niter}: "
                f"it/s={(advi_niter + 1) / wall:.1f} wall_s={wall:.3f} "
                f"compile_s={max(first - wall, 0.0):.3f} loss_first={head:.6g} "
                f"loss_last={tail:.6g} cov_err={cov_err(cov, t.cov):.5f} "
                f"({'ok' if ok else 'FAIL'})", ok))

    tb = dense_gaussian(jax.random.PRNGKey(3), batch_d)
    fg = FactorGSM(batch_d, tb.lp, tb.lp_g, dtype=f32)
    keys = jax.random.split(jax.random.PRNGKey(1), batch_k)
    (means, covs), first, wall = timed_fit(
        lambda: fg.fit_batch(keys, batch_size=b, niter=batch_niter))
    errs = [cov_err(c, tb.cov) for c in np.asarray(covs)]
    ok = bool(np.all(np.isfinite(np.asarray(covs)))) and max(errs) < \
        COV_ERR_MAX
    out.append((f"fit factor_gsm fit_batch D={batch_d} B={b} K={batch_k} "
                f"niter={batch_niter}: aggregate_it/s="
                f"{batch_k * (batch_niter + 1) / wall:.1f} wall_s={wall:.3f} "
                f"compile_s={max(first - wall, 0.0):.3f} "
                f"cov_err_max={max(errs):.5f} ({'ok' if ok else 'FAIL'})",
                ok))
    return out


# -- four cards ---------------------------------------------------------------

def _shard_devices(x):
    return {s.device for s in x.addressable_shards}


def _moments(name, got, ref):
    """Sharded vs one-device moments: the covariance against 1e-4 of its
    largest entry, the mean against 1e-4 of the posterior scale (the larger
    of max|mean| and sqrt(max|cov|)), since means start at zero."""
    scale = np.sqrt(float(np.abs(np.asarray(ref[1], np.float64)).max()))
    return [compare(f"{name} mean", got[0], ref[0], F32_RTOL,
                    F32_RTOL * scale),
            compare(f"{name} cov", got[1], ref[1], F32_RTOL)]


def four_checks(n_dev=4, d=256, b=32, niter=5, d_model=2048):
    """Data mesh (GSM, BaM, ADVI, FactorGSM), shard_map vs GSPMD stats, and
    the 2x2 data x model mesh at ``d_model``, each against the same fit on
    one device with the same key.  Returns list of (line, ok)."""
    import jax
    import jax.numpy as jnp
    import optax

    from gsmvi_jax import ADVI, BaM, FactorGSM, GSM, Regularizers
    from gsmvi_jax.models import ill_conditioned_gaussian
    from gsmvi_jax.ops.gsm import gsm_update_stats
    from gsmvi_jax.parallel import make_mesh
    from gsmvi_jax.parallel.large_d import cov_sharding, make_mesh_2d
    from gsmvi_jax.parallel.sharded import sharded_gsm_stats

    f32 = jnp.float32
    out = []
    mesh = make_mesh(n_dev)
    mesh_devs = set(mesh.devices.flat)
    out.append((f"data mesh devices: {sorted(d_.id for d_ in mesh_devs)}",
                len(mesh_devs) == n_dev))
    # Sharding changes only the order of sums; a moderately conditioned
    # target keeps that rounding from being amplified past the float32 bar.
    t = ill_conditioned_gaussian(jax.random.PRNGKey(5), d, 100.0)
    key = jax.random.PRNGKey(1)
    # A constant regularizer: the first steps of the linear(100) schedule
    # are near-exact solves that amplify the reordered sums ~100x.
    regf = Regularizers().constant(1.0)

    cases = [
        ("gsm", lambda m: GSM(d, t.lp, t.lp_g, mesh=m, dtype=f32).fit(
            key, batch_size=b, niter=niter, verbose=False)),
        ("bam", lambda m: BaM(d, t.lp, t.lp_g, mesh=m, dtype=f32).fit(
            key, regf, batch_size=b, niter=niter, verbose=False)),
        ("advi", lambda m: ADVI(d, t.lp, mesh=m, dtype=f32).fit(
            key, optax.adam(1e-3), batch_size=b, niter=niter,
            verbose=False)[:2]),
        ("factor_gsm", lambda m: FactorGSM(d, t.lp, t.lp_g, mesh=m,
                                           dtype=f32).fit(
            key, batch_size=b, niter=niter, verbose=False)),
    ]
    for name, fit in cases:
        out += _moments(f"4-way data mesh {name}", fit(mesh), fit(None))

    from jax.sharding import NamedSharding, PartitionSpec as P

    x = jax.device_put(jax.random.normal(key, (b, d), f32),
                       NamedSharding(mesh, P("data", None)))
    out.append((f"sample shards on {len(_shard_devices(x))} devices",
                len(_shard_devices(x)) == n_dev))
    s0 = jnp.eye(d, dtype=f32)
    mu0 = jnp.zeros(d, f32)
    with jax.default_matmul_precision("float32"):
        dmu_s, ds_s = sharded_gsm_stats(mesh, t.lp_g, x, mu0, s0)
        dmu_g, ds_g = jax.jit(lambda x: gsm_update_stats(
            x, t.lp_g(x), mu0, s0))(x)
    out += [compare("shard_map vs GSPMD gsm stats dmu", dmu_s, dmu_g,
                    F32_RTOL),
            compare("shard_map vs GSPMD gsm stats dS", ds_s, ds_g, F32_RTOL)]

    t2 = ill_conditioned_gaussian(jax.random.PRNGKey(7), d_model, 100.0)
    mesh2 = make_mesh_2d(2, n_dev // 2)
    cs = cov_sharding(mesh2)
    # FactorGSM is compared over one step: its eps-Cholesky accept flag
    # depends on rounding at this size (the (2B)^2 Gram is nearly
    # singular), so a longer fit can accept a step on one layout and revert
    # it on the other — a different trajectory, not a sharding error.
    cases2 = [
        ("factor_gsm cov_sharding", 0,
         lambda: FactorGSM(d_model, t2.lp, t2.lp_g, dtype=f32),
         lambda: FactorGSM(d_model, t2.lp, t2.lp_g, mesh=mesh2,
                           cov_sharding=cs, dtype=f32)),
        ("gsm chol_block", niter,
         lambda: GSM(d_model, t2.lp, t2.lp_g, dtype=f32),
         lambda: GSM(d_model, t2.lp, t2.lp_g, mesh=mesh2, cov_sharding=cs,
                     chol_block=256, dtype=f32)),
    ]
    for name, steps, one, sharded in cases2:
        kw = dict(batch_size=b, niter=steps, verbose=False,
                  return_state=True)
        s1 = one().fit(key, **kw)
        s4 = sharded().fit(key, **kw)
        c4 = s4.cov
        out.append((f"2x2 mesh {name}: cov on "
                    f"{len(_shard_devices(c4))} devices",
                    len(_shard_devices(c4)) == n_dev))
        acc = (int(s4.n_accepted), int(s1.n_accepted))
        out.append((f"2x2 mesh {name}: accepted {acc[0]} vs {acc[1]} of "
                    f"{steps + 1}", acc[0] == acc[1]))
        out += _moments(f"2x2 mesh {name}", (s4.mean, c4),
                        (s1.mean, s1.cov))
    return out


# -- driver --------------------------------------------------------------------

def run_phase(name, checks):
    """Print each check's line under the phase name; True iff all pass."""
    ok = True
    for line, good in checks:
        print(f"[{name}] {line}", flush=True)
        ok = ok and good
    print(f"[{name}] {'passed' if ok else 'FAILED'}", flush=True)
    return ok


def card_lines():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()


def result_line(devices):
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}})


def main(argv):
    four = "--four" in argv
    os.environ.setdefault("JAX_PLATFORMS", "cuda,cpu")
    import jax

    try:
        devices = jax.devices()
    except RuntimeError as e:
        print(f"chip_smoke: JAX found no GPU: {e}", file=sys.stderr)
        return 1
    if devices[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform "
              f"{devices[0].platform!r})", file=sys.stderr)
        return 1
    if four and len(devices) < 4:
        print(f"chip_smoke: --four needs 4 GPUs, found {len(devices)}",
              file=sys.stderr)
        return 1

    from gsmvi_jax.config import use_compile_cache

    print(f"compile cache: {use_compile_cache(ROOT)}", flush=True)
    print(f"[device] {devices}", flush=True)
    for line in card_lines():
        print(f"[device] {line}", flush=True)

    if four:
        ok = run_phase("four", four_checks(n_dev=4))
    else:
        ok = run_phase("reference", reference_checks(D, B)
                       + [indefinite_revert_check(D)])
        ok = run_phase("fits", fit_checks(D, B, niter=6000, advi_niter=400,
                                          batch_d=256, batch_k=32,
                                          batch_niter=1000)) and ok
        import pytest

        rc = pytest.main(["-q", "-m", "chip", "-p", "no:cacheprovider",
                          os.path.join(ROOT, "tests", "test_gpu_hardware.py")])
        ok = run_phase("chip tests", [(f"pytest exit code {int(rc)}",
                                       int(rc) == 0)]) and ok
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

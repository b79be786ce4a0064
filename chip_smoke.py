"""
Smoke check of the main path on the GPU.

The main path is the FullMT moment-tensor geometry inversion at the
real-config width, run through the library's own entry points
(``SeismicGeometryComposite`` -> ``Problem.make_logp_fn`` ->
``Problem.sample`` with ``SMCParams``), each result checked against a
plain reference:

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded paths only

One-card phases, one line each:

  device            platform, device_kind, count, jax version, XLA_FLAGS,
                    and the card's name and power limit (nvidia-smi)
  fullmt_sample     206 x 15 x nt=1024 table, 10 stations, 2000 chains:
                    logp compile time and memory_analysis, then a few
                    SMC stages; llks finite, beta advanced, stages
                    written, population inside its bounds
  fullmt_reference  the batched logp of 16 nearby points on the GPU and
                    on the CPU backend, both at HIGHEST matmul precision
  gather            the table gather against a numpy float64 reference
  kinematic_stack   SeismicGFLibrary.stack_all against numpy float64
  f32_llk           the float32-likelihood harness of
                    tests/test_float32_llk.py

Four-card phases: the full-width logp on a 4-card chains mesh against
one card, a chain-sharded SMC stage, the kinematic llk on a
(chains, targets) mesh against the unsharded llk, and the PT ladder.

Any failure exits non-zero; no phase catches its own failure.  Without
a GPU the script exits non-zero before printing any result.  The last
line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

Every phase is a plain function: ``tests/test_chip_smoke.py`` runs them
at tiny sizes on the CPU, and at full size on the card when marked
``chip``.  The script imports only jax, numpy and scipy (through the
library) — not the CLI's PyYAML.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

#: the real-config FullMT width (BENCH shape of the reference example)
FULLMT_WIDTH = dict(n_stations=10, nt=1024, n_distances=206, n_depths=15)
#: the reference FullMT chain count (config_geometry.yaml n_chains)
N_CHAINS = 2000
#: the kinematic-stack bench shape: chains, targets, patches,
#: durations, starttimes, samples
STACK_SHAPE = dict(C=2000, T=8, P=12, D=6, S=16, N=256)

#: GPU vs CPU llk, relative to max(|llk|, 1): both evaluate float32 at
#: HIGHEST precision; what differs is the order of the float32 sums
#: over ~10^3 residual samples (~1e3 x 6e-8)
LLK_RTOL = 1e-5
#: error in llk DIFFERENCES between nearby points, relative to the
#: largest difference — the criterion of tests/test_float32_llk.py
LLK_DIFF_RTOL = 0.15
#: 4-card vs 1-card llk: same arithmetic, separately compiled programs
MESH_RTOL = 1e-5


def say(phase: str, run, *args, **kwargs) -> None:
    """Run one phase and print its result line with its wall time."""
    t0 = time.perf_counter()
    fields = run(*args, **kwargs)
    fields["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"phase": phase, **fields}, default=_jsonable),
          flush=True)


def _jsonable(x):
    return x.tolist() if hasattr(x, "tolist") else str(x)


def memory(compiled) -> dict:
    """``compiled.memory_analysis()`` as a dict of byte counts."""
    m = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes",
            "peak_memory_in_bytes")
    return {k: getattr(m, k, None) for k in keys} if m is not None else {}


def nvidia_smi() -> str:
    """The cards' names and power limits, as nvidia-smi gives them."""
    from bench import card_name_and_power_limit

    cards = card_name_and_power_limit()
    assert cards, "nvidia-smi gave no card name and power limit"
    return "\n".join(cards)


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    """The accelerator as JAX reports it; exits when it is not a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU — JAX's default platform is "
            f"{devs[0].platform!r}; this check runs on the card only")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "jax": jax.__version__,
            "xla_flags": os.environ.get("XLA_FLAGS", "")}


def build_fullmt(outfolder: str, **width):
    """The flagship FullMT problem (``__graft_entry__._build_flagship``),
    at :data:`FULLMT_WIDTH` unless ``width`` overrides it."""
    from __graft_entry__ import _build_flagship

    return _build_flagship(outfolder=outfolder, **{**FULLMT_WIDTH, **width})


def _population(problem, n_chains: int, seed: int = 0):
    lower, upper = problem.priors.bounds_arrays()
    rng = np.random.default_rng(seed)
    return rng.uniform(lower, upper, size=(n_chains, lower.size)).astype(
        np.float32)


def phase_fullmt_sample(problem, n_chains: int = N_CHAINS, n_steps: int = 25,
                        max_stages: int = 4, seed: int = 0) -> dict:
    """Compile the batched logp, then run a few SMC stages through
    ``Problem.sample``.  The run is capped at ``max_stages``: reaching
    the cap before beta=1 is the expected end, any other error fails."""
    import jax
    import jax.numpy as jnp

    from beat_tpu.backend import SampleStage
    from beat_tpu.profiling import batched_logp
    from beat_tpu.samplers import SMCParams

    logp, data = problem.make_logp_fn()
    spectra = data[0][0]["table"].spectra
    q = jnp.asarray(_population(problem, n_chains, seed))
    t0 = time.perf_counter()
    compiled = batched_logp(logp, 1).lower(q, data).compile()
    compile_s = time.perf_counter() - t0
    llk = np.asarray(jax.block_until_ready(compiled(q, data)))
    assert llk.shape == (n_chains,) and np.isfinite(llk).all(), \
        "non-finite llk in the batched logp"

    problem.sampler_params = SMCParams(
        n_chains=n_chains, n_steps=n_steps, max_stages=max_stages,
        seed=seed, rm_flag=True)
    t0 = time.perf_counter()
    try:
        problem.sample()
        reached_beta1 = True
    except RuntimeError as e:
        if "did not reach beta=1" not in str(e):
            raise
        reached_beta1 = False
    sample_s = time.perf_counter() - t0

    lower, upper = problem.priors.bounds_arrays()
    handler = SampleStage(problem.outfolder, ordering=problem.ordering)
    top = handler.highest_sampled_stage()
    assert top == -1 or top >= 1, f"no Metropolis stage on disk (top={top})"
    state = handler.load_state(top)
    beta = float(state["beta"])
    pop = np.asarray(state["population"])
    llks = np.asarray(state["likelihoods"])
    assert beta > 0.0, "beta did not advance"
    assert np.isfinite(llks).all() and np.isfinite(
        handler.load_trace(top).llk_trace).all(), "non-finite stage llks"
    assert pop.shape == (n_chains, lower.size)
    assert ((pop >= lower) & (pop <= upper)).all(), "population out of bounds"
    return {"table_shape": list(spectra.shape),
            "table_bytes": int(spectra.size * spectra.dtype.itemsize),
            "n_chains": n_chains, "logp_compile_s": compile_s,
            "logp_memory": memory(compiled), "sample_wall_s": sample_s,
            "n_steps": n_steps, "max_stages": max_stages,
            "stages_written": top if top >= 0 else "final",
            "beta": beta, "reached_beta1": reached_beta1,
            "llk_range": [float(llks.min()), float(llks.max())]}


def phase_fullmt_reference(problem, n: int = 16, n_timed: int = N_CHAINS,
                           seed: int = 1) -> dict:
    """The batched logp of ``n`` nearby points on the default device
    against the CPU backend, both at HIGHEST; the DEFAULT (TF32 on the
    card) variant is reported beside it, not checked.  Both are timed
    at ``n_timed`` chains."""
    import jax
    import jax.numpy as jnp

    from beat_tpu.distributions import LIKELIHOOD_PRECISION, pinned_precision
    from beat_tpu.profiling import batched_logp, device_time

    logp, data = problem.make_logp_fn()
    lower, upper = problem.priors.bounds_arrays()
    rng = np.random.default_rng(seed)
    base = rng.uniform(lower, upper)
    scales = np.geomspace(1e-4, 3e-1, n - 1)
    pts = [base] + [np.clip(base + s * (upper - lower) * rng.normal(
        size=base.size), lower, upper) for s in scales]
    q = np.asarray(pts, np.float32)

    cpu = jax.devices("cpu")[0]
    fn = batched_logp(logp, 1)
    ref = np.asarray(fn(jax.device_put(q, cpu), jax.device_put(data, cpu)),
                     np.float64)

    def errors(got):
        d_got, d_ref = got[1:] - got[0], ref[1:] - ref[0]
        return (float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1.0))),
                float(np.max(np.abs(d_got - d_ref))),
                float(max(np.abs(d_ref).max(), 1.0)))

    got = np.asarray(fn(jnp.asarray(q), data), np.float64)
    rel, diff_err, diff_scale = errors(got)
    assert np.isfinite(got).all()
    assert rel <= LLK_RTOL, f"llk rel. error {rel:.3g} > {LLK_RTOL}"
    assert diff_err <= LLK_DIFF_RTOL * diff_scale, \
        f"llk-difference error {diff_err:.3g} > {LLK_DIFF_RTOL} x {diff_scale:.3g}"

    # informative: the same logp with unpinned (DEFAULT) matmuls, and
    # both times at the full chain count
    fn_default = batched_logp(pinned_precision(logp.__wrapped__, "default"), 1)
    rel_d, diff_d, _ = errors(np.asarray(fn_default(jnp.asarray(q), data),
                                         np.float64))
    qq = jnp.asarray(_population(problem, n_timed, seed))
    return {"n_points": n, "precision": LIKELIHOOD_PRECISION,
            "max_rel_llk": rel, "rtol": LLK_RTOL,
            "max_diff_err": diff_err,
            "diff_tol": LLK_DIFF_RTOL * diff_scale,
            "default_precision_max_rel_llk": rel_d,
            "default_precision_max_diff_err": diff_d,
            "n_timed": n_timed,
            "ms_highest": device_time(fn, qq, data) * 1e3,
            "ms_default": device_time(fn_default, qq, data) * 1e3}


def phase_gather(table, n_chains: int = N_CHAINS, n_targets: int = 10,
                 seed: int = 2) -> dict:
    """``GreensTable.gather_spectra`` under vmap over chains against the
    numpy float64 reference, with queries inside, exactly on the top
    edge of and outside the grid."""
    import jax
    import jax.numpy as jnp

    from beat_tpu.heart.gftable import gather_spectra_numpy

    rng = np.random.default_rng(seed)
    d_grid = np.asarray(table.distances)
    z_grid = np.asarray(table.depths)
    span = max(d_grid[-1] - d_grid[0], 1e3)
    dist = rng.uniform(d_grid[0] - 0.05 * span, d_grid[-1] + 0.05 * span,
                       (n_chains, n_targets))
    dist[:, 0] = d_grid[-1]
    dist = dist.astype(np.float32)
    depth = rng.uniform(z_grid[0] - 1e3, z_grid[-1] + 1e3, n_chains)
    depth[0] = z_grid[-1]
    depth = depth.astype(np.float32)
    cidx = rng.integers(0, 3, n_targets)

    fn = jax.jit(jax.vmap(lambda t, d, z, c: t.gather_spectra(d, z, c),
                          in_axes=(None, 0, 0, None)))
    got = np.asarray(fn(table, jnp.asarray(dist), jnp.asarray(depth),
                        jnp.asarray(cidx, dtype=jnp.int32)))
    ref = gather_spectra_numpy(table, dist, depth, cidx)
    # float32 fractional index: one ulp at an index of ~200 is 1.5e-5 of
    # a cell, so a weight is off by up to ~2e-5 of a row's magnitude
    scale = float(np.abs(np.asarray(table.spectra)).max())
    err = float(np.abs(got - ref).max()) / scale
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert err <= 1e-4, f"gather error {err:.3g} of the table's max > 1e-4"
    return {"queries": n_chains * n_targets, "max_err_rel_table_max": err,
            "tol": 1e-4}


def phase_kinematic_stack(C=STACK_SHAPE["C"], T=STACK_SHAPE["T"],
                          P=STACK_SHAPE["P"], D=STACK_SHAPE["D"],
                          S=STACK_SHAPE["S"], N=STACK_SHAPE["N"],
                          n_check: int = 8, seed: int = 3) -> dict:
    """The chain-batched ``SeismicGFLibrary.stack_all`` (XLA) against
    ``stack_all_numpy`` (float64) on ``n_check`` chains, both
    interpolations; memory_analysis of the whole batch."""
    from beat_tpu.ffi.gflibrary import stack_all_numpy
    from beat_tpu.profiling import device_time
    from tools.bench_gfstack import batched_stack, make_problem

    args = make_problem(C, T, P, D, S, N, seed=seed)
    lib, durations, starttimes, slips = args
    out = {"shape": [C, T, P, D, S, N], "patch_block": lib.patch_block()}
    for interp in ("nearest_neighbor", "multilinear"):
        compiled = batched_stack(interp).lower(*args).compile()
        got = np.asarray(compiled(*args))
        ref = np.stack([stack_all_numpy(lib, durations[i], starttimes[i],
                                        slips[i], interp)
                        for i in range(n_check)])
        # float32 sums of 4 x P weighted samples against float64
        err = float(np.abs(got[:n_check] - ref).max() / np.abs(ref).max())
        assert np.isfinite(got).all() and err <= 1e-5, \
            f"{interp} stack error {err:.3g} > 1e-5"
        out[interp] = {"max_rel_err": err, "tol": 1e-5,
                       "ms_per_batch": device_time(compiled, *args) * 1e3,
                       "memory": memory(compiled)}
    return out


def f32_llk_check(n: int, corr_len: float, seed: int = 3) -> dict:
    """Float32 device likelihood against a float64 host reference at a
    realistic size and conditioning (SURVEY §7 hard part 6): the error
    in log-likelihood DIFFERENCES between nearby points (which sets the
    accept-probability distortion) must be ≪ 1, whatever the absolute
    offset (a common bias cancels in the Metropolis ratio and in the
    importance weights).  Evaluated at the likelihood path's pinned
    precision."""
    import jax.numpy as jnp

    from beat_tpu.distributions import multivariate_normal_chol, pinned_precision

    rng = np.random.default_rng(seed)
    idx = np.arange(n)
    d = np.abs(idx[:, None] - idx[None, :]) / corr_len
    # squared-exponential kernel + 1e-7 nugget: condition number >= 1e6,
    # the regime SURVEY §7 flags for float32 likelihoods
    C = np.exp(-d * d) + 1e-7 * np.eye(n)
    cond = float(np.linalg.cond(C))
    assert cond > 1e6
    L = np.linalg.cholesky(C)
    chol_inv64 = np.linalg.inv(L)
    sign, log_pdet64 = np.linalg.slogdet(C)
    assert sign > 0
    base = L @ rng.normal(size=n) + 0.3 * np.sin(np.arange(n) / 25.0)
    h = 0.1
    llk32 = pinned_precision(multivariate_normal_chol)
    chol_inv32 = jnp.asarray(chol_inv64, dtype=jnp.float32)

    llks32, llks64 = [], []
    for s in (0.0, 1e-3, 1e-2, 0.1):       # proposal-step-sized changes
        r = base + rng.normal(size=n) * s
        tmp = chol_inv64 @ r
        llks64.append(-0.5 * (log_pdet64 + n * (2 * h + np.log(2 * np.pi))
                              + np.exp(-2 * h) * tmp @ tmp))
        llks32.append(float(llk32(jnp.asarray(r, dtype=jnp.float32),
                                  chol_inv32, jnp.float32(log_pdet64),
                                  jnp.float32(h))))
    llks32, llks64 = np.asarray(llks32), np.asarray(llks64)
    d32, d64 = llks32[1:] - llks32[0], llks64[1:] - llks64[0]
    diff_err = float(np.abs(d32 - d64).max())
    tol = LLK_DIFF_RTOL * max(float(np.abs(d64).max()), 1.0)
    assert diff_err < tol, (diff_err, tol, d64)
    return {"n": n, "cond": cond,
            "abs_err": float(np.abs(llks32 - llks64).max()),
            "diff_err": diff_err, "diff_tol": tol}


def phase_f32_llk() -> dict:
    return {f"n{n}": f32_llk_check(n, c) for n, c in ((1024, 30.0),
                                                     (2048, 80.0))}


# ---------------------------------------------------------------------------
# four-card phases
# ---------------------------------------------------------------------------


def phase_four_logp(problem, n_devices: int = 4,
                    n_chains: int = N_CHAINS) -> dict:
    """One population's batched logp on an ``n_devices`` chains mesh
    against one device."""
    import jax
    import jax.numpy as jnp

    from beat_tpu.parallel import chain_sharding, make_chain_mesh, replicated
    from beat_tpu.profiling import batched_logp

    logp, data = problem.make_logp_fn()
    q = _population(problem, n_chains, seed=4)
    fn = batched_logp(logp, 1)
    dev0 = jax.devices()[0]
    one = np.asarray(fn(jax.device_put(q, dev0), jax.device_put(data, dev0)))
    mesh = make_chain_mesh(n_devices)
    got = fn(jax.device_put(jnp.asarray(q), chain_sharding(mesh)),
             jax.device_put(data, replicated(mesh)))
    assert len(got.sharding.device_set) == n_devices, \
        "llk not spread over the mesh"
    got = np.asarray(got)
    rel = float(np.max(np.abs(got - one) / np.maximum(np.abs(one), 1.0)))
    assert np.isfinite(got).all() and rel <= MESH_RTOL, \
        f"mesh llk rel. error {rel:.3g} > {MESH_RTOL}"
    return {"n_devices": n_devices, "n_chains": n_chains,
            "max_rel_vs_one_device": rel, "rtol": MESH_RTOL}


def phase_four_smc(problem, n_devices: int = 4, n_chains: int = N_CHAINS,
                   n_steps: int = 10) -> dict:
    """One SMC stage transition (beta bisection, covariance, systematic
    resampling) and a Metropolis stage with the chain state sharded
    over ``n_devices``."""
    import jax
    import jax.numpy as jnp

    from beat_tpu.parallel import (chain_sharding, make_chain_mesh,
                                   replicated, shard_chain_state)
    from beat_tpu.samplers.metropolis import (init_metropolis_state,
                                              run_metropolis_stage)
    from beat_tpu.samplers.smc import (calc_beta, calc_covariance,
                                       systematic_resample)

    logp, data = problem.make_logp_fn()
    lower, upper = problem.priors.bounds_arrays()
    mesh = make_chain_mesh(n_devices)
    cs, rep = chain_sharding(mesh), replicated(mesh)
    data = jax.device_put(data, rep)
    q0 = jax.device_put(jnp.asarray(_population(problem, n_chains, 5)), cs)
    state = shard_chain_state(init_metropolis_state(
        logp, q0, jax.random.PRNGKey(0), logp_args=(data,)), mesh)

    beta, _, weights = calc_beta(0.0, np.asarray(state.llk, np.float64), 1.0)
    cov = calc_covariance(np.asarray(state.q, np.float64), weights)
    idx = jax.device_put(jnp.asarray(systematic_resample(
        weights, np.random.default_rng(0))), rep)
    resample = jax.jit(lambda pop, i: pop[i], out_shardings=cs)
    state = state._replace(q=resample(state.q, idx),
                           llk=resample(state.llk, idx))
    final, _ = run_metropolis_stage(
        logp, state, jnp.float32(min(beta, 1.0)),
        jax.device_put(jnp.asarray(np.linalg.cholesky(cov), jnp.float32), rep),
        jax.device_put(jnp.asarray(lower, jnp.float32), rep),
        jax.device_put(jnp.asarray(upper, jnp.float32), rep),
        n_steps=n_steps, tune_interval=5, logp_args=(data,))
    jax.block_until_ready(final.q)
    assert len(final.q.sharding.device_set) == n_devices, \
        "SMC state collapsed onto fewer devices than the mesh"
    assert beta > 0.0 and np.isfinite(np.asarray(final.llk)).all()
    return {"n_devices": n_devices, "n_chains": n_chains, "beta": beta,
            "state_devices": len(final.q.sharding.device_set)}


def phase_four_kinematic(n_devices: int = 4, C=STACK_SHAPE["C"],
                         T=STACK_SHAPE["T"], P=STACK_SHAPE["P"],
                         D=STACK_SHAPE["D"], S=STACK_SHAPE["S"],
                         N=STACK_SHAPE["N"]) -> dict:
    """Kinematic llk with the GF library split along targets over a
    (chains, targets) mesh, ``psum`` over targets, against the
    unsharded llk."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as Ps

    from beat_tpu.parallel import make_gf_mesh, sharded_gf_logp, target_sharding
    from tools.bench_gfstack import make_problem

    n_t = 2 if n_devices % 2 == 0 else 1
    mesh = make_gf_mesh(n_devices // n_t, n_t)
    lib, *stack_args = make_problem(C, T, P, D, S, N, seed=6)
    dobs = np.random.default_rng(6).normal(size=(T, N)).astype(np.float32)
    args = (*stack_args, jnp.asarray(dobs))

    def llk(lib, durations, starttimes, slips, dobs):
        def one(d, s, u):
            r = dobs - lib.stack_all(d, s, u, "multilinear")
            return -0.5 * jnp.sum(r * r)

        return jax.vmap(one)(durations, starttimes, slips)

    want = np.asarray(jax.jit(llk)(lib, *args))
    lib_spec = jax.tree_util.tree_map(lambda _: Ps("targets"), lib)
    sharded = sharded_gf_logp(mesh, llk, (lib_spec, Ps("chains"),
                                          Ps("chains", "targets"),
                                          Ps("chains"), Ps("targets")))
    got = sharded(jax.device_put(lib, target_sharding(mesh)), *args)
    assert len(got.sharding.device_set) == n_devices
    got = np.asarray(got)
    # float32 partial sums over targets reduced by psum in another order
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    assert rel <= 2e-5, f"target-sharded llk rel. error {rel:.3g} > 2e-5"
    return {"mesh": list(mesh.devices.shape), "max_rel": rel, "rtol": 2e-5}


def phase_four_pt(problem, n_devices: int = 4, n_samples: int = 40) -> dict:
    """Parallel tempering with the temperature ladder sharded over
    ``n_devices``."""
    from beat_tpu.parallel import make_chain_mesh
    from beat_tpu.samplers.pt import PTParams, pt_sample

    logp, data = problem.make_logp_fn()
    lower, upper = problem.priors.bounds_arrays()
    params = PTParams(n_chains=4 * n_devices, n_chains_posterior=n_devices,
                      n_samples=n_samples, swap_interval=(4, 8),
                      tune_interval=20, seed=2)
    q_tr, llk_tr, history = pt_sample(logp, lower, upper, params,
                                      logp_args=(data,),
                                      mesh=make_chain_mesh(n_devices))
    assert np.isfinite(np.asarray(llk_tr)).all()
    assert q_tr.shape[1] == params.n_chains_posterior
    assert history["betas"].shape[-1] == params.n_chains
    return {"n_devices": n_devices, "ladder": params.n_chains,
            "posterior_chains": params.n_chains_posterior}


# ---------------------------------------------------------------------------


def _platforms_with_cpu() -> None:
    """Keep the CPU backend beside the GPU (the reference phase needs
    it) when the environment limits JAX's platforms."""
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cuda" in plats.split(",") and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded paths")
    args = ap.parse_args(argv)
    _platforms_with_cpu()
    import jax

    info = phase_device()
    n_cards = 4 if args.four_cards else 1
    if info["count"] < n_cards:
        raise SystemExit(f"chip_smoke: {info['count']} card(s), "
                         f"{n_cards} needed")
    print(nvidia_smi(), flush=True)
    print(json.dumps({"phase": "device", **info}), flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        problem = build_fullmt(os.path.join(tmp, "fullmt"))
        if args.four_cards:
            say("four_logp", phase_four_logp, problem)
            say("four_smc", phase_four_smc, problem)
            say("four_kinematic", phase_four_kinematic)
            say("four_pt", phase_four_pt, problem)
        else:
            say("fullmt_sample", phase_fullmt_sample, problem)
            say("fullmt_reference", phase_fullmt_reference, problem)
            say("gather", phase_gather,
                problem.make_logp_fn()[1][0][0]["table"])
            say("kinematic_stack", phase_kinematic_stack)
            say("f32_llk", phase_f32_llk)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

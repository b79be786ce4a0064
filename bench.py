"""
Benchmarks of the two hot paths, on the GPU only.

1. SMC inner-loop throughput: the jitted lockstep Metropolis stage at
   the reference FullMT chain count — n_chains=2000
   (``data/examples/FullMT/config_geometry.yaml:190``) — in forward
   evaluations per second.
2. Kinematic FFI GF stack: ``SeismicGFLibrary.stack_all`` for a
   2000-chain lockstep batch (multilinear interpolation) in ms per
   lockstep evaluation (reference hot kernel ``ffi/base.py:607-709``).
3. A full FullMT SMC inversion (500 chains), wall-clock.
4. Roofline of the forward logp and the stack against the card's peaks.

Every time ends in ``block_until_ready`` (:func:`beat_tpu.profiling.
device_time`).  Every result names the device it ran on: platform,
``device_kind``, device count, and the card's name and power limit as
``nvidia-smi`` reports them.  Without a GPU the script exits non-zero.

vs_baseline: the reference publishes no numbers (BASELINE.md); we
estimate CPU BEAT's rate from its own docs: the FullMT example
(2000 chains x 300 steps x ~15 SMC stages ~= 9M forward evaluations)
takes "several hours" on 25 CPUs (``docs/examples/FullMT_regional.rst:317``)
— assume 12 h => ~208 evals/s for the whole 25-core machine.
"""

import json
import subprocess
import sys
import time

import numpy as np

#: Estimated 25-core CPU BEAT rate (see module docstring).  ERROR BAR:
#: the docs say "several hours ... few days" for the 9M-eval FullMT run
#: — 6 h ⇒ 417 evals/s, 48 h ⇒ 52 evals/s.  208 (12 h) is the point
#: estimate; vs_baseline is therefore uncertain by ~×2 either way and
#: reported to 2 significant digits only for readability.
BASELINE_EVALS_PER_SEC = 208.0
BASELINE_EVALS_RANGE = (52.0, 417.0)
FULLMT_CPU_SECONDS = 10_800.0  # documented estimate (see bench_fullmt_inversion)

N_CHAINS = 2000

#: Published peaks by ``jax.devices()[0].device_kind``: NVIDIA H100
#: Tensor Core GPU data sheet, SXM part, dense rates without sparsity,
#: at the full 700 W power limit.  A device missing here is an error.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "f32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 data sheet, SXM5, dense",
    },
}


def peaks(device_kind: str) -> dict:
    """Peak rates of ``device_kind`` from :data:`PEAKS`."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(f"no published peaks for device_kind "
                         f"{device_kind!r}; add them to bench.PEAKS "
                         f"with their source") from None


def card_name_and_power_limit():
    """``nvidia-smi``'s ``name, power.limit`` per card (``None`` where
    the tool is missing)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def device_info() -> dict:
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": card_name_and_power_limit()}


def bench_smc_evals(n_steps: int = 50):
    """Lockstep forward evaluations per second of one Metropolis stage
    of the flagship FullMT problem at 2000 chains."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _build_flagship
    from beat_tpu.profiling import device_time
    from beat_tpu.samplers.metropolis import (init_metropolis_state,
                                              run_metropolis_stage)

    problem = _build_flagship(n_stations=8, nt=256)
    logp, data = problem.make_logp_fn()
    lower, upper = problem.priors.bounds_arrays()
    dim = lower.size

    rng = np.random.default_rng(0)
    q0 = jnp.asarray(rng.uniform(lower, upper, size=(N_CHAINS, dim)),
                     dtype=jnp.float32)
    state = init_metropolis_state(logp, q0, jax.random.PRNGKey(0),
                                  logp_args=(data,))
    cov_chol = jnp.eye(dim, dtype=jnp.float32) * 0.01
    lo = jnp.asarray(lower, dtype=jnp.float32)
    hi = jnp.asarray(upper, dtype=jnp.float32)

    def stage(state, data):
        return run_metropolis_stage(
            logp, state, jnp.float32(0.7), cov_chol, lo, hi,
            n_steps=n_steps, tune_interval=1_000_000, record_every=n_steps,
            logp_args=(data,))

    return N_CHAINS * n_steps / device_time(stage, state, data, reps=5)


def bench_gf_stack(interpolation="multilinear"):
    """ms per lockstep (2000-chain) GF stack at the bench shape."""
    from beat_tpu.profiling import device_time
    from tools.bench_gfstack import batched_stack, make_problem

    args = make_problem(C=N_CHAINS, T=8, P=12, D=6, S=16, N=256)
    return device_time(batched_stack(interpolation), *args) * 1e3


def bench_fullmt_inversion(reps: int = 3):
    """
    A **full FullMT SMC inversion** (n_chains=500, n_steps=300 — the
    reference FullMT per-stage step count, ``config_geometry.yaml:190``)
    end-to-end, reported as wall-clock seconds with a posterior-moment
    check against the synthetic truth (depth 9 km, Mw 5.8).

    Runs ``reps`` times (fresh outfolder each, distinct seeds) and
    reports min/median plus a per-phase breakdown from the sampler's
    TimingRegistry records.

    vs-CPU: the reference's FullMT run (n_chains=2000) takes "several
    hours / few days" on its multi-CPU author machine
    (``docs/examples/FullMT_regional.rst:317``); assume 12 h and linear
    scaling in chains → 500 chains ≈ 3 h = 10 800 s.  Documented
    estimate, not a measurement — the reference publishes no numbers.
    """
    import shutil

    from __graft_entry__ import _build_flagship
    from beat_tpu.profiling import timings
    from beat_tpu.samplers import SMCParams

    walls, breakdowns, est = [], [], None
    for rep in range(reps):
        problem = _build_flagship(n_stations=8, nt=256)
        shutil.rmtree(problem.outfolder, ignore_errors=True)
        # buffer_thinning 25: the reference FullMT config itself thins
        # the in-stage trace 50x (config_geometry.yaml buffer_thinning)
        problem.sampler_params = SMCParams(n_chains=500, n_steps=300,
                                           buffer_thinning=25, seed=3 + rep)
        mark = len(timings.records)
        t0 = time.time()
        q_tr, _ = problem.sample()
        wall = time.time() - t0
        walls.append(wall)
        # device sampling = sum of stage-timer records; the rest is host
        # (population transfer, β bisection, covariance, stage writes).
        # Rep 0 additionally carries jit compilation inside its first
        # stage — the min/median spread across reps isolates it.
        sampling = sum(r.wall_s for r in timings.records[mark:])
        breakdowns.append({"device_sampling_s": sampling,
                           "host_transitions_io_s": wall - sampling,
                           "n_stages": len(timings.records) - mark})
        if est is None:
            final = np.asarray(q_tr[-1])
            est = problem.ordering.to_point(final.mean(axis=0))

    depth = float(np.asarray(est["depth"]))
    mag = float(np.asarray(est["magnitude"]))
    moments_ok = bool(abs(depth - 9e3) < 500.0 and abs(mag - 5.8) < 0.05)
    walls_sorted = sorted(walls)
    stats = {
        "min_s": walls_sorted[0],
        "median_s": walls_sorted[len(walls) // 2],
        "all_s": walls,
        "breakdown_median_s": {
            k: sorted(b.get(k, 0.0) for b in breakdowns)[reps // 2]
            for k in breakdowns[0]},
    }
    return stats, depth, mag, moments_ok


def bench_roofline(device_kind: str):
    """Achieved rates of the forward logp and the GF stack against the
    card's published peaks.

    * forward logp: flops and bytes from XLA's own
      ``compiled.cost_analysis()`` (its byte count includes traffic that
      fusions keep on chip, so the bandwidth share is an upper bound);
    * GF stack: algorithmic bytes — 4 corner rows read and the weights
      applied per (chain, target, patch), the output written once.
    """
    import jax.numpy as jnp

    from __graft_entry__ import _build_flagship
    from beat_tpu.profiling import batched_logp, device_time

    peak = peaks(device_kind)
    out = {}

    problem = _build_flagship(n_stations=8, nt=256)
    logp, data = problem.make_logp_fn()
    lower, upper = problem.priors.bounds_arrays()
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.uniform(lower, upper, size=(N_CHAINS, lower.size)),
                    dtype=jnp.float32)
    fn = batched_logp(logp, 1)
    ca = fn.lower(q, data).compile().cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    per_eval = device_time(fn, q, data)
    flops = float(ca.get("flops", 0.0))
    bytes_acc = float(ca.get("bytes accessed", 0.0))
    out["forward_logp"] = {
        "ms_per_lockstep_eval": per_eval * 1e3,
        "flops_per_lockstep_eval": flops,
        "bytes_per_lockstep_eval_costmodel": bytes_acc,
        "f32_flops_share": flops / per_eval / peak["f32_flops"],
        "hbm_share_costmodel": bytes_acc / per_eval / peak["hbm_bytes_per_s"],
    }

    C, T, P, D, S, N = N_CHAINS, 8, 12, 6, 16, 256
    ms = bench_gf_stack("multilinear")
    bytes_stack = 4.0 * C * T * P * N * 4 + C * T * N * 4
    out["gf_stack_multilinear"] = {
        "ms_per_lockstep_eval": ms,
        "bytes_per_lockstep_eval_algorithmic": bytes_stack,
        "hbm_share": bytes_stack / (ms / 1e3) / peak["hbm_bytes_per_s"],
    }
    return out


def main():
    info = device_info()
    if info["platform"] != "gpu":
        print(f"bench: no GPU (JAX platform {info['platform']!r}); the "
              "benchmarks measure the card only", file=sys.stderr)
        sys.exit(2)
    peaks(info["kind"])       # unknown card: fail before measuring
    evals_per_sec = bench_smc_evals()
    stack_ms = bench_gf_stack()
    inv_stats, inv_depth, inv_mag, inv_ok = bench_fullmt_inversion()
    roofline = bench_roofline(info["kind"])
    inv_wall = inv_stats["min_s"]
    print(json.dumps({
        "device": info,
        "metric": "SMC forward-model evals/sec/chip (FullMT)",
        "value": evals_per_sec,
        "unit": "evals/s",
        "vs_baseline": evals_per_sec / BASELINE_EVALS_PER_SEC,
        "extra": {
            # the reference publishes no numbers; denominators are
            # documented self-estimates with ~2x uncertainty each way
            "vs_baseline_range": [
                evals_per_sec / BASELINE_EVALS_RANGE[1],
                evals_per_sec / BASELINE_EVALS_RANGE[0]],
            "ffi_gf_stack_ms_per_2000chain_eval": stack_ms,
            "fullmt_inversion_500chain_wallclock_s": inv_wall,
            "fullmt_inversion_wall_stats": inv_stats,
            "fullmt_inversion_vs_cpu_estimate": FULLMT_CPU_SECONDS / inv_wall,
            "fullmt_posterior_depth_m": inv_depth,
            "fullmt_posterior_mag": inv_mag,
            "fullmt_posterior_moments_ok": inv_ok,
            "roofline": roofline,
        },
    }))


if __name__ == "__main__":
    main()

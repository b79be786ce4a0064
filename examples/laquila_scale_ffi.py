"""
Production-scale kinematic FFI demonstration (the reference's Laquila
example scale, ``docs/examples/FFI_kinematic.rst``: ~500 patches, GF
library in the GiB range, reference build time ~15 h on 25 CPUs and
SMC n_chains 5000-8000).

What this script does, on one GPU:

1. builds the 5-D seismic GF library natively at Laquila scale
   (default 12 targets x 500 patches x 10 durations x 32 starttimes x
   512 samples = 3.9 GiB of f32 traces), timing the build;
2. synthesizes observed waveforms from a known heterogeneous slip +
   rupture-velocity field;
3. runs lockstep SMC over the FULL kinematic parameter space
   (uparr + durations + velocities + nucleation, ~1500 dimensions at
   500 patches) through ``SeismicGFLibrary.stack_all`` — its patch-
   blocked sum keeps the 2000-chain stack within one card's memory —
   and reports the per-evaluation wall-clock and evals/s at
   n_chains=2000.

By default the stage count is capped (`--max-stages`) — the point here
is demonstrating production scale end-to-end on a single chip, not a
converged posterior (the converged toy-scale inversions live in
tests/test_ffi_kinematic.py and tests/test_config_cli.py).

Usage:
  python examples/laquila_scale_ffi.py                 # full Laquila scale
  python examples/laquila_scale_ffi.py --patches 64 --targets 4 --nt 256 \
      --chains 256 --steps 10     # laptop/CPU-sized smoke run
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--targets", type=int, default=12)
    ap.add_argument("--patches", type=int, default=500,
                    help="total patch count (fault length scales with it)")
    ap.add_argument("--nt", type=int, default=1024, help="table samples")
    ap.add_argument("--nwin", type=int, default=512, help="fit-window samples")
    ap.add_argument("--chains", type=int, default=2000)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--max-stages", type=int, default=4)
    ap.add_argument("--outdir", default="laquila_scale_run")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from beat_tpu.covariance import Covariance
    from beat_tpu.ffi import discretize_sources, seis_construct_gf_linear
    from beat_tpu.heart.gftable import build_homogeneous_table
    from beat_tpu.heart.seismic import SeismicDataset, WaveformMapping
    from beat_tpu.heart.taper import ArrivalTaper, Filter
    from beat_tpu.models.distributer import SeismicDistributerComposite
    from beat_tpu.models.laplacian import LaplacianDistributerComposite
    from beat_tpu.models.problem import Problem
    from beat_tpu.parameter import Parameter, PriorSet
    from beat_tpu.sources import RectangularSource

    rng = np.random.default_rng(0)
    dt = 0.25

    # --- fault: ~Laquila footprint, patch grid sized to --patches --------
    n_w = 10
    n_l = max(args.patches // n_w, 1)
    patch_l, patch_w = 2e3, 2e3
    ref = RectangularSource(depth=2e3, strike=135.0, dip=50.0, rake=-90.0,
                            length=n_l * patch_l, width=n_w * patch_w)
    fault = discretize_sources([ref], patch_length=patch_l, patch_width=patch_w)
    print(f"fault: {fault.npatches} patches "
          f"({n_l}x{n_w} of {patch_l/1e3:.0f}x{patch_w/1e3:.0f} km)")

    # --- stations + table ------------------------------------------------
    table = build_homogeneous_table(
        distances=np.linspace(20e3, 150e3, 12),
        depths=np.linspace(1e3, 25e3, 8), nt=args.nt, dt=dt)
    az = np.linspace(0, 2 * np.pi, args.targets, endpoint=False) + 0.3
    dist = rng.uniform(50e3, 130e3, args.targets)
    st_e, st_n = dist * np.sin(az), dist * np.cos(az)
    datasets = [SeismicDataset(station=f"ST{i:02d}", channel="Z",
                               east=st_e[i], north=st_n[i],
                               ydata=np.zeros(args.nt))
                for i in range(args.targets)]
    # taper spanning exactly --nwin samples at this dt
    wavemap = WaveformMapping(
        name="any_P", datasets=datasets, table=table,
        taper=ArrivalTaper(a=-4.0, b=-2.0,
                           c=args.nwin * dt - 10.0, d=args.nwin * dt - 4.0),
        filterer=Filter(lower_corner=0.02, upper_corner=0.5, order=3))
    nwin = wavemap.nsamples_win
    print(f"fit window: {nwin} samples at dt={dt}")

    # --- 5-D library build (the reference's 15-h step) -------------------
    t0 = time.perf_counter()
    lib = seis_construct_gf_linear(
        table, wavemap, fault, component="uparr",
        duration_bounds=(0.5, 5.0), duration_sampling=0.5,
        starttime_bounds=(0.0, 7.75), starttime_sampling=0.25)
    shape = lib.data.shape
    gib = np.prod(shape) * 4 / 2**30
    build_s = time.perf_counter() - t0
    print(f"library: {shape} = {gib:.2f} GiB built in {build_s:.1f} s")

    # --- observed data from a known kinematic rupture --------------------
    n = fault.npatches
    true_slips = rng.uniform(0.3, 2.5, n) * np.exp(
        -((np.arange(n) % n_l - n_l / 2) ** 2) / (n_l / 3) ** 2)
    true_durations = np.round(rng.uniform(0.5, 3.0, n) * 2) / 2      # on-grid
    true_st = np.asarray(fault.point2starttimes(
        0, jnp.full(n, 3000.0), 0.3 * n_l * patch_l, 1e3))
    true_st = np.round(true_st * 4) / 4                               # on-grid
    synth = np.asarray(lib.stack_all(
        jnp.asarray(true_durations),
        jnp.asarray(np.tile(true_st, (args.targets, 1))),
        jnp.asarray(true_slips), "nearest_neighbor"))
    sd = 0.02 * np.abs(synth).max()
    wavemap.data_windows = (synth + rng.normal(0, sd, synth.shape)
                            ).astype(np.float32)
    for ds in wavemap.datasets:
        ds.covariance = Covariance(data=np.eye(nwin) * sd**2)

    # --- full kinematic problem ------------------------------------------
    comp = SeismicDistributerComposite(
        [(wavemap, {"uparr": lib})], fault, slip_varnames=("uparr",),
        interpolation="multilinear")
    lap = LaplacianDistributerComposite(fault, slip_varnames=("uparr",))
    priors = (PriorSet()
              .add(Parameter("uparr", [0.0] * n, [4.0] * n))
              .add(Parameter("durations", [0.5] * n, [4.0] * n))
              .add(Parameter("velocities", [2000.0] * n, [4000.0] * n))
              .add(Parameter("nucleation_strike", [0.0], [n_l * patch_l]))
              .add(Parameter("nucleation_dip", [0.0], [n_w * patch_w])))
    problem = Problem(priors, {"seismic": comp, "laplacian": lap},
                      outfolder=args.outdir)
    dim = int(priors.bounds_arrays()[0].size)
    print(f"sampling {dim} dimensions x {args.chains} chains")

    # --- SMC with per-stage timing ---------------------------------------
    from beat_tpu.profiling import timings
    from beat_tpu.samplers import SMCParams

    timings.reset()
    t0 = time.perf_counter()
    problem.sampler_params = SMCParams(
        n_chains=args.chains, n_steps=args.steps,
        max_stages=args.max_stages, seed=1, rm_flag=True)
    try:
        problem.sample()
        capped = False
    except RuntimeError as e:      # perf demo: the stage cap is expected
        print(f"(stage cap: {e})")
        capped = True
    smc_s = time.perf_counter() - t0

    chain_evals = sum(r.n_evals or 0 for r in timings.records)
    lockstep_evals = chain_evals // max(args.chains, 1)
    per_eval_ms = smc_s / lockstep_evals * 1e3 if lockstep_evals else float("nan")
    # steady state = last stage (first stage carries XLA compilation)
    stage_ms = [r.wall_s / (r.n_evals / args.chains) * 1e3
                for r in timings.records if r.n_evals]
    print(json.dumps({
        "stage_ms_per_lockstep_eval": [round(m, 1) for m in stage_ms],
        "steady_state_ms_per_lockstep_eval":
            round(stage_ms[-1], 1) if stage_ms else None,
        "library_shape": list(map(int, shape)),
        "library_gib": round(gib, 2),
        "library_build_s": round(build_s, 1),
        "smc_dims": dim,
        "smc_chains": args.chains,
        "smc_wall_s": round(smc_s, 1),
        "smc_lockstep_evals": lockstep_evals,
        "ms_per_lockstep_eval": round(per_eval_ms, 1),
        "evals_per_sec": round(chain_evals / smc_s, 0)
        if chain_evals else None,
        "reached_beta1": not capped,
    }))


if __name__ == "__main__":
    main()

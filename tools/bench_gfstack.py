"""
Kinematic GF-stack micro-benchmark: ``SeismicGFLibrary.stack_all`` for
a lockstep chain batch, in ms per evaluation on the current device.

Usage: python tools/bench_gfstack.py C T P D S N {nearest_neighbor|multilinear}
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def make_problem(C, T, P, D, S, N, seed=0):
    """Random (T, P, D, S, N) library and per-chain stack arguments."""
    from beat_tpu.ffi import SeismicGFLibrary

    rng = np.random.default_rng(seed)
    lib = SeismicGFLibrary(
        data=jnp.asarray(rng.normal(size=(T, P, D, S, N)).astype(np.float32)),
        duration_min=0.5, duration_sampling=0.5, starttime_min=0.0,
        starttime_sampling=0.25)
    durations = jnp.asarray(rng.uniform(0.5, 2.0, (C, P)).astype(np.float32))
    starttimes = jnp.asarray(rng.uniform(0.0, 2.0, (C, T, P)).astype(np.float32))
    slips = jnp.asarray(rng.uniform(0, 3, (C, P)).astype(np.float32))
    return lib, durations, starttimes, slips


def batched_stack(interpolation):
    """Jitted chain-batched stack; the library is a jit argument."""
    return jax.jit(lambda lib, d, s, w: jax.vmap(
        lambda dd, ss, ww: lib.stack_all(dd, ss, ww, interpolation))(d, s, w))


def main():
    from beat_tpu.profiling import device_time

    C, T, P, D, S, N = map(int, sys.argv[1:7])
    interp = sys.argv[7]
    ms = device_time(batched_stack(interp),
                     *make_problem(C, T, P, D, S, N)) * 1e3
    dev = jax.devices()[0]
    print(f"{interp} C={C} T={T} P={P} D={D} S={S} N={N}: {ms:.4f} ms/eval "
          f"on {dev.platform} {dev.device_kind} x{len(jax.devices())}")


if __name__ == "__main__":
    main()

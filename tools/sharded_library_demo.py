"""
GF library target-sharded over a device mesh, built shard by shard.

The reference's recommended FFI scale (5000-8000 chains, 250-500 RVs,
``docs/examples/FFI_static.rst:299``; SURVEY §7 hard part 2) implies
5-D seismic GF libraries of tens of GB.  This demo builds a synthetic
library of ``--gib`` GiB DIRECTLY AS SHARDS over the mesh's target axis
(no single host/device copy ever exists), runs the production sharded
log-likelihood on it (``parallel.sharded_gf_logp``: each device stacks
its local target block, ``psum`` over targets) and prints the
per-device memory accounting: per-device bytes == total / devices.

Run on virtual CPU devices:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python tools/sharded_library_demo.py [--gib 20]
or on the cards of one GPU host (``--gib`` up to their summed memory).

Output: one JSON line naming the devices it ran on.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gib", type=float, default=20.0,
                    help="target library size in GiB (5-D f32 array)")
    ap.add_argument("--chains", type=int, default=8)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from beat_tpu.ffi import SeismicGFLibrary
    from beat_tpu.parallel import make_gf_mesh, sharded_gf_logp, target_sharding

    n_dev = len(jax.devices())
    assert n_dev >= 2, f"need several devices, got {n_dev}"

    # shapes: scale the target axis to hit the requested size
    Pn, D, S, N = 128, 8, 32, 640
    bytes_per_target = Pn * D * S * N * 4
    T = max(n_dev, int(round(args.gib * 2**30 / bytes_per_target / n_dev))
            * n_dev)
    total_bytes = T * bytes_per_target
    C = args.chains

    mesh = make_gf_mesh(1, n_dev)
    sharding5 = target_sharding(mesh)

    t0 = time.time()
    # 1. per-shard generation: each device's target block is created
    # locally and assembled — the full array never exists in one piece
    t_per_dev = T // n_dev
    dev_order = list(sharding5.addressable_devices_indices_map(
        (T, Pn, D, S, N)).items())
    shards5 = []
    for dev, idx in dev_order:
        t_lo = idx[0].start or 0
        rng = np.random.default_rng(1000 + t_lo)
        # f32 uniform, generated in place (no f64 temp): the content
        # only needs to be dense and non-degenerate
        block = rng.random((t_per_dev, Pn, D, S, N), dtype=np.float32)
        block -= 0.5
        shards5.append(jax.device_put(block, dev))
    data5 = jax.make_array_from_single_device_arrays(
        (T, Pn, D, S, N), sharding5, shards5)
    del shards5
    gen_s = time.time() - t0

    lib = SeismicGFLibrary(
        data=data5, duration_min=0.5, duration_sampling=0.5,
        starttime_min=0.0, starttime_sampling=0.25)

    per_dev_5d = [sh.data.nbytes for sh in data5.addressable_shards]
    assert all(b == total_bytes // n_dev for b in per_dev_5d), per_dev_5d

    rng = np.random.default_rng(7)
    durations = jnp.asarray(rng.uniform(0.5, 2.0, (C, Pn)), jnp.float32)
    starttimes = jnp.asarray(rng.uniform(0, 1.5, (C, T, Pn)), jnp.float32)
    slips = jnp.asarray(rng.uniform(0, 2, (C, Pn)), jnp.float32)
    dobs = jnp.asarray(rng.standard_normal((T, N)), jnp.float32)
    w = jnp.asarray(rng.uniform(0.5, 2.0, (T,)), jnp.float32)

    # sharded llk over the full library
    def xla_llk(lib, durations, starttimes, slips, dobs, w):
        def one(d, s, u):
            r = dobs - lib.stack_all(d, s, u, "multilinear")
            return -0.5 * jnp.sum(w[:, None] * r * r)

        return jax.vmap(one)(durations, starttimes, slips)

    lib_spec = jax.tree_util.tree_map(lambda _: P("targets"), lib)
    in_specs = (lib_spec, P("chains"), P("chains", "targets"),
                P("chains"), P("targets"), P("targets"))
    sharded_xla = sharded_gf_logp(mesh, xla_llk, in_specs=in_specs)
    t0 = time.time()
    want = np.asarray(sharded_xla(lib, durations, starttimes, slips,
                                  dobs, w))
    xla_s = time.time() - t0

    assert np.isfinite(want).all()
    dev = jax.devices()[0]
    out = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": n_dev},
        "library_shape5": [T, Pn, D, S, N],
        "library_gib": total_bytes / 2**30,
        "per_device_5d_bytes": per_dev_5d[0],
        "per_device_equals_total_over_devices": True,
        "sharded_llk_s": xla_s,
        "generate_s": gen_s,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()

"""
Chain-parallel sharding over the (virtual, 8-device) mesh: the sampler
must produce identical results sharded vs single-device, with chain
state actually distributed (replaces the reference's fork-pool tests,
e.g. ``test/test_paripool.py`` — process semantics have no analogue
here; what must hold is SPMD correctness).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from beat_tpu.parallel import (
    CHAIN_AXIS,
    chain_sharding,
    make_chain_mesh,
    pad_chains,
    replicated,
    shard_chain_state,
)
from beat_tpu.samplers.metropolis import init_metropolis_state, run_metropolis_stage


def logp(x):
    return -0.5 * jnp.sum(x * x) / 0.04


N_CHAINS = 32
DIM = 3


def make_state(key):
    rng = np.random.default_rng(0)
    q0 = jnp.asarray(rng.uniform(-1, 1, size=(N_CHAINS, DIM)), dtype=jnp.float32)
    return init_metropolis_state(logp, q0, key)


def run(state, cov_chol, lo, hi):
    final, (q_tr, llk_tr) = run_metropolis_stage(
        logp, state, jnp.float32(1.0), cov_chol, lo, hi,
        n_steps=20, tune_interval=10)
    return final


class TestChainMesh:
    def test_mesh_has_8_devices(self):
        mesh = make_chain_mesh()
        assert mesh.devices.size == 8

    def test_pad_chains(self):
        assert pad_chains(30, 8) == 32
        assert pad_chains(32, 8) == 32

    def test_sharded_equals_unsharded(self):
        key = jax.random.PRNGKey(7)
        cov_chol = jnp.eye(DIM, dtype=jnp.float32) * 0.1
        lo = jnp.full((DIM,), -2.0)
        hi = jnp.full((DIM,), 2.0)

        final_single = run(make_state(key), cov_chol, lo, hi)

        mesh = make_chain_mesh()
        state = shard_chain_state(make_state(key), mesh)
        cov_r = jax.device_put(cov_chol, replicated(mesh))
        final_sharded = run(state, cov_r,
                            jax.device_put(lo, replicated(mesh)),
                            jax.device_put(hi, replicated(mesh)))

        np.testing.assert_allclose(np.asarray(final_sharded.q),
                                   np.asarray(final_single.q), atol=1e-6)
        np.testing.assert_allclose(np.asarray(final_sharded.llk),
                                   np.asarray(final_single.llk), atol=1e-5)

    def test_state_is_actually_sharded(self):
        mesh = make_chain_mesh()
        state = shard_chain_state(make_state(jax.random.PRNGKey(0)), mesh)
        shardings = {len(d) for d in [state.q.sharding.device_set]}
        assert len(state.q.sharding.device_set) == 8
        # per-device shard holds N_CHAINS/8 rows
        shard = state.q.addressable_shards[0]
        assert shard.data.shape == (N_CHAINS // 8, DIM)

    @pytest.mark.slow
    def test_dryrun_multichip(self):
        from __graft_entry__ import dryrun_multichip

        dryrun_multichip(8)


class TestSMCMeshSharding:
    def test_smc_sharded_equals_unsharded(self, tmp_path):
        """Full SMC with the chain axis sharded over the mesh reproduces
        the single-device run (resampling gathers ride XLA collectives)."""
        from beat_tpu.samplers import SMCParams, smc_sample

        def smc_logp(x):
            return -0.5 * jnp.sum((x - 1.5) ** 2) / 0.04

        lo = np.zeros(2)
        hi = np.full(2, 3.0)
        params = SMCParams(n_chains=64, n_steps=15, seed=9)
        q1, llk1 = smc_sample(smc_logp, lo, hi, params,
                              homepath=str(tmp_path / "a"))
        mesh = make_chain_mesh()
        q2, llk2 = smc_sample(smc_logp, lo, hi, params,
                              homepath=str(tmp_path / "b"), mesh=mesh)
        np.testing.assert_allclose(q2, q1, atol=1e-6)
        np.testing.assert_allclose(llk2, llk1, atol=1e-5)

    def test_smc_mesh_size_guard(self):
        from beat_tpu.samplers import SMCParams, smc_sample

        mesh = make_chain_mesh()
        with pytest.raises(ValueError, match="multiple of the mesh"):
            smc_sample(lambda x: -jnp.sum(x**2), np.zeros(2), np.ones(2),
                       SMCParams(n_chains=50, n_steps=5), mesh=mesh)


class TestPTTemperatureSharding:
    def test_pt_sharded_equals_unsharded(self):
        """The temperature ladder sharded over the mesh must reproduce
        the single-device PT run exactly (swaps become cross-device
        permutes)."""
        from beat_tpu.samplers.pt import PTParams, pt_sample

        def pt_logp(x):
            return -0.5 * jnp.sum((x - 1.0) ** 2) / 0.09

        lo = np.zeros(2)
        hi = np.full(2, 3.0)
        params = PTParams(n_chains=16, n_chains_posterior=4, n_samples=400,
                          swap_interval=(6, 10), seed=5)
        q1, llk1, hist1 = pt_sample(pt_logp, lo, hi, params)
        mesh = make_chain_mesh()
        q2, llk2, hist2 = pt_sample(pt_logp, lo, hi, params, mesh=mesh)
        np.testing.assert_allclose(q2, q1, atol=1e-6)
        np.testing.assert_allclose(llk2, llk1, atol=1e-5)
        np.testing.assert_allclose(hist2["betas"], hist1["betas"])

    def test_pt_mesh_size_guard(self):
        from beat_tpu.samplers.pt import PTParams, pt_sample

        mesh = make_chain_mesh()
        with pytest.raises(ValueError, match="multiple of the mesh"):
            pt_sample(lambda x: -jnp.sum(x**2), np.zeros(2), np.ones(2),
                      PTParams(n_chains=10, n_chains_posterior=2,
                               n_samples=40), mesh=mesh)


class TestGFTargetSharding:
    """GF-library model parallelism (memory-budget path): the 5-D kinematic
    library is split along its targets axis over a (chains, targets)
    mesh, each device stacks its local block, and the llk completes via
    psum — sharded result must equal the single-device computation."""

    def test_kinematic_llk_target_sharded(self):
        from jax.sharding import PartitionSpec as P

        from beat_tpu.ffi import SeismicGFLibrary
        from beat_tpu.parallel import (make_gf_mesh, sharded_gf_logp,
                                       target_sharding)

        C, T, Pn, D, S, N = 8, 8, 6, 4, 8, 64
        rng = np.random.default_rng(0)
        lib = SeismicGFLibrary(
            data=jnp.asarray(rng.normal(size=(T, Pn, D, S, N)).astype(np.float32)),
            duration_min=0.5, duration_sampling=0.5,
            starttime_min=0.0, starttime_sampling=0.25)
        durations = jnp.asarray(rng.uniform(0.5, 2.0, (C, Pn)).astype(np.float32))
        starttimes = jnp.asarray(rng.uniform(0, 1.5, (C, T, Pn)).astype(np.float32))
        slips = jnp.asarray(rng.uniform(0, 2, (C, Pn)).astype(np.float32))
        dobs = jnp.asarray(rng.normal(size=(T, N)).astype(np.float32))
        w = jnp.asarray(rng.uniform(0.5, 2.0, (T,)).astype(np.float32))

        def full_llk(lib, durations, starttimes, slips, dobs, w):
            def one(d, s, u):
                synth = lib.stack_all(d, s, u, "multilinear")   # (T, N)
                r = dobs - synth
                return -0.5 * jnp.sum(w[:, None] * r * r)

            return jax.vmap(one)(durations, starttimes, slips)

        want = np.asarray(jax.jit(full_llk)(lib, durations, starttimes,
                                            slips, dobs, w))

        mesh = make_gf_mesh(2, 4)
        assert mesh.devices.shape == (2, 4)

        # per-block partial llk: identical code, local target block
        lib_spec = jax.tree_util.tree_map(lambda _: P("targets"), lib)
        sharded = sharded_gf_logp(
            mesh, full_llk,
            in_specs=(lib_spec, P("chains"), P("chains", "targets"),
                      P("chains"), P("targets"), P("targets")))

        lib_sh = jax.device_put(lib, target_sharding(mesh))
        got = sharded(lib_sh, durations, starttimes, slips, dobs, w)
        # library truly distributed: each device holds T/4 targets
        assert lib_sh.data.addressable_shards[0].data.shape[0] == T // 4
        assert len(got.sharding.device_set) >= 2   # chain-sharded output
        np.testing.assert_allclose(np.asarray(got), want, rtol=2e-5)


class TestMALASharding:
    """The gradient-based MALA/HMC steps must shard exactly like the
    random walk: identical results on the chain mesh vs a single
    device."""

    def test_hmc_sharded_equals_unsharded(self):
        key = jax.random.PRNGKey(13)
        cov_chol = jnp.eye(DIM, dtype=jnp.float32) * 0.1
        lo = jnp.full((DIM,), -2.0)
        hi = jnp.full((DIM,), 2.0)

        def run_hmc(state, chol, lo_, hi_):
            final, _ = run_metropolis_stage(
                logp, state, jnp.float32(1.0), chol, lo_, hi_,
                n_steps=12, proposal_name="HMC", tune_interval=10,
                n_leapfrog=4)
            return final

        final_single = run_hmc(make_state(key), cov_chol, lo, hi)

        mesh = make_chain_mesh()
        state = shard_chain_state(make_state(key), mesh)
        rep = replicated(mesh)
        final_sharded = run_hmc(state, jax.device_put(cov_chol, rep),
                                jax.device_put(lo, rep),
                                jax.device_put(hi, rep))

        assert len(final_sharded.q.sharding.device_set) == 8
        np.testing.assert_allclose(np.asarray(final_sharded.q),
                                   np.asarray(final_single.q), atol=1e-6)
        np.testing.assert_allclose(np.asarray(final_sharded.llk),
                                   np.asarray(final_single.llk), atol=1e-5)

    def test_mala_sharded_equals_unsharded(self):
        key = jax.random.PRNGKey(11)
        cov_chol = jnp.eye(DIM, dtype=jnp.float32) * 0.1
        lo = jnp.full((DIM,), -2.0)
        hi = jnp.full((DIM,), 2.0)

        def run_mala(state, chol, lo_, hi_):
            final, _ = run_metropolis_stage(
                logp, state, jnp.float32(1.0), chol, lo_, hi_,
                n_steps=20, proposal_name="MALA", tune_interval=10)
            return final

        final_single = run_mala(make_state(key), cov_chol, lo, hi)

        mesh = make_chain_mesh()
        state = shard_chain_state(make_state(key), mesh)
        rep = replicated(mesh)
        final_sharded = run_mala(state, jax.device_put(cov_chol, rep),
                                 jax.device_put(lo, rep),
                                 jax.device_put(hi, rep))

        assert len(final_sharded.q.sharding.device_set) == 8
        np.testing.assert_allclose(np.asarray(final_sharded.q),
                                   np.asarray(final_single.q), atol=1e-6)
        np.testing.assert_allclose(np.asarray(final_sharded.llk),
                                   np.asarray(final_single.llk), atol=1e-5)

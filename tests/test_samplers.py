"""
Sampler acceptance tests on analytic toy posteriors.

Ports the reference's sampler verification strategy:
* ``test/test_smc.py:38-115`` — SMC on a 4-D two-Gaussian mixture;
  posterior mean of |x| must match the mode location within atol=0.03.
* ``test/test_pt.py`` — the same mixture via parallel tempering.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from beat_tpu.samplers import (
    PTParams,
    SMCParams,
    calc_beta,
    metropolis_sample,
    pt_sample,
    smc_sample,
    systematic_resample,
)

N_DIM = 4
MU1 = np.ones(N_DIM) * 0.5
MU2 = -MU1
STDEV = 0.1


def make_mixture_logp():
    """4-D two-Gaussian mixture (weights 0.1/0.9), as in the reference test."""
    sigma = STDEV**2 * jnp.eye(N_DIM)
    isigma = jnp.linalg.inv(sigma)
    _, ldet = jnp.linalg.slogdet(sigma)
    mu1 = jnp.asarray(MU1, dtype=jnp.float32)
    mu2 = jnp.asarray(MU2, dtype=jnp.float32)
    w1, w2 = STDEV, 1.0 - STDEV
    log_norm = -0.5 * N_DIM * jnp.log(2 * jnp.pi) - 0.5 * ldet

    def logp(x):
        d1 = x - mu1
        d2 = x - mu2
        l1 = log_norm - 0.5 * d1 @ isigma @ d1
        l2 = log_norm - 0.5 * d2 @ isigma @ d2
        return jnp.logaddexp(jnp.log(w1) + l1, jnp.log(w2) + l2)

    return logp


LOWER = -2.0 * np.ones(N_DIM)
UPPER = 2.0 * np.ones(N_DIM)


class TestSMC:
    def test_two_gaussians(self, tmp_path):
        logp = make_mixture_logp()
        params = SMCParams(n_chains=100, n_steps=100, tune_interval=25, seed=123)
        q_tr, llk_tr = smc_sample(logp, LOWER, UPPER, params, homepath=str(tmp_path / "smc"))
        # final positions of all chains at beta=1
        x = q_tr[-1]  # (n_chains, dim)
        mu1d = np.abs(x).mean(axis=0)
        np.testing.assert_allclose(MU1, mu1d, rtol=0.0, atol=0.03)

    def test_resume(self, tmp_path):
        logp = make_mixture_logp()
        home = str(tmp_path / "smc_resume")
        params = SMCParams(n_chains=50, n_steps=40, seed=7)
        q1, _ = smc_sample(logp, LOWER, UPPER, params, homepath=home)
        # resume request on completed run returns saved final stage
        params2 = SMCParams(n_chains=50, n_steps=40, seed=7, stage=-1)
        q2, _ = smc_sample(logp, LOWER, UPPER, params2, homepath=home)
        np.testing.assert_allclose(q1, q2)

    def test_rm_flag_clears_stale_stages(self, tmp_path):
        """A fresh run with rm_flag=True removes previous-run stage dirs
        so a later resume cannot pick up an old run's checkpoints
        (reference clean_directory, backend.py:1079)."""
        import os

        logp = make_mixture_logp()
        home = str(tmp_path / "smc_rm")
        stale = os.path.join(home, "stage_97")
        os.makedirs(stale)
        params = SMCParams(n_chains=20, n_steps=10, seed=7, rm_flag=True)
        smc_sample(logp, LOWER, UPPER, params, homepath=home)
        assert not os.path.exists(stale)
        assert os.path.exists(os.path.join(home, "stage_-1"))


class TestSMCMath:
    def test_calc_beta_monotone(self):
        llks = np.random.default_rng(0).normal(size=200) * 50
        beta, old, weights = calc_beta(0.0, llks, 1.0)
        assert 0 < beta <= 2.0
        assert old == 0.0
        np.testing.assert_allclose(weights.sum(), 1.0)
        # tighter coef_variation -> smaller beta step
        beta_tight, _, _ = calc_beta(0.0, llks, 0.2)
        assert beta_tight < beta

    def test_systematic_resample_proportional(self):
        rng = np.random.default_rng(0)
        weights = np.array([0.5, 0.25, 0.125, 0.125])
        idx = systematic_resample(weights, rng)
        counts = np.bincount(idx, minlength=4)
        # systematic resampling: counts within 1 of expectation N*w
        expect = weights * weights.size
        assert np.all(np.abs(counts - expect) <= 1)

    def test_resample_identity_on_uniform(self):
        rng = np.random.default_rng(0)
        n = 16
        idx = systematic_resample(np.full(n, 1.0 / n), rng)
        np.testing.assert_array_equal(np.sort(idx), np.arange(n))


class TestMetropolis:
    def test_gaussian_moments(self):
        """Adaptive MH recovers mean/std of a correlated 2-D Gaussian."""
        cov = jnp.asarray([[0.04, 0.02], [0.02, 0.09]])
        icov = jnp.linalg.inv(cov)
        mu = jnp.asarray([0.3, -0.2])

        def logp(x):
            d = x - mu
            return -0.5 * d @ icov @ d

        q_tr, _ = metropolis_sample(
            logp, np.array([-2.0, -2.0]), np.array([2.0, 2.0]),
            n_chains=32, n_steps=1500, burn=0.4, thin=2, seed=3)
        samples = q_tr.reshape(-1, 2)
        np.testing.assert_allclose(samples.mean(axis=0), np.asarray(mu), atol=0.05)
        np.testing.assert_allclose(samples.std(axis=0),
                                   np.sqrt(np.diag(np.asarray(cov))), rtol=0.25)


class TestStageMechanics:
    """run_metropolis_stage thinning + segmented tuning semantics."""

    def _setup(self, n_chains=8):
        from beat_tpu.samplers.metropolis import init_metropolis_state

        logp = make_mixture_logp()
        rng = np.random.default_rng(0)
        q0 = rng.uniform(LOWER, UPPER, size=(n_chains, N_DIM))
        state = init_metropolis_state(
            logp, jnp.asarray(q0, dtype=jnp.float32), jax.random.PRNGKey(0))
        lo = jnp.asarray(LOWER, dtype=jnp.float32)
        hi = jnp.asarray(UPPER, dtype=jnp.float32)
        chol = jnp.eye(N_DIM, dtype=jnp.float32) * 0.1
        return logp, state, lo, hi, chol

    def test_thinned_recording_runs_all_steps(self):
        """record_every must not change the chain path: the final state
        equals the record_every=1 run (same RNG), including when
        record_every exceeds or does not divide n_steps."""
        from beat_tpu.samplers.metropolis import run_metropolis_stage

        logp, state, lo, hi, chol = self._setup()
        ref, (q_ref, _) = run_metropolis_stage(
            logp, state, jnp.float32(1.0), chol, lo, hi,
            n_steps=10, record_every=1)
        for record_every, n_rows in [(3, 4), (5, 2), (30, 1)]:
            fin, (q_tr, llk_tr) = run_metropolis_stage(
                logp, state, jnp.float32(1.0), chol, lo, hi,
                n_steps=10, record_every=record_every)
            np.testing.assert_allclose(np.asarray(fin.q), np.asarray(ref.q),
                                       err_msg=f"record_every={record_every}")
            assert q_tr.shape[0] == n_rows
            # last recorded row is always the final state
            np.testing.assert_allclose(np.asarray(q_tr[-1]),
                                       np.asarray(fin.q))

    def test_step_offset_enables_segmented_tuning(self):
        """Scale tuning fires on GLOBAL step boundaries: segments shorter
        than tune_interval still retune once their accumulated step count
        crosses the interval (the PT segment pattern)."""
        from beat_tpu.samplers.metropolis import run_metropolis_stage

        logp, state, lo, hi, _ = self._setup()
        # gigantic proposals => acceptance ~0 => tune factor 0.1
        chol_huge = jnp.eye(N_DIM, dtype=jnp.float32) * 100.0

        offset = 0
        for _ in range(3):  # 3 segments x 4 steps, tune_interval=10
            state, _ = run_metropolis_stage(
                logp, state, jnp.float32(1.0), chol_huge, lo, hi,
                n_steps=4, tune_interval=10, tune=True,
                step_offset=np.int32(offset))
            offset += 4
        # global step 10 was crossed inside the third segment
        assert np.all(np.asarray(state.scaling) < 1.0), \
            "tuning never fired across segments"


class TestPT:
    def test_two_gaussians(self):
        logp = make_mixture_logp()
        params = PTParams(
            n_chains=8, n_chains_posterior=2, n_samples=12000,
            swap_interval=(10, 16), beta_tune_interval=2000, seed=11)
        q_tr, llk_tr, history = pt_sample(logp, LOWER, UPPER, params)
        # discard burn-in half, pool posterior replicas
        n_burn = q_tr.shape[0] // 2
        x = q_tr[n_burn:].reshape(-1, N_DIM)
        mu1d = np.abs(x).mean(axis=0)
        # PT with few chains: looser tolerance than SMC
        np.testing.assert_allclose(MU1, mu1d, rtol=0.0, atol=0.08)
        assert history["betas"][0] == 1.0
        assert np.all(np.diff(history["betas"]) <= 0)


class TestMALA:
    """Gradient-based MALA step (a JAX-native capability: autodiff
    provides gradients the reference's random-walk samplers never use)."""

    def test_gaussian_posterior_exact(self):
        """MALA must target the correct stationary distribution: sample
        a correlated 2-D Gaussian and check both moments."""
        from beat_tpu.samplers.metropolis import (init_metropolis_state,
                                                  run_metropolis_stage)

        cov = np.array([[0.04, 0.018], [0.018, 0.02]])
        icov = jnp.asarray(np.linalg.inv(cov), dtype=jnp.float32)
        mu = jnp.asarray([0.7, -0.4])

        def logp(x):
            d = x - mu
            return -0.5 * d @ icov @ d

        n = 256
        rng = np.random.default_rng(0)
        lo = jnp.asarray([-3.0, -3.0])
        hi = jnp.asarray([3.0, 3.0])
        q0 = jnp.asarray(rng.uniform(-1, 1, (n, 2)), dtype=jnp.float32)
        state = init_metropolis_state(logp, q0, jax.random.PRNGKey(1))
        chol = jnp.eye(2, dtype=jnp.float32) * 0.2
        final, (q_tr, _) = run_metropolis_stage(
            logp, state, jnp.float32(1.0), chol, lo, hi,
            n_steps=800, proposal_name="MALA", tune_interval=50)
        # discard burn-in; moments over chains x steps
        draws = np.asarray(q_tr[400:]).reshape(-1, 2)
        np.testing.assert_allclose(draws.mean(axis=0), np.asarray(mu),
                                   atol=0.02)
        np.testing.assert_allclose(np.cov(draws.T), cov, atol=0.01)
        # step size retuned toward the 0.574 optimum
        acc = np.asarray(final.acc_total) / 800
        assert 0.3 < acc.mean() < 0.9

    def test_mala_mixes_faster_than_random_walk_in_high_dim(self):
        """In a 32-D Gaussian, MALA's per-eval mixing must beat the
        random walk's (the reason to use gradients at all): compare the
        lag-1 autocorrelation of the first coordinate."""
        from beat_tpu.samplers.metropolis import (init_metropolis_state,
                                                  run_metropolis_stage)

        dim = 32

        def logp(x):
            return -0.5 * jnp.sum(x * x) / 0.01

        n = 64
        rng = np.random.default_rng(2)
        lo = jnp.full((dim,), -2.0)
        hi = jnp.full((dim,), 2.0)
        q0 = jnp.asarray(rng.normal(0, 0.1, (n, dim)), dtype=jnp.float32)
        chol = jnp.eye(dim, dtype=jnp.float32) * 0.1

        def rho1(name):
            state = init_metropolis_state(logp, q0, jax.random.PRNGKey(3))
            _, (q_tr, _) = run_metropolis_stage(
                logp, state, jnp.float32(1.0), chol, lo, hi,
                n_steps=600, proposal_name=name, tune_interval=50)
            x = np.asarray(q_tr[300:, :, 0])     # (steps, chains)
            x = x - x.mean(axis=0)
            num = (x[1:] * x[:-1]).sum(axis=0)
            den = (x * x).sum(axis=0)
            return float(np.mean(num / den))

        r_mala = rho1("MALA")
        r_rw = rho1("MultivariateNormal")
        assert r_mala < r_rw - 0.05, (r_mala, r_rw)

    def test_smc_with_mala_proposal(self, tmp_path):
        """The staged SMC driver accepts proposal_name='MALA' end-to-end
        and recovers the mixture mode location."""
        logp = make_mixture_logp()
        params = SMCParams(n_chains=100, n_steps=60, tune_interval=20,
                           seed=5, proposal_name="MALA")
        q_tr, llk_tr = smc_sample(logp, LOWER, UPPER, params,
                                  homepath=str(tmp_path / "smc_mala"))
        x = np.asarray(q_tr[-1])
        np.testing.assert_allclose(MU1, np.abs(x).mean(axis=0), atol=0.03)


class TestHMC:
    """Multi-step leapfrog HMC (generalizes MALA; the reference has no
    gradient-based kernel at all — beat/sampler/metropolis.py is
    random-walk only)."""

    def test_gaussian_posterior_exact(self):
        """HMC must target the correct stationary distribution: sample a
        correlated 2-D Gaussian and check both moments."""
        from beat_tpu.samplers.metropolis import (init_metropolis_state,
                                                  run_metropolis_stage)

        cov = np.array([[0.04, 0.018], [0.018, 0.02]])
        icov = jnp.asarray(np.linalg.inv(cov), dtype=jnp.float32)
        mu = jnp.asarray([0.7, -0.4])

        def logp(x):
            d = x - mu
            return -0.5 * d @ icov @ d

        n = 256
        rng = np.random.default_rng(7)
        lo = jnp.asarray([-3.0, -3.0])
        hi = jnp.asarray([3.0, 3.0])
        q0 = jnp.asarray(rng.uniform(-1, 1, (n, 2)), dtype=jnp.float32)
        state = init_metropolis_state(logp, q0, jax.random.PRNGKey(11))
        chol = jnp.eye(2, dtype=jnp.float32) * 0.2
        final, (q_tr, _) = run_metropolis_stage(
            logp, state, jnp.float32(1.0), chol, lo, hi,
            n_steps=400, proposal_name="HMC", tune_interval=50,
            n_leapfrog=5)
        draws = np.asarray(q_tr[200:]).reshape(-1, 2)
        np.testing.assert_allclose(draws.mean(axis=0), np.asarray(mu),
                                   atol=0.02)
        np.testing.assert_allclose(np.cov(draws.T), cov, atol=0.01)
        # step size retuned toward the 0.651 optimum
        acc = np.asarray(final.acc_total) / 400
        assert 0.35 < acc.mean() < 0.95

    def test_hmc_decorrelates_faster_than_mala(self):
        """The point of the trajectory: per TRANSITION, an L-step HMC
        draw must be less autocorrelated than a MALA (L=1) draw in a
        badly-scaled Gaussian."""
        from beat_tpu.samplers.metropolis import (init_metropolis_state,
                                                  run_metropolis_stage)

        dim = 16
        scales = jnp.asarray(np.geomspace(0.05, 0.5, dim), dtype=jnp.float32)

        def logp(x):
            return -0.5 * jnp.sum((x / scales) ** 2)

        n = 64
        rng = np.random.default_rng(3)
        lo = jnp.full((dim,), -4.0)
        hi = jnp.full((dim,), 4.0)
        q0 = jnp.asarray(rng.normal(0, 0.05, (n, dim)), dtype=jnp.float32)
        chol = jnp.eye(dim, dtype=jnp.float32) * 0.1

        def rho1(name, n_leapfrog=8):
            state = init_metropolis_state(logp, q0, jax.random.PRNGKey(5))
            _, (q_tr, _) = run_metropolis_stage(
                logp, state, jnp.float32(1.0), chol, lo, hi,
                n_steps=500, proposal_name=name, tune_interval=50,
                n_leapfrog=n_leapfrog)
            x = np.asarray(q_tr[250:, :, -1])   # worst-scaled coordinate
            x = x - x.mean(axis=0)
            num = (x[1:] * x[:-1]).sum(axis=0)
            den = (x * x).sum(axis=0)
            return float(np.mean(num / den))

        r_hmc = rho1("HMC")
        r_mala = rho1("MALA")
        assert r_hmc < r_mala - 0.05, (r_hmc, r_mala)

    def test_smc_with_hmc_proposal(self, tmp_path):
        """The staged SMC driver accepts proposal_name='HMC' end-to-end
        and recovers the mixture mode location."""
        logp = make_mixture_logp()
        params = SMCParams(n_chains=128, n_steps=60, tune_interval=20,
                           seed=9, proposal_name="HMC", n_leapfrog=5)
        q_tr, llk_tr = smc_sample(logp, LOWER, UPPER, params,
                                  homepath=str(tmp_path / "smc_hmc"))
        x = np.asarray(q_tr[-1])
        np.testing.assert_allclose(MU1, np.abs(x).mean(axis=0), atol=0.03)


def test_smc_log_evidence_gaussian(tmp_path):
    """The transitional-MCMC evidence estimator (product of per-stage
    mean incremental weights, Ching & Chen 2007) must recover the
    analytic marginal likelihood of a Gaussian likelihood under a
    uniform box prior: Z = (2*pi*sigma^2)^{d/2} / vol(box) for a
    2-D isotropic Gaussian fully inside the box."""
    from beat_tpu.backend import SampleStage

    sigma2 = 0.04
    mu = jnp.asarray([0.3, -0.2])

    def logp(x):
        return -0.5 * jnp.sum((x - mu) ** 2) / sigma2

    lo = np.full(2, -2.0)
    hi = np.full(2, 2.0)
    params = SMCParams(n_chains=1500, n_steps=30, tune_interval=15, seed=3)
    home = str(tmp_path / "evidence")
    smc_sample(logp, lo, hi, params, homepath=home, progress=False)
    state = SampleStage(home).load_state(-1)
    log_z = float(state["log_evidence"])
    want = float(np.log(2 * np.pi * sigma2 / 16.0))
    assert abs(log_z - want) < 0.15, (log_z, want)

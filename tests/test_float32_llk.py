"""
Float32 device-likelihood verification against a float64 host reference
(SURVEY §7 hard part 6): the production likelihood runs in float32 —
this quantifies the error at realistic scales (nsamples ≥ 1024,
covariance condition number ≥ 1e6) and asserts the quantity that
matters for sampling: the error in log-likelihood DIFFERENCES between
nearby points (which sets accept-probability distortion), not the
absolute llk value (a common bias cancels in the Metropolis ratio and
in importance weights).  The harness is ``chip_smoke.f32_llk_check``,
which the smoke check also runs on the card.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from beat_tpu.distributions import multivariate_normal_chol
from chip_smoke import f32_llk_check


def _correlated_cov(n, corr_len=30.0, nugget=1e-7, sigma=1.0):
    idx = np.arange(n)
    d = np.abs(idx[:, None] - idx[None, :]) / corr_len
    return sigma**2 * (np.exp(-d * d) + nugget * np.eye(n))


class TestFloat32Likelihood:
    @pytest.mark.parametrize("n,corr_len", [(1024, 30.0), (2048, 80.0)])
    def test_llk_differences_beat_sampler_noise(self, n, corr_len):
        out = f32_llk_check(n, corr_len)
        assert out["cond"] > 1e6
        assert out["diff_err"] < out["diff_tol"]

    def test_batched_matches_single(self):
        rng = np.random.default_rng(1)
        from beat_tpu.distributions import multivariate_normal_chol_batched

        n, D = 256, 3
        C = _correlated_cov(n, corr_len=10.0)
        chol_inv = np.linalg.inv(np.linalg.cholesky(C))
        _, lp = np.linalg.slogdet(C)
        res = rng.normal(size=(D, n))
        hs = np.array([0.0, 0.2, -0.1])
        batched = np.asarray(multivariate_normal_chol_batched(
            jnp.asarray(res, dtype=jnp.float32),
            jnp.asarray(np.tile(chol_inv, (D, 1, 1)), dtype=jnp.float32),
            jnp.full((D,), lp, dtype=jnp.float32),
            jnp.asarray(hs, dtype=jnp.float32),
            jnp.full((D,), n, dtype=jnp.float32)))
        singles = [float(multivariate_normal_chol(
            jnp.asarray(res[i], dtype=jnp.float32),
            jnp.asarray(chol_inv, dtype=jnp.float32),
            jnp.float32(lp), jnp.float32(hs[i])))
            for i in range(D)]
        np.testing.assert_allclose(batched, singles, rtol=2e-5)

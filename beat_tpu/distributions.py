"""
On-device likelihood functions.

JAX re-design of ``beat/models/distributions.py``: the reference builds a
pytensor graph per dataset in a Python loop; here each likelihood is a pure
function over stacked/padded arrays so that one fused XLA computation
covers all datasets and ``vmap`` adds the chains axis.

Hyperparameter semantics (reference ``distributions.py:119-140``): the
noise hyperparameter ``h`` scales a dataset covariance as ``exp(2h)``, so

    logp = -0.5 * ( slog_pdet + M*(2h + log 2π) + exp(-2h) * ||W r||² )

where ``W`` is the inverse Cholesky factor of the covariance (lower), and
``slog_pdet`` its log pseudo-determinant.

Precision: a float32 matmul with no stated precision may run in TF32 on
the GPU (about three decimal digits).  Whitening by ``W`` amplifies such
rounding of the synthetics past the sampler's noise (see
``GreensTable.astype``), so every log-likelihood the samplers evaluate
is traced under :func:`pinned_precision`.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

LOG_2PI = math.log(2.0 * math.pi)

#: matmul precision of every likelihood evaluation (see module docstring)
LIKELIHOOD_PRECISION = "highest"


def pinned_precision(fn, precision: str = LIKELIHOOD_PRECISION):
    """``fn`` traced with every float32 matmul at ``precision``: each
    ``dot_general`` inside it, nested jits included, carries it in the
    jaxpr.  The unpinned function stays reachable as ``__wrapped__``."""

    @functools.wraps(fn)
    def pinned(*args, **kwargs):
        with jax.default_matmul_precision(precision):
            return fn(*args, **kwargs)

    return pinned


def multivariate_normal_chol(residual, chol_inverse, slog_pdet, hyperparam, nsamples=None):
    """
    Gaussian log-likelihood of one dataset with Cholesky-inverse weighting
    and noise-scaling hyperparameter (reference
    ``models/distributions.py:72-140``).

    Parameters
    ----------
    residual : (M,) array — observed minus synthetic.
    chol_inverse : (M, M) array — inverse of lower Cholesky factor of the
        data covariance (``Covariance.chol_inverse``, ``beat/heart.py:212``).
    slog_pdet : scalar — log determinant of the covariance.
    hyperparam : scalar — noise log-std-scale ``h``.
    nsamples : static int — number of valid samples M (defaults to len).
    """
    M = residual.shape[-1] if nsamples is None else nsamples
    tmp = chol_inverse @ residual
    norm = M * (2.0 * hyperparam + LOG_2PI)
    return -0.5 * (slog_pdet + norm + jnp.exp(-2.0 * hyperparam) * jnp.dot(tmp, tmp))


def multivariate_normal_chol_batched(residuals, chol_inverses, slog_pdets, hyperparams, nsamples):
    """
    Batched over datasets: all inputs carry a leading dataset axis; padded
    datasets must have zero rows in ``chol_inverses`` beyond their length.

    residuals : (D, M) ; chol_inverses : (D, M, M) ; slog_pdets : (D,) ;
    hyperparams : (D,) ; nsamples : (D,) int array of true lengths.
    Returns (D,) per-dataset log-likelihoods.
    """
    tmp = jnp.einsum("dij,dj->di", chol_inverses, residuals)
    quad = jnp.sum(tmp * tmp, axis=-1)
    norm = nsamples * (2.0 * hyperparams + LOG_2PI)
    return -0.5 * (slog_pdets + norm + jnp.exp(-2.0 * hyperparams) * quad)


def hyper_normal(residuals_fixed, slog_pdets, hyperparams, nsamples):
    """
    Hyperparameter-only likelihood on fixed residuals (reference
    ``distributions.py:176``): identical math, but residual weighting can be
    precomputed once.  ``residuals_fixed`` here are the *weighted* squared
    norms ``||W r||²`` per dataset, shape (D,).
    """
    norm = nsamples * (2.0 * hyperparams + LOG_2PI)
    return -0.5 * (slog_pdets + norm + jnp.exp(-2.0 * hyperparams) * residuals_fixed)


def cumulative_normal(x, s=math.sqrt(2.0)):
    return 0.5 + 0.5 * jax.scipy.special.erf(x / s)


def polarity_llk(obs_polarities, syn_amplitudes, gamma, sigma):
    """
    First-motion polarity likelihood (Weber 2018 GJI eq. 6-7; reference
    ``distributions.py:150``).  obs in {-1, +1}; returns per-observation
    log-likelihoods.
    """
    p_i = gamma + (1.0 - 2.0 * gamma) * cumulative_normal(syn_amplitudes / sigma)
    p_i = jnp.clip(p_i, 1e-12, 1.0 - 1e-12)
    return ((1.0 + obs_polarities) / 2.0) * jnp.log(p_i) + (
        (1.0 - obs_polarities) / 2.0
    ) * jnp.log(1.0 - p_i)


def vonmises_fisher_logpdf(x, mu, kappa):
    """
    Von Mises-Fisher log-density on S² (reference ``distributions.py:245``,
    used for directional statistics in plotting).
    """
    norm = jnp.log(kappa) - jnp.log(2.0 * jnp.pi) - kappa - jnp.log1p(-jnp.exp(-2.0 * kappa))
    return norm + kappa * jnp.sum(x * mu, axis=-1)


def uniform_prior_logp(q, lower, upper):
    """
    Flat-box prior log-density: 0-normalised inside, -inf outside.  The
    reference evaluates pymc's prior logp for bound checks
    (``sampler/metropolis.py:335-343``); only finiteness matters for the
    Metropolis accept, so we keep the unnormalised form with the correct
    -inf support boundary.
    """
    inside = jnp.all((q >= lower) & (q <= upper), axis=-1)
    return jnp.where(inside, 0.0, -jnp.inf)

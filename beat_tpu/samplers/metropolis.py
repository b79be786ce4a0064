"""
Vmapped adaptive Metropolis: every Markov chain is one row of a device
array; one ``lax.scan`` advances all chains in lockstep.

Replaces the reference's per-chain Python step loop + fork pool
(``beat/sampler/metropolis.py`` ``astep`` :276 and
``beat/sampler/base.py`` ``iter_parallel_chains`` :428).  Semantics kept:

* proposal scaled by a per-chain adaptive ``scaling`` retuned every
  ``tune_interval`` steps from the chain's acceptance fraction using the
  pymc tuning table;
* hard prior-bound check: out-of-bounds proposals are rejected without
  counting the forward model (we still *compute* it in lockstep — the
  proposal is clipped into bounds for numerical safety and the result
  masked);
* tempered accept: ``log u < beta * (llk' - llk)`` (+ prior ratio, which
  is zero for in-bounds uniform boxes).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from beat_tpu.samplers.base import choose_proposal

logger = logging.getLogger("beat_tpu.metropolis")


def tune_scale(scale, acc_rate):
    """
    pymc/reference step-scale tuning table
    (reference ``sampler/metropolis.py:318`` via pymc ``tune``):

      <0.001: x0.1   <0.05: x0.5   <0.2: x0.9
      >0.95:  x10    >0.75: x2     >0.5:  x1.1
    """
    factors = jnp.select(
        [acc_rate < 0.001, acc_rate < 0.05, acc_rate < 0.2,
         acc_rate > 0.95, acc_rate > 0.75, acc_rate > 0.5],
        [0.1, 0.5, 0.9, 10.0, 2.0, 1.1],
        default=1.0,
    )
    return scale * factors


@dataclass
class MetropolisParams:
    """Single-stage adaptive-Metropolis configuration
    (reference ``MetropolisConfig`` ``config.py:1771``)."""

    n_chains: int = 20
    n_steps: int = 25000
    burn: float = 0.1
    thin: int = 2
    tune_interval: int = 100
    proposal_name: str = "MultivariateNormal"
    #: leapfrog steps per transition when proposal_name == "HMC"
    n_leapfrog: int = 10
    seed: int = 0


class MetropolisState(NamedTuple):
    """Carried state of all chains (leading axis = chains)."""

    q: jax.Array          # (n_chains, dim) current positions
    llk: jax.Array        # (n_chains,) current data log-likelihoods
    scaling: jax.Array    # (n_chains,) adaptive proposal scale
    accepted: jax.Array   # (n_chains,) accepts since last tune
    acc_total: jax.Array  # (n_chains,) accepts in this stage
    key: jax.Array        # PRNG key


@partial(jax.jit, static_argnums=(0,))
def batched_llk(logp_fn: Callable, q, logp_args: tuple = ()):
    """Jitted vmapped log-likelihood of a whole population.

    MUST stay jitted: an eager ``jax.vmap`` executes op-by-op, one
    kernel launch and host round-trip per op, instead of one fused
    program.  ``logp_args`` ride as jit ARGUMENTS: a GF table closed
    over would be folded into the executable as a constant."""
    return jax.vmap(lambda q1: logp_fn(q1, *logp_args))(q)


def init_metropolis_state(logp_fn: Callable, q0: np.ndarray, key, scale: float = 1.0,
                          logp_args: tuple = ()) -> MetropolisState:
    """Evaluate the likelihood of the start population and build the state.

    ``logp_args``: extra pytree arguments forwarded to ``logp_fn(q, *logp_args)``
    — GF tables/weights passed as jit arguments, not closure constants."""
    q0 = jnp.asarray(q0)
    llk0 = batched_llk(logp_fn, q0, logp_args)
    n = q0.shape[0]
    return MetropolisState(
        q=q0,
        llk=llk0,
        scaling=jnp.full((n,), float(scale)),
        accepted=jnp.zeros((n,)),
        acc_total=jnp.zeros((n,)),
        key=key,
    )


def _make_step(logp_fn, lower, upper, proposal, tune_interval, tune, logp_args=()):
    """One lockstep Metropolis transition for all chains."""

    def step(carry, step_idx, beta, cov_chol):
        # step_idx is the GLOBAL step index (scan index + step_offset) so
        # segmented drivers (PT swap segments shorter than tune_interval)
        # still cross tune boundaries; state.accepted carries across
        # segments, making accepted/tune_interval the true rate
        state = carry
        key, k_prop, k_acc = jax.random.split(state.key, 3)
        n = state.q.shape[0]

        # --- adaptive scale retune at tune_interval boundaries ---
        if tune:
            do_tune = (step_idx > 0) & (step_idx % tune_interval == 0)
            new_scaling = tune_scale(state.scaling, state.accepted / tune_interval)
            scaling = jnp.where(do_tune, new_scaling, state.scaling)
            accepted = jnp.where(do_tune, jnp.zeros_like(state.accepted), state.accepted)
        else:
            scaling, accepted = state.scaling, state.accepted

        # --- propose ---
        delta = proposal(k_prop, n, cov_chol) * scaling[:, None]
        q_prop = state.q + delta
        in_bounds = jnp.all((q_prop >= lower) & (q_prop <= upper), axis=-1)
        # Clip for evaluation so the physics never sees wild inputs; the
        # result is masked out when the proposal was out of bounds.
        q_eval = jnp.clip(q_prop, lower, upper)
        llk_prop = jax.vmap(lambda qq: logp_fn(qq, *logp_args))(q_eval)

        # --- tempered Metropolis accept (reference metropolis.py:355-358) ---
        log_ratio = beta * (llk_prop - state.llk)
        log_u = jnp.log(jax.random.uniform(k_acc, (n,)))
        accept = in_bounds & jnp.isfinite(llk_prop) & (log_u < log_ratio)

        q_new = jnp.where(accept[:, None], q_prop, state.q)
        llk_new = jnp.where(accept, llk_prop, state.llk)

        new_state = MetropolisState(
            q=q_new,
            llk=llk_new,
            scaling=scaling,
            accepted=accepted + accept,
            acc_total=state.acc_total + accept,
            key=key,
        )
        return new_state, (q_new, llk_new)

    return step


#: Roberts & Rosenthal (1998) optimal MALA acceptance rate
MALA_TARGET_ACC = 0.574


def _make_mala_step(logp_fn, lower, upper, tune_interval, tune,
                    logp_args=()):
    """One lockstep MALA (Metropolis-adjusted Langevin) transition:
    drift ``(ε²/2)·Σ·β∇llk`` toward higher tempered posterior plus
    ``ε·L·ξ`` noise, with the asymmetric-proposal Metropolis
    correction.  Carry is ``(state, grad)`` so each step costs ONE
    value_and_grad evaluation.

    Gradients come free from JAX autodiff — a capability the
    reference's random-walk-only samplers never use (its pytensor
    graph could provide them but ``sampler/metropolis.py`` does not);
    in high dimension MALA mixes per-eval far better than a random
    walk.  The per-chain step size ε (``state.scaling``) retunes
    toward the 0.574 optimum every ``tune_interval`` steps."""
    from jax.scipy.linalg import solve_triangular

    vgrad = jax.vmap(jax.value_and_grad(lambda qq: logp_fn(qq, *logp_args)))

    def sigma_dot(g, cov_chol):
        # Σ g = L (Lᵀ g), rows of g
        return (g @ cov_chol) @ cov_chol.T

    def log_g(x, mean, eps, cov_chol):
        # log N(x; mean, ε²Σ) dropping terms symmetric in the per-chain
        # ε and |Σ| (identical forward/reverse, cancel in the ratio)
        z = solve_triangular(cov_chol, (x - mean).T, lower=True)  # (dim, n)
        return -0.5 * jnp.sum((z / eps.T) ** 2, axis=0)

    def step(carry, step_idx, beta, cov_chol):
        state, grad = carry
        key, k_prop, k_acc = jax.random.split(state.key, 3)
        n = state.q.shape[0]
        beta_b = jnp.broadcast_to(beta, (n,)).astype(state.q.dtype)

        if tune:
            do_tune = (step_idx > 0) & (step_idx % tune_interval == 0)
            acc_frac = state.accepted / tune_interval
            retuned = jnp.clip(
                state.scaling * jnp.exp(1.5 * (acc_frac - MALA_TARGET_ACC)),
                1e-6, 1e3)
            scaling = jnp.where(do_tune, retuned, state.scaling)
            accepted = jnp.where(do_tune, jnp.zeros_like(state.accepted),
                                 state.accepted)
        else:
            scaling, accepted = state.scaling, state.accepted

        eps = scaling[:, None]
        half = 0.5 * eps * eps * beta_b[:, None]
        mean_fwd = state.q + half * sigma_dot(grad, cov_chol)
        xi = jax.random.normal(k_prop, state.q.shape, state.q.dtype)
        q_prop = mean_fwd + eps * (xi @ cov_chol.T)
        in_bounds = jnp.all((q_prop >= lower) & (q_prop <= upper), axis=-1)
        q_eval = jnp.clip(q_prop, lower, upper)
        llk_prop, grad_prop = vgrad(q_eval)

        mean_rev = q_eval + half * sigma_dot(grad_prop, cov_chol)
        lg_fwd = log_g(q_eval, mean_fwd, eps, cov_chol)    # g(q'|q)
        lg_rev = log_g(state.q, mean_rev, eps, cov_chol)   # g(q|q')
        log_ratio = beta_b * (llk_prop - state.llk) + lg_rev - lg_fwd
        log_u = jnp.log(jax.random.uniform(k_acc, (n,)))
        ok = in_bounds & jnp.isfinite(llk_prop) \
            & jnp.all(jnp.isfinite(grad_prop), axis=-1)
        accept = ok & (log_u < log_ratio)

        q_new = jnp.where(accept[:, None], q_eval, state.q)
        llk_new = jnp.where(accept, llk_prop, state.llk)
        grad_new = jnp.where(accept[:, None], grad_prop, grad)
        new_state = MetropolisState(
            q=q_new, llk=llk_new, scaling=scaling,
            accepted=accepted + accept,
            acc_total=state.acc_total + accept, key=key)
        return (new_state, grad_new), (q_new, llk_new)

    def init(state):
        llk0, grad0 = vgrad(state.q)
        return (state._replace(llk=llk0), grad0)

    return step, init


#: Beskos et al. (2013) optimal HMC acceptance rate
HMC_TARGET_ACC = 0.651


def _make_hmc_step(logp_fn, lower, upper, tune_interval, tune,
                   logp_args=(), n_leapfrog: int = 10):
    """One lockstep HMC transition for all chains: ``n_leapfrog``
    leapfrog steps of the tempered Hamiltonian, preconditioned by the
    proposal covariance (kinetic energy ``K(p) = ½ pᵀ Σ p`` with
    momenta ``p ~ N(0, Σ⁻¹)`` — mass matrix M = Σ⁻¹, so position
    updates move along the population covariance like the MALA drift).
    Generalizes :func:`_make_mala_step` (MALA ≡ HMC with one leapfrog
    step); per-chain step size ε retunes toward the 0.651 optimum.

    The reference has no gradient-based kernel at all
    (``beat/sampler/metropolis.py`` is random-walk only); HMC's
    distant, high-acceptance proposals cost ``n_leapfrog`` autodiff
    evals but suppress the random-walk diffusion in high dimension —
    on the device the whole trajectory stays one fused lockstep scan.

    Carry is ``(state, grad)``: the gradient at the current position is
    reused as the first half-kick, so each transition costs exactly
    ``n_leapfrog`` value_and_grad evaluations.
    """
    from jax.scipy.linalg import solve_triangular

    vgrad = jax.vmap(jax.value_and_grad(lambda qq: logp_fn(qq, *logp_args)))

    def sigma_dot(p, cov_chol):
        # Σ p = L (Lᵀ p), rows of p
        return (p @ cov_chol) @ cov_chol.T

    def kinetic(p, cov_chol):
        # ½ pᵀ Σ p = ½ |Lᵀ p|²
        return 0.5 * jnp.sum((p @ cov_chol) ** 2, axis=-1)

    def step(carry, step_idx, beta, cov_chol):
        state, grad = carry
        key, k_mom, k_acc = jax.random.split(state.key, 3)
        n = state.q.shape[0]
        beta_b = jnp.broadcast_to(beta, (n,)).astype(state.q.dtype)[:, None]

        if tune:
            do_tune = (step_idx > 0) & (step_idx % tune_interval == 0)
            acc_frac = state.accepted / tune_interval
            retuned = jnp.clip(
                state.scaling * jnp.exp(1.5 * (acc_frac - HMC_TARGET_ACC)),
                1e-6, 1e3)
            scaling = jnp.where(do_tune, retuned, state.scaling)
            accepted = jnp.where(do_tune, jnp.zeros_like(state.accepted),
                                 state.accepted)
        else:
            scaling, accepted = state.scaling, state.accepted

        eps = scaling[:, None]
        # p ~ N(0, Σ⁻¹):  p = L⁻ᵀ ξ
        xi = jax.random.normal(k_mom, state.q.shape, state.q.dtype)
        p0 = solve_triangular(cov_chol.T, xi.T, lower=False).T
        k0 = kinetic(p0, cov_chol)

        # leapfrog: half-kick (reusing the carried gradient), then
        # (drift, kick) × n_leapfrog with the last kick halved
        p = p0 + 0.5 * eps * beta_b * grad
        q = state.q

        def leap(qin, _):
            qq, pp = qin
            qq = qq + eps * sigma_dot(pp, cov_chol)
            q_eval = jnp.clip(qq, lower, upper)
            llk, g = vgrad(q_eval)
            return (qq, pp + eps * beta_b * g), (llk, g)

        (q, p), (llks, grads) = jax.lax.scan(leap, (q, p), None,
                                             length=n_leapfrog)
        llk_prop, grad_prop = llks[-1], grads[-1]
        # the scan applied a FULL final kick; pull half of it back
        p = p - 0.5 * eps * beta_b * grad_prop

        in_bounds = jnp.all((q >= lower) & (q <= upper), axis=-1)
        q_eval = jnp.clip(q, lower, upper)
        log_ratio = beta_b[:, 0] * (llk_prop - state.llk) \
            + k0 - kinetic(p, cov_chol)
        log_u = jnp.log(jax.random.uniform(k_acc, (n,)))
        ok = in_bounds & jnp.isfinite(llk_prop) \
            & jnp.all(jnp.isfinite(grad_prop), axis=-1) \
            & jnp.all(jnp.isfinite(p), axis=-1)
        accept = ok & (log_u < log_ratio)

        q_new = jnp.where(accept[:, None], q_eval, state.q)
        llk_new = jnp.where(accept, llk_prop, state.llk)
        grad_new = jnp.where(accept[:, None], grad_prop, grad)
        new_state = MetropolisState(
            q=q_new, llk=llk_new, scaling=scaling,
            accepted=accepted + accept,
            acc_total=state.acc_total + accept, key=key)
        return (new_state, grad_new), (q_new, llk_new)

    def init(state):
        llk0, grad0 = vgrad(state.q)
        return (state._replace(llk=llk0), grad0)

    return step, init


@partial(jax.jit, static_argnames=("logp_fn", "n_steps", "proposal_name",
                                   "tune_interval", "tune", "record_every",
                                   "n_leapfrog"))
def run_metropolis_stage(
    logp_fn: Callable,
    state: MetropolisState,
    beta,
    cov_chol,
    lower,
    upper,
    n_steps: int,
    proposal_name: str = "MultivariateNormal",
    tune_interval: int = 100,
    tune: bool = True,
    record_every: int = 1,
    logp_args: tuple = (),
    step_offset=0,
    n_leapfrog: int = 10,
):
    """
    Advance all chains ``n_steps`` under tempering ``beta``; returns the
    final state and the recorded (thinned) trace
    ``(q_trace (n_rec, n_chains, dim), llk_trace (n_rec, n_chains))``.

    ``logp_args`` is a traced pytree forwarded to ``logp_fn(q, *logp_args)``
    — large GF arrays enter the compiled program as arguments so they are
    never embedded as constants and can be sharded/replicated on the mesh.

    ``step_offset``: global index of the first step — segmented drivers
    (PT) pass their running step count so scale tuning keeps firing every
    ``tune_interval`` GLOBAL steps even when each segment is shorter than
    the interval.
    """
    if proposal_name == "MALA":
        step, init_carry = _make_mala_step(logp_fn, lower, upper,
                                           tune_interval, tune, logp_args)
        carry0 = init_carry(state)
        state_of = lambda c: c[0]  # noqa: E731
    elif proposal_name == "HMC":
        step, init_carry = _make_hmc_step(logp_fn, lower, upper,
                                          tune_interval, tune, logp_args,
                                          n_leapfrog=n_leapfrog)
        carry0 = init_carry(state)
        state_of = lambda c: c[0]  # noqa: E731
    else:
        proposal = choose_proposal(proposal_name)
        step = _make_step(logp_fn, lower, upper, proposal, tune_interval,
                          tune, logp_args)
        carry0 = state
        state_of = lambda c: c  # noqa: E731

    def body(carry, step_idx):
        new_carry, (q, llk) = step(carry, step_idx + step_offset, beta,
                                   cov_chol)
        return new_carry, (q, llk)

    if record_every <= 1:
        final, (q_tr, llk_tr) = jax.lax.scan(body, carry0, jnp.arange(n_steps))
    else:
        # Thinned recording: scan over full blocks keeping each block's
        # last state, then run the remainder steps (recorded as one final
        # row) — all n_steps are always executed (a plain
        # n_steps // record_every would silently drop the remainder, or
        # run ZERO steps when record_every > n_steps).
        n_blocks, rem = divmod(n_steps, record_every)

        def block(carry, block_idx):
            def inner(c, i):
                s, _ = step(c, block_idx * record_every + i + step_offset,
                            beta, cov_chol)
                return s, None

            new_carry, _ = jax.lax.scan(inner, carry, jnp.arange(record_every))
            ns = state_of(new_carry)
            return new_carry, (ns.q, ns.llk)

        if n_blocks:
            final, (q_tr, llk_tr) = jax.lax.scan(block, carry0,
                                                 jnp.arange(n_blocks))
        else:
            final = carry0
            q_tr = jnp.zeros((0,) + state.q.shape, state.q.dtype)
            llk_tr = jnp.zeros((0,) + state.llk.shape, state.llk.dtype)
        if rem:
            def tail(c, i):
                s, _ = step(c, n_blocks * record_every + i + step_offset,
                            beta, cov_chol)
                return s, None

            final, _ = jax.lax.scan(tail, final, jnp.arange(rem))
            fs = state_of(final)
            q_tr = jnp.concatenate([q_tr, fs.q[None]], axis=0)
            llk_tr = jnp.concatenate([llk_tr, fs.llk[None]], axis=0)

    return state_of(final), (q_tr, llk_tr)


def metropolis_sample(
    logp_fn: Callable,
    lower: np.ndarray,
    upper: np.ndarray,
    n_chains: int = 100,
    n_steps: int = 10000,
    burn: float = 0.1,
    thin: int = 2,
    scale: float = 1.0,
    proposal_name: str = "MultivariateNormal",
    tune_interval: int = 100,
    seed: int = 0,
    start: np.ndarray | None = None,
    cov: np.ndarray | None = None,
    stage_handler=None,
    logp_args: tuple = (),
    n_leapfrog: int = 10,
):
    """
    Plain (non-staged) adaptive Metropolis driver — the analogue of the
    reference single-stage ``metropolis_sample`` (``sampler/metropolis.py:425``).

    Returns ``(q_trace, llk_trace)`` after burn-in removal and thinning,
    shapes (n_kept, n_chains, dim) / (n_kept, n_chains).
    """
    from beat_tpu.compile_cache import enable_persistent_compile_cache

    enable_persistent_compile_cache()
    from beat_tpu.covariance import init_proposal_covariance

    lower = jnp.asarray(lower, dtype=jnp.float32)
    upper = jnp.asarray(upper, dtype=jnp.float32)
    key = jax.random.PRNGKey(seed)
    key, k_init = jax.random.split(key)

    if start is None:
        start = jax.random.uniform(
            k_init, (n_chains, lower.size), minval=lower, maxval=upper)
    if cov is None:
        cov = init_proposal_covariance(np.asarray(lower), np.asarray(upper))
    cov_chol = jnp.asarray(np.linalg.cholesky(cov), dtype=jnp.float32)

    state = init_metropolis_state(logp_fn, start, key, scale=scale,
                                  logp_args=logp_args)
    final, (q_tr, llk_tr) = run_metropolis_stage(
        logp_fn, state, jnp.float32(1.0), cov_chol, lower, upper,
        n_steps=n_steps, proposal_name=proposal_name,
        tune_interval=tune_interval, tune=True, record_every=1,
        logp_args=logp_args, n_leapfrog=n_leapfrog,
    )
    n_burn = int(burn * n_steps)
    q_kept = np.asarray(q_tr[n_burn::thin])
    llk_kept = np.asarray(llk_tr[n_burn::thin])
    if stage_handler is not None:
        stage_handler.save_stage(
            -1, {"q": q_kept, "llk": llk_kept},
            {"beta": 1.0, "n_steps": n_steps, "burn": burn, "thin": thin})
    return q_kept, llk_kept

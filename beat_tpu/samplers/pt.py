"""
Parallel Tempering (replica exchange) — single device program.

Re-design of ``beat/sampler/pt.py`` + ``beat/sampler/distributed.py``:
the reference runs one MPI rank per temperature with a master process
relaying chain-end state vectors (raw float64 arrays) and swap decisions.
Here all replicas live in one ``(n_chains, dim)`` device array sharded
over the mesh; a swap is a masked pairwise permutation — no messages,
no master.

Algorithm parity:

* β ladder: ``n_posterior`` replicas at β=1, the rest geometric
  ``β_k = scale^{-k}`` (reference ``TemperingManager.update_betas`` :179).
* Swap accept: ``log u < (β₂-β₁)(llk₁-llk₂)``
  (reference ``propose_chain_swap`` :429).
* β-ladder adaptation: every ``beta_tune_interval`` posterior samples the
  swap-acceptance rate between the posterior group and the adjacent
  tempered replicas retunes the scale with the *inverse-logic* table
  (reference ``tune`` :37 + ``tune_betas`` :331).

Temporal-structure difference (documented, see SURVEY §7 hard part 4):
the reference swaps random pairs after random-length chain segments;
here segments are a fixed ``swap_interval`` steps and swaps use the
standard even/odd adjacent-pair scheme across the β-sorted ladder, which
preserves detailed balance per segment and mixes at least as fast.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from beat_tpu.backend import SampleStage
from beat_tpu.covariance import init_proposal_covariance
from beat_tpu.samplers.metropolis import MetropolisState, run_metropolis_stage

logger = logging.getLogger("beat_tpu.pt")


def tune_temp_scale(scale, acc_rate):
    """Inverse-logic tuning of the temperature scale (reference pt.py:37-73)."""
    if acc_rate < 0.001:
        scale *= 0.85
    elif acc_rate < 0.05:
        scale *= 0.9
    elif acc_rate < 0.2:
        scale *= 0.95
    elif acc_rate > 0.95:
        scale *= 1.15
    elif acc_rate > 0.75:
        scale *= 1.10
    elif acc_rate > 0.5:
        scale *= 1.05
    return scale


def make_betas(n_chains: int, n_posterior: int, scale: float) -> np.ndarray:
    """β ladder: n_posterior ones, then geometric 1/scale^k (reference :179)."""
    n_temp = n_chains - n_posterior
    betas_temp = 1.0 / np.power(scale, np.arange(1, n_temp + 1))
    return np.concatenate([np.ones(n_posterior), betas_temp])


@partial(jax.jit, static_argnames=("n_posterior",))
def _swap_step(q, llk, betas, key, parity, n_posterior: int):
    """
    Even/odd adjacent-pair replica exchange over the β-sorted chain array.
    Returns swapped (q, llk) plus per-pair acceptance bookkeeping
    (accepted mask and proposed mask over pair slots).
    """
    n = llk.shape[0]
    idx = jnp.arange(n)
    # partner of i: i^1 shifted by parity (pairs (0,1),(2,3).. or (1,2),(3,4)..)
    partner = jnp.where((idx - parity) % 2 == 0, idx + 1, idx - 1)
    partner = jnp.clip(partner, 0, n - 1)
    valid = (partner != idx) & (partner >= 0) & (partner < n)

    alpha = (betas[partner] - betas[idx]) * (llk[idx] - llk[partner])
    log_u = jnp.log(jax.random.uniform(key, (n,)))
    # decide once per pair: use the lower index's random number
    low = jnp.minimum(idx, partner)
    accept = (log_u[low] < alpha) & valid

    perm = jnp.where(accept, partner, idx)
    q_new = q[perm]
    llk_new = llk[perm]

    # bookkeeping: count proposals/accepts where this replica is the pair's low end
    is_low = idx == low
    proposed = valid & is_low
    accepted = accept & is_low
    return q_new, llk_new, accepted, proposed


@dataclass
class PTParams:
    """Reference ``ParallelTemperingConfig`` (``config.py:1715``)."""

    n_chains: int = 16
    n_samples: int = 20000          # total posterior MH steps
    swap_interval: tuple = (10, 30) # reference draws segment length in this range
    n_chains_posterior: int = 4
    tune_interval: int = 100
    beta_tune_interval: int = 1000
    t_scale: float = 1.2
    t_scale_min: float = 1.01
    t_scale_max: float = 2.0
    proposal_name: str = "MultivariateNormal"
    #: leapfrog steps per transition when proposal_name == "HMC"
    n_leapfrog: int = 10
    record_worker_chains: bool = False
    seed: int = 0


def pt_sample(
    logp_fn: Callable,
    lower: np.ndarray,
    upper: np.ndarray,
    params: PTParams,
    homepath: str | None = None,
    ordering=None,
    start: np.ndarray | None = None,
    logp_args: tuple = (),
    mesh=None,
):
    """
    Run parallel tempering; returns the posterior trace
    ``(q_trace (n_rec, n_posterior, dim), llk_trace)`` — every posterior
    (β=1) draw of every segment, exactly like the reference's master trace
    (``pt.py:606-612``) — plus a history dict (β scales, swap acceptance)
    for diagnostics (reference ``SamplingHistory`` pt.py:76).  With
    ``params.record_worker_chains`` the tempered replicas' draws are
    saved to the stage handler too (reference ``record_worker_chains``
    worker traces).

    mesh : optional :class:`jax.sharding.Mesh` — shards the temperature
        ladder (replica rows) across devices; the even/odd swap becomes
        an XLA cross-device permute (the device analogue of the reference's
        MPI master/worker swaps, ``pt.py:258``).  Results are identical
        to the single-device run.
    """
    from beat_tpu.compile_cache import enable_persistent_compile_cache

    enable_persistent_compile_cache()
    lower64 = np.asarray(lower, dtype=np.float64)
    upper64 = np.asarray(upper, dtype=np.float64)
    dim = lower64.size
    lo = jnp.asarray(lower64, dtype=jnp.float32)
    hi = jnp.asarray(upper64, dtype=jnp.float32)
    rng = np.random.default_rng(params.seed)
    key = jax.random.PRNGKey(params.seed)

    n = params.n_chains
    n_post = params.n_chains_posterior
    t_scale = params.t_scale
    betas = make_betas(n, n_post, t_scale)

    if start is None:
        start = rng.uniform(lower64, upper64, size=(n, dim))
    cov = init_proposal_covariance(lower64, upper64)
    cov_chol = jnp.asarray(np.linalg.cholesky(cov), dtype=jnp.float32)

    key, sub = jax.random.split(key)
    q = jnp.asarray(start, dtype=jnp.float32)
    from beat_tpu.samplers.metropolis import batched_llk

    llk = batched_llk(logp_fn, q, logp_args)
    scaling = jnp.ones((n,))
    state = MetropolisState(q=q, llk=llk, scaling=scaling,
                            accepted=jnp.zeros((n,)), acc_total=jnp.zeros((n,)), key=sub)
    if mesh is not None:
        from beat_tpu.parallel import replicated, shard_chain_state

        if n % mesh.devices.size:
            raise ValueError(
                f"n_chains={n} must be a multiple of the mesh size "
                f"{mesh.devices.size} for temperature-axis sharding")
        state = shard_chain_state(state, mesh)
        cov_chol = jax.device_put(cov_chol, replicated(mesh))
        lo = jax.device_put(lo, replicated(mesh))
        hi = jax.device_put(hi, replicated(mesh))
        # GF tables/weights placed once, not re-transferred per segment
        logp_args = jax.device_put(logp_args, replicated(mesh))

    seg_lo, seg_hi = params.swap_interval
    mean_seg = (seg_lo + seg_hi) // 2
    n_segments = max(1, params.n_samples // mean_seg)

    post_q, post_llk = [], []
    worker_q, worker_llk = [], []
    acc_matrix_accepted = 0
    acc_matrix_proposed = 0
    samples_since_tune = 0
    scale_history = [t_scale]
    swap_acc_history = []
    parity = 0

    betas_dev = jnp.asarray(betas, dtype=jnp.float32)

    # random segment lengths decorrelate swap timing (reference draws
    # uniform in swap_interval); quantized to 3 values so the jitted
    # segment compiles at most 3 variants
    seg_choices = sorted({int(seg_lo), int((seg_lo + seg_hi) // 2), int(seg_hi)})
    from beat_tpu.profiling import timings

    t0_sampling = time.perf_counter()
    global_step = 0
    for seg in range(n_segments):
        seg_len = int(rng.choice(seg_choices))
        # Per-replica tempered Metropolis segment: run_metropolis_stage
        # supports per-chain beta via broadcasting in the accept ratio.
        # step_offset carries the global step count so scale tuning fires
        # every tune_interval GLOBAL steps — segments (10-30 steps) are
        # shorter than the interval, so without it tuning never triggers.
        state, (q_tr, llk_tr) = run_metropolis_stage(
            logp_fn, state, betas_dev, cov_chol, lo, hi,
            n_steps=seg_len, proposal_name=params.proposal_name,
            tune_interval=params.tune_interval, tune=True,
            record_every=1,  # every draw: full posterior trace (ref pt.py:606)
            logp_args=logp_args,
            step_offset=np.int32(global_step),
            n_leapfrog=params.n_leapfrog,
        )
        global_step += seg_len

        key, k_swap = jax.random.split(key)
        q_new, llk_new, accepted, proposed = _swap_step(
            state.q, state.llk, betas_dev, k_swap, parity, n_post)
        parity ^= 1
        state = state._replace(q=q_new, llk=llk_new)

        # β-ladder tuning statistic: ONLY the posterior<->tempered edge
        # pair (low end n_post-1) counts, as the reference tunes on the
        # posterior-group / hottest-adjacent-worker acceptance
        # (tune_betas :331) — the (n_post, n_post+1) pair active on the
        # other parity is tempered<->tempered and systematically hotter.
        # Accumulated ON DEVICE: a per-segment host fetch would sync the
        # dispatch pipeline every ~20 steps and leave the card idle while
        # the host waits; the host only reads it at retune boundaries.
        edge = max(0, n_post - 1)
        acc_matrix_accepted = acc_matrix_accepted + accepted[edge]
        acc_matrix_proposed = acc_matrix_proposed + proposed[edge]

        # every β=1 draw of the segment (the swap permutation only touches
        # the segment-end state, which the next segment starts from);
        # device->host copies start asynchronously and are materialized
        # after the loop, overlapping transfers with later segments
        def _async(x):
            try:
                x.copy_to_host_async()
            except AttributeError:
                pass
            return x

        post_q.append(_async(q_tr[:, :n_post]))
        post_llk.append(_async(llk_tr[:, :n_post]))
        if params.record_worker_chains:
            worker_q.append(_async(q_tr[:, n_post:]))
            worker_llk.append(_async(llk_tr[:, n_post:]))
        samples_since_tune += seg_len * n_post

        if samples_since_tune >= params.beta_tune_interval:
            prop_count = int(acc_matrix_proposed)
            acc_rate = (int(acc_matrix_accepted) / prop_count
                        if prop_count else 0.0)
            t_scale = float(np.clip(tune_temp_scale(t_scale, acc_rate),
                                    params.t_scale_min, params.t_scale_max))
            betas = make_betas(n, n_post, t_scale)
            betas_dev = jnp.asarray(betas, dtype=jnp.float32)
            swap_acc_history.append(acc_rate)
            scale_history.append(t_scale)
            samples_since_tune = 0
            acc_matrix_accepted = acc_matrix_proposed = 0
            logger.info("PT retune: swap acceptance %.3f -> t_scale %.4f", acc_rate, t_scale)

    jax.block_until_ready(state.q)
    timings.add("pt_sampling", time.perf_counter() - t0_sampling,
                n_evals=params.n_samples * n)
    q_trace = np.concatenate(post_q)     # (n_draws, n_post, dim)
    llk_trace = np.concatenate(post_llk)
    history = {"scale_history": np.asarray(scale_history),
               "swap_acceptance": np.asarray(swap_acc_history),
               "betas": betas}

    from beat_tpu.parallel import is_io_process

    if homepath is not None and is_io_process():
        handler = SampleStage(homepath, ordering=ordering)
        state_extra = {"beta": 1.0, "cov": cov, "population": np.asarray(state.q),
                       "likelihoods": np.asarray(state.llk),
                       "betas": betas, "scale_history": history["scale_history"],
                       "swap_acceptance": history["swap_acceptance"]}
        if params.record_worker_chains:
            state_extra["worker_q"] = np.concatenate(worker_q)
            state_extra["worker_llk"] = np.concatenate(worker_llk)
        handler.save_stage(-1, {"q": q_trace, "llk": llk_trace}, state_extra)
    return q_trace, llk_trace, history

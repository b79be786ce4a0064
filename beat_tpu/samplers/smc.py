"""
Sequential Monte Carlo / transitional MCMC (Ching & Chen 2007).

Re-design of ``beat/sampler/smc.py``: the stage structure, β bisection,
importance-weighted proposal covariance and Kitagawa systematic resampling
are kept numerically identical; execution changes from "fork pool runs N
Python chain loops per stage" to "one jitted ``lax.scan`` advances all
chains in lockstep on device".  Stage transitions (tiny O(n_chains) math)
run on host in float64.

Stage loop (reference ``smc_sample`` ``sampler/smc.py:333``):

  stage 0:   draw the initial population from the prior, evaluate llks.
  stage m:   bisect β_{m+1} s.t. CoV(importance weights) == coef_variation;
             weighted proposal covariance (PSD-repaired);
             systematic resampling of chain end points;
             run n_steps of adaptive Metropolis at β_{m+1}.
  final:     β = 1, sample_factor_final_stage × n_steps → stage_-1.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from beat_tpu.backend import SampleStage
from beat_tpu.covariance import init_proposal_covariance
from beat_tpu.profiling import jax_trace, stage_timer, timings
from beat_tpu.samplers.metropolis import init_metropolis_state, run_metropolis_stage, MetropolisState
from beat_tpu.utility import ensure_cov_psd

logger = logging.getLogger("beat_tpu.smc")


def calc_beta(beta: float, likelihoods: np.ndarray, coef_variation: float = 1.0):
    """
    Bisect the next tempering β so that the coefficient of variation of the
    importance weights equals ``coef_variation``
    (reference ``SMC.calc_beta`` ``sampler/smc.py:133``).

    Returns (new_beta, old_beta, normalised weights).
    """
    llks = np.asarray(likelihoods, dtype=np.float64)
    low_beta = beta
    up_beta = 2.0
    current_beta = up_beta
    temp = np.exp((current_beta - beta) * (llks - llks.max()))
    while up_beta - low_beta > 1e-6:
        current_beta = (low_beta + up_beta) / 2.0
        temp = np.exp((current_beta - beta) * (llks - llks.max()))
        cov_temp = np.std(temp) / np.mean(temp)
        if cov_temp > coef_variation:
            up_beta = current_beta
        else:
            low_beta = current_beta
    weights = temp / np.sum(temp)
    return current_beta, beta, weights


def calc_covariance(population: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Importance-weighted proposal covariance with PSD repair
    (reference ``SMC.calc_covariance`` ``sampler/smc.py:167``)."""
    cov = np.cov(population, aweights=weights.ravel(), bias=False, rowvar=False)
    cov = ensure_cov_psd(np.atleast_2d(cov))
    if np.isnan(cov).any() or np.isinf(cov).any():
        raise ValueError("Sample covariance contains NaN/Inf — check hyper bounds")
    return cov


def systematic_resample(weights: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """
    Kitagawa deterministic/systematic resampling
    (reference ``SMC.resample`` ``sampler/smc.py:290``): one shared uniform
    offset, children counts via the inverse CDF.  Returns parent indexes
    sorted ascending, exactly like the reference's outindx.
    """
    n = weights.size
    u = (np.arange(n) + rng.random()) / n
    cum = np.cumsum(weights)
    cum[-1] = 1.0  # guard fp round-off
    return np.searchsorted(cum, u).astype(np.int64)


@dataclass
class SMCParams:
    """Sampler configuration (reference ``SMCConfig`` ``config.py:1794``)."""

    n_chains: int = 1000
    n_steps: int = 100
    coef_variation: float = 1.0
    tune_interval: int = 25
    proposal_name: str = "MultivariateNormal"
    #: leapfrog steps per transition when proposal_name == "HMC"
    n_leapfrog: int = 10
    stage: int = 0                  # resume stage ('0' fresh, N continue)
    buffer_thinning: int = 1
    rm_flag: bool = False
    max_stages: int = 100
    #: multiplies n_steps in the final (β=1) stage (reference
    #: ``sample_factor_final_stage``, ``sampler/smc.py:23``)
    sample_factor_final_stage: int = 1
    seed: int = 0


def smc_sample(
    logp_fn: Callable,
    lower: np.ndarray,
    upper: np.ndarray,
    params: SMCParams,
    homepath: str | None = None,
    ordering=None,
    start: np.ndarray | None = None,
    update_weights: Callable | None = None,
    progress: bool = True,
    logp_args: tuple = (),
    mesh=None,
):
    """
    Run the full SMC sampler.

    Parameters
    ----------
    logp_fn : pure JAX function (dim, *logp_args) -> scalar data
        log-likelihood ("like" in the reference).  vmapped/jitted
        internally.
    lower, upper : flat prior bounds.
    homepath : stage checkpoint directory (resume supported); None = no IO.
    update_weights : optional callback ``(map_point) -> new_logp_args|None``
        invoked at each stage's MAP point to re-estimate data covariances
        (reference "update" problem hook ``smc.py:492-503``).  If it
        returns a non-None value it replaces ``logp_args`` (refreshed
        weight matrices).
    logp_args : traced pytree forwarded to ``logp_fn`` — GF tables and
        weights as jit arguments, never closure constants.
    mesh : optional :class:`jax.sharding.Mesh` — shards the chain axis
        across devices (GF tables/weights replicate); stage transitions
        (β bisection, resampling) stay on host and gather implicitly.
        ``n_chains`` must divide the mesh.

    Returns the final-stage (β=1) trace ``(q_trace, llk_trace)`` as numpy.
    """
    from beat_tpu.compile_cache import enable_persistent_compile_cache

    enable_persistent_compile_cache()
    if mesh is not None and params.n_chains % mesh.devices.size:
        raise ValueError(
            f"n_chains={params.n_chains} must be a multiple of the mesh "
            f"size {mesh.devices.size} for chain sharding (see pad_chains)")
    lower64 = np.asarray(lower, dtype=np.float64)
    upper64 = np.asarray(upper, dtype=np.float64)
    dim = lower64.size
    lo = jnp.asarray(lower64, dtype=jnp.float32)
    hi = jnp.asarray(upper64, dtype=jnp.float32)
    if mesh is not None:
        from beat_tpu.parallel import replicated

        rep = replicated(mesh)
        lo = jax.device_put(lo, rep)
        hi = jax.device_put(hi, rep)
        logp_args = jax.device_put(logp_args, rep)
    rng = np.random.default_rng(params.seed)
    key = jax.random.PRNGKey(params.seed)

    # multi-host: only process 0 WRITES checkpoints; every process READS
    # the resume state (below) so all hosts follow identical control flow
    from beat_tpu.parallel import is_io_process

    handler = (SampleStage(homepath, ordering=ordering)
               if homepath and is_io_process() else None)
    reader = SampleStage(homepath, ordering=ordering) if homepath else None
    # background checkpoint writer (see the save site in the stage loop)
    saver = None
    save_futures = []
    if handler is not None:
        from concurrent.futures import ThreadPoolExecutor

        saver = ThreadPoolExecutor(max_workers=1,
                                   thread_name_prefix="smc_stage_saver")

    def _join_saves():
        """Block until every queued stage write landed (re-raising any
        writer exception) — checkpoints must be durable before return."""
        for f in save_futures:
            f.result()
        if saver is not None:
            saver.shutdown(wait=True)

    # ---- resume logic (reference init_stage, sampler/base.py:618) ----
    stage = params.stage
    beta = 0.0
    cov = init_proposal_covariance(lower64, upper64)
    population = None
    likelihoods = None
    log_evidence = 0.0
    if handler is not None and stage == 0 and params.rm_flag:
        # fresh run requested: remove stale stage dirs from previous runs
        # so a later resume cannot pick up an old run's higher stages
        # (reference rm_flag / clean_directory, backend.py:1079)
        handler.rm_all()
    if reader is not None and stage != 0:
        top = reader.highest_sampled_stage()
        if jax.process_count() > 1:
            # hosts without a shared filesystem would see different
            # checkpoints and desynchronize the SPMD stage loop — make
            # process 0's view authoritative everywhere
            from jax.experimental import multihost_utils

            top = int(multihost_utils.broadcast_one_to_all(
                np.int64(top if jax.process_index() == 0 else -2)))
        if top == -1:
            logger.info("Found complete final stage — nothing to do")
            _join_saves()
            try:
                tr = reader.load_trace(-1)
            except FileNotFoundError:
                # non-io host without a shared filesystem: the run is
                # complete, only process 0 holds the trace
                return (np.zeros((0, params.n_chains, dim)),
                        np.zeros((0, params.n_chains)))
            return tr.q_trace, tr.llk_trace
        if top >= 0:
            if jax.process_count() > 1:
                from jax.experimental import multihost_utils

                if jax.process_index() == 0:
                    st = reader.load_state(top)
                    payload = (np.float64(st["beta"]), np.asarray(st["cov"]),
                               np.asarray(st["population"]),
                               np.asarray(st["likelihoods"]),
                               np.float64(st.get("log_evidence", 0.0)))
                else:
                    payload = (np.float64(0.0), np.zeros((dim, dim)),
                               np.zeros((params.n_chains, dim)),
                               np.zeros((params.n_chains,)),
                               np.float64(0.0))
                payload = multihost_utils.broadcast_one_to_all(payload)
                beta = float(payload[0])
                cov, population, likelihoods = (np.asarray(p)
                                                for p in payload[1:4])
                log_evidence = float(payload[4])
            else:
                st = reader.load_state(top)
                beta = float(st["beta"])
                cov = np.asarray(st["cov"])
                population = np.asarray(st["population"])
                likelihoods = np.asarray(st["likelihoods"])
                log_evidence = float(st.get("log_evidence", 0.0))
            stage = top + 1
            logger.info("Resuming from stage %i at beta=%.5f", top, beta)
        else:
            stage = 0

    if params.n_chains < 2:
        raise ValueError("SMC needs n_chains >= 2 (population-based sampler); "
                         f"got {params.n_chains}")

    if population is None:
        # stage 0: prior-predictive population (reference metropolis.py:128)
        if start is None:
            start = rng.uniform(lower64, upper64, size=(params.n_chains, dim))
        population = np.asarray(start, dtype=np.float64)
        if np.any(population < lower64) or np.any(population > upper64):
            raise ValueError("Start population outside prior bounds — chains "
                             "could never re-enter the support")
        key, sub = jax.random.split(key)
        state0 = init_metropolis_state(logp_fn, jnp.asarray(population, dtype=jnp.float32), sub,
                                       logp_args=logp_args)
        likelihoods = np.asarray(state0.llk, dtype=np.float64)
        if not np.isfinite(likelihoods).all():
            raise ValueError("NaN/Inf in initial likelihood evaluation — "
                             "invalid model or start outside prior bounds")
        if handler is not None:
            handler.save_stage(0, {"q": population[None], "llk": likelihoods[None]},
                               {"beta": 0.0, "cov": cov, "population": population,
                                "likelihoods": likelihoods, "stage": 0})
        stage = max(stage, 1)

    betas = [beta]
    acceptance = []
    # Ching & Chen (2007) transitional-MCMC evidence estimator: the
    # product of per-stage mean incremental importance weights
    # S_j = (1/N) sum_i exp((b_{j+1}-b_j) llk_i) converges to the
    # marginal likelihood Z = p(data) under the prior as beta -> 1 —
    # a model-comparison quantity the reference's SMC never computes.
    log_evidence = float(log_evidence)
    # ---- stage loop (per-stage timings recorded in profiling.timings;
    # BEAT_TPU_PROFILE_DIR additionally writes a JAX profiler trace of
    # each stage's device work) ----
    timings_mark = len(timings.records)   # this run's records only
    while beta < 1.0 and stage < params.max_stages:
        new_beta, old_beta, weights = calc_beta(beta, likelihoods, params.coef_variation)
        final_stage = new_beta >= 1.0
        if final_stage:
            new_beta = 1.0
            weights_final = np.exp((1.0 - old_beta) * (likelihoods - likelihoods.max()))
            weights = weights_final / weights_final.sum()
        # evidence increment log S_j from the PRE-resampling population
        d_beta = new_beta - old_beta
        log_evidence += d_beta * likelihoods.max() + float(np.log(np.mean(
            np.exp(d_beta * (likelihoods - likelihoods.max())))))

        cov = calc_covariance(population, weights)
        resampling_idx = systematic_resample(weights, rng)
        population = population[resampling_idx]
        likelihoods = likelihoods[resampling_idx]

        n_steps = params.n_steps * (params.sample_factor_final_stage
                                    if final_stage else 1)
        logger.info("Stage %i: beta %.6f -> %.6f, %i steps x %i chains",
                    stage, old_beta, new_beta, n_steps, params.n_chains)

        key, sub = jax.random.split(key)
        # ONE batched host->device upload for everything the stage needs
        # (population, likelihoods, tuning state, proposal cholesky) —
        # separate jnp.asarray/jnp.ones calls each pay their own
        # transfer and synchronisation
        ones = np.ones((params.n_chains,), np.float32)
        zeros = np.zeros((params.n_chains,), np.float32)
        q_dev, llk_dev, ones_dev, zeros_dev, zeros2_dev, cov_chol = \
            jax.device_put((np.asarray(population, np.float32),
                            np.asarray(likelihoods, np.float32),
                            ones, zeros, zeros.copy(),
                            np.linalg.cholesky(cov).astype(np.float32)))
        state = MetropolisState(
            q=q_dev, llk=llk_dev, scaling=ones_dev, accepted=zeros_dev,
            acc_total=zeros2_dev, key=sub,
        )
        if mesh is not None:
            from beat_tpu.parallel import replicated, shard_chain_state

            state = shard_chain_state(state, mesh)
            cov_chol = jax.device_put(cov_chol, replicated(mesh))
        with stage_timer(f"smc_stage_{-1 if final_stage else stage}",
                         n_evals=n_steps * params.n_chains,
                         beta=round(float(new_beta), 6)), jax_trace():
            final, (q_tr, llk_tr) = run_metropolis_stage(
                logp_fn, state, jnp.float32(new_beta), cov_chol, lo, hi,
                n_steps=n_steps, proposal_name=params.proposal_name,
                tune_interval=params.tune_interval, tune=True,
                record_every=params.buffer_thinning,
                logp_args=logp_args,
                n_leapfrog=params.n_leapfrog,
            )
            jax.block_until_ready(final.q)
        # ONE batched device->host fetch: separate np.asarray calls each
        # pay a full device synchronisation
        q_host, llk_host, acc_host = jax.device_get(
            (final.q, final.llk, final.acc_total))
        population = np.asarray(q_host, dtype=np.float64)
        likelihoods = np.asarray(llk_host, dtype=np.float64)
        acc_rate = float(np.mean(acc_host) / n_steps)
        acceptance.append(acc_rate)
        beta = new_beta
        betas.append(beta)
        if progress:
            logger.info("Stage %i done: acceptance %.3f, max llk %.2f, "
                        "log evidence so far %.3f",
                        stage, acc_rate, likelihoods.max(), log_evidence)

        save_stage_num = -1 if final_stage else stage
        if handler is not None:
            # fetch + write in a 1-worker background thread: the in-stage
            # trace (n_rec x chains x dim) is the LARGE host transfer and
            # disk write of every stage, and nothing downstream reads it
            # until the run ends — overlap it with the next stage's
            # device work.  One worker keeps stage
            # files strictly ordered; exceptions surface at the join.
            summary = {"beta": beta, "cov": cov, "population": population,
                       "likelihoods": likelihoods, "stage": stage,
                       "resampling_indexes": resampling_idx,
                       "acceptance": np.asarray(acceptance),
                       "log_evidence": np.float64(log_evidence)}

            def _save(num, qt, lt, summ):
                qt, lt = jax.device_get((qt, lt))   # one batched fetch
                handler.save_stage(
                    num, {"q": np.asarray(qt), "llk": np.asarray(lt)}, summ)

            if saver is None:
                _save(save_stage_num, q_tr, llk_tr, summary)
            else:
                save_futures.append(saver.submit(
                    _save, save_stage_num, q_tr, llk_tr, summary))

        # data-covariance update hook at the MAP point (reference smc.py:492)
        if update_weights is not None and not final_stage:
            map_point = population[int(np.argmax(likelihoods))]
            new_args = update_weights(map_point)
            if new_args is not None:
                logp_args = (jax.device_put(new_args, rep)
                             if mesh is not None else new_args)
            key, sub = jax.random.split(key)
            st = init_metropolis_state(logp_fn, jnp.asarray(population, dtype=jnp.float32), sub,
                                       logp_args=logp_args)
            likelihoods = np.asarray(st.llk, dtype=np.float64)

        if final_stage:
            _join_saves()
            if handler is not None:
                from beat_tpu.profiling import TimingRegistry

                TimingRegistry(records=timings.records[timings_mark:]).dump(
                    os.path.join(homepath, "timings.json"))
            return np.asarray(q_tr), np.asarray(llk_tr)
        stage += 1

    _join_saves()
    raise RuntimeError(f"SMC did not reach beta=1 within {params.max_stages} stages")

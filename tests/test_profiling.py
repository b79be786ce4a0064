"""Profiling subsystem: per-stage timing registry, time_method,
JAX-profiler hook, per-eval device timing (SURVEY §5)."""

import json
import os

import numpy as np
import pytest

import jax.numpy as jnp

from beat_tpu.profiling import (TimingRegistry, batched_logp, jax_trace,
                                stage_timer, time_method, time_per_sample,
                                timings)


def test_registry_and_stage_timer():
    reg = TimingRegistry()
    with stage_timer("stage_a", n_evals=1000, registry=reg, beta=0.5):
        sum(range(10000))
    with stage_timer("stage_b", registry=reg):
        pass
    rep = reg.report()
    assert [r["name"] for r in rep["stages"]] == ["stage_a", "stage_b"]
    assert rep["stages"][0]["n_evals"] == 1000
    assert rep["stages"][0]["evals_per_s"] > 0
    assert rep["stages"][0]["beta"] == 0.5
    assert rep["total_wall_s"] >= rep["stages"][0]["wall_s"]
    assert "stage_a" in reg.summary() and "evals/s" in reg.summary()


def test_time_method_decorator():
    reg_len = len(timings.records)

    @time_method
    def work():
        return 42

    assert work() == 42
    assert len(timings.records) == reg_len + 1
    assert timings.records[-1].name.endswith("work")


def test_jax_trace_noop_without_dir(monkeypatch):
    monkeypatch.delenv("BEAT_TPU_PROFILE_DIR", raising=False)
    with jax_trace() as d:
        assert d is None


def test_jax_trace_writes(tmp_path):
    logdir = str(tmp_path / "prof")
    with jax_trace(logdir):
        jnp.sum(jnp.ones((32, 32)) @ jnp.ones((32, 32))).block_until_ready()
    found = [os.path.join(r, f) for r, _, fs in os.walk(logdir) for f in fs]
    assert found, "profiler trace produced no files"


def test_time_per_sample_slope():
    def logp(x):
        return -0.5 * jnp.sum(x**2)

    q = jnp.asarray(np.random.default_rng(0).normal(size=(64, 4)),
                    dtype=jnp.float32)
    dt = time_per_sample(logp, q)
    assert 0 < dt < 1.0  # seconds per lockstep eval, sane on CPU


def _consts(closed):
    """Constants of ``closed`` and of every jaxpr nested in it."""
    from jax.extend import core as jcore

    out = list(closed.consts)
    for eqn in closed.jaxpr.eqns:
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(sub, jcore.ClosedJaxpr):
                    out += _consts(sub)
    return out


def test_timed_program_has_no_large_constants(tmp_path):
    """time_per_sample's program takes the GF table as a jit argument:
    no constant of its jaxpr reaches 1 MB although the table is 1.95 MB —
    a closure over the data would fold the whole table in."""
    import jax

    from __graft_entry__ import _build_flagship

    problem = _build_flagship(n_stations=4, nt=256, n_distances=21,
                              outfolder=str(tmp_path / "out"))
    logp, data = problem.make_logp_fn()
    assert data[0][0]["table"].spectra.nbytes > 1.9e6
    lower, upper = problem.priors.bounds_arrays()
    q = jnp.asarray(np.random.default_rng(0).uniform(
        lower, upper, size=(4, lower.size)), dtype=jnp.float32)

    sizes = [np.asarray(c).nbytes
             for c in _consts(jax.make_jaxpr(batched_logp(logp, 1))(q, data))]
    assert all(b < 1e6 for b in sizes), sorted(sizes)[-3:]
    # the check bites: the closure form carries the table as a constant
    closed = jax.jit(jax.vmap(lambda x: logp(x, data)))
    assert max(np.asarray(c).nbytes
               for c in _consts(jax.make_jaxpr(closed)(q))) > 1.9e6


def test_smc_dumps_timings(tmp_path):
    from beat_tpu.samplers import SMCParams, smc_sample

    def logp(x):
        return -0.5 * jnp.sum((x - 1.0) ** 2) / 0.09

    lo, hi = np.zeros(2), np.full(2, 3.0)
    timings.reset()
    smc_sample(logp, lo, hi, SMCParams(n_chains=32, n_steps=10, seed=1),
               homepath=str(tmp_path / "run"))
    tf = tmp_path / "run" / "timings.json"
    assert tf.exists()
    rep = json.loads(tf.read_text())
    assert rep["total_evals"] > 0
    names = [r["name"] for r in rep["stages"]]
    assert any(n.startswith("smc_stage_") for n in names)
    assert names[-1] == "smc_stage_-1"

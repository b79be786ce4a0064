"""
Structured profiling: per-stage timing registry + JAX profiler hooks.

The reference has only ad-hoc timers (``Metropolis.time_per_sample``
``beat/sampler/metropolis.py:259``, debug timers around synthesis
``heart.py:3656-3695``, ``utility.time_method`` ``utility.py:1576``);
SURVEY §5 prescribes native JAX-profiler integration and a per-stage
timing surface for the rebuild.

Four layers:

* :class:`TimingRegistry` / :func:`stage_timer` — samplers record each
  stage's wall-clock + evaluation count; ``timings.report()`` gives a
  structured dict (also dumped next to the trace stages as
  ``timings.json`` when sampling with a homepath).
* :func:`time_method` — decorator logging call durations (reference
  ``utility.time_method``) into the registry.
* :func:`jax_trace` — context manager around ``jax.profiler.trace``
  writing a TensorBoard/perfetto trace; activated for sampling runs via
  ``BEAT_TPU_PROFILE_DIR`` or the CLI ``sample --profile``.
* :func:`time_per_sample` — the jitted per-evaluation device time of a
  chain-batched logp (reference ``Metropolis.time_per_sample``).
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import time
from dataclasses import dataclass, field

import numpy as np

logger = logging.getLogger("beat_tpu.profiling")


@dataclass
class StageRecord:
    name: str
    wall_s: float
    n_evals: int | None = None
    extra: dict = field(default_factory=dict)

    @property
    def evals_per_s(self):
        if not self.n_evals or self.wall_s <= 0:
            return None
        return self.n_evals / self.wall_s


@dataclass
class TimingRegistry:
    """Accumulates named timing records for the current process."""

    records: list = field(default_factory=list)

    def add(self, name, wall_s, n_evals=None, **extra):
        rec = StageRecord(name, wall_s, n_evals, extra)
        self.records.append(rec)
        return rec

    def reset(self):
        self.records.clear()

    def report(self) -> dict:
        """Structured report: per-record rows + totals."""
        rows = []
        for r in self.records:
            row = {"name": r.name, "wall_s": round(r.wall_s, 6)}
            if r.n_evals:
                row["n_evals"] = r.n_evals
                rate = r.evals_per_s   # None when wall_s is degenerate
                if rate is not None:
                    row["evals_per_s"] = round(rate, 1)
            row.update(r.extra)
            rows.append(row)
        total = sum(r.wall_s for r in self.records)
        evals = sum(r.n_evals or 0 for r in self.records)
        return {"stages": rows, "total_wall_s": round(total, 6),
                "total_evals": evals}

    def summary(self) -> str:
        rep = self.report()
        lines = [f"{row['name']:<24} {row['wall_s']:>10.3f} s"
                 + (f"  {row['evals_per_s']:>12.1f} evals/s"
                    if "evals_per_s" in row else "")
                 for row in rep["stages"]]
        lines.append(f"{'total':<24} {rep['total_wall_s']:>10.3f} s")
        return "\n".join(lines)

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=1)


#: process-global registry the samplers record into
timings = TimingRegistry()


@contextlib.contextmanager
def stage_timer(name: str, n_evals: int | None = None, registry=None, **extra):
    """Record a named stage's wall-clock into the registry."""
    reg = registry if registry is not None else timings
    t0 = time.perf_counter()
    try:
        yield
    finally:
        rec = reg.add(name, time.perf_counter() - t0, n_evals, **extra)
        logger.debug("%s: %.3f s%s", name, rec.wall_s,
                     f" ({rec.evals_per_s:.1f} evals/s)"
                     if rec.evals_per_s else "")


def time_method(fn):
    """Decorator recording each call's duration (reference
    ``utility.time_method``)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with stage_timer(fn.__qualname__):
            return fn(*args, **kwargs)

    return wrapped


@contextlib.contextmanager
def jax_trace(logdir: str | None = None):
    """JAX profiler trace around a block.  ``logdir=None`` resolves from
    ``BEAT_TPU_PROFILE_DIR`` (no-op when unset)."""
    logdir = logdir or os.environ.get("BEAT_TPU_PROFILE_DIR")
    if not logdir:
        yield None
        return
    import jax

    os.makedirs(logdir, exist_ok=True)
    logger.info("JAX profiler trace -> %s", logdir)
    with jax.profiler.trace(logdir):
        yield logdir


def annotate(name: str):
    """Named profiler region for device work inside a traced block
    (shows up in the TensorBoard timeline)."""
    import jax

    return jax.profiler.TraceAnnotation(name)


def device_time(fn, *args, reps: int = 10) -> float:
    """Median seconds per call of ``fn(*args)``.  Each call ends in
    ``jax.block_until_ready`` — JAX returns before the device finishes,
    so a timing without it measures only the enqueue.  One untimed call
    first absorbs compilation."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def batched_logp(logp_fn, n_args: int):
    """Jitted chain-batched ``logp_fn(q, *logp_args)``: vmapped over
    the rows of ``q``, with the data pytrees taken as jit ARGUMENTS.  A
    closure over them would fold the GF table into the executable as a
    constant (a 100+ MB program)."""
    import jax

    return jax.jit(jax.vmap(logp_fn, in_axes=(0,) + (None,) * n_args))


def time_per_sample(logp_fn, q, logp_args=(), reps: int = 10):
    """
    Device time of one lockstep evaluation of all chains in ``q``
    (reference ``Metropolis.time_per_sample``), in seconds.
    """
    return device_time(batched_logp(logp_fn, len(logp_args)), q,
                       *logp_args, reps=reps)

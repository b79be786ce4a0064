"""
beat_tpu — Bayesian earthquake-source inversion on an accelerator.

A from-scratch JAX/XLA re-design of the capabilities of BEAT
(Bayesian Earthquake Analysis Tool, hvasbath/beat): Bayesian inversion of
earthquake & volcano sources from seismic waveforms, InSAR/GNSS static
displacements, and P-wave first-motion polarities.

Architecture (vs. the reference):

* The log-posterior is a pure JAX function of a flat parameter vector;
  ``vmap`` over a chains axis replaces the reference's fork pool
  (``beat/parallel.py``), ``jax.sharding`` over a device mesh replaces MPI
  (``beat/sampler/distributed.py``).
* Green's functions live in device-resident arrays; forward modelling
  is gathers + einsums compiled by XLA instead of per-draw calls into
  the pyrocko engine (``beat/pytensorf.py``).  The package runs on an
  NVIDIA GPU (the H100 is the measured target) and on the CPU.
* Samplers (adaptive Metropolis, SMC/transitional MCMC, parallel
  tempering) advance *all* chains in lockstep ``lax.scan`` steps; SMC
  resampling and PT replica exchange are array permutations, not IPC.
"""

__version__ = "0.2.0"

from beat_tpu import utility  # noqa: F401

"""
Device-mesh helpers: chain-parallel sharding over the local devices.

Replaces the reference's process-level runtime wholesale
(``beat/parallel.py`` fork pools + RawArray shared memory,
``beat/sampler/distributed.py`` MPI): Markov chains are rows of device
arrays sharded over a 1-D ``chains`` mesh axis; Green's-function tables
and weight matrices are replicated (or sharded when larger than one
card's memory).  XLA inserts the collectives (NCCL on GPUs) — swaps and
resampling become gathers / permutations on sharded arrays, not
messages.  The cards of one host reach each other all to all at the
same rate, so meshes follow the algorithm and take ``jax.devices()``
in order.
"""

from __future__ import annotations

import logging

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

logger = logging.getLogger("beat_tpu.parallel")

CHAIN_AXIS = "chains"
TARGET_AXIS = "targets"


def make_gf_mesh(n_chain_devices: int, n_target_devices: int) -> Mesh:
    """2-D ``(chains, targets)`` mesh: data-parallel chains × model-
    parallel GF targets.  The targets axis is the memory-budget path — a
    GF library larger than one card's memory is split along its station/
    target axis, each device stacks its local block and the partial
    log-likelihoods are ``psum``-reduced over the axis (the device
    analogue of the reference's RawArray GF sharing,
    ``beat/parallel.py:305-358``, where N workers share one host copy;
    here N cards each hold 1/N)."""
    devices = jax.devices()
    need = n_chain_devices * n_target_devices
    if len(devices) < need:
        raise ValueError(
            f"requested a {n_chain_devices}x{n_target_devices} mesh but only "
            f"{len(devices)} device(s) are available")
    return Mesh(np.array(devices[:need]).reshape(n_chain_devices,
                                                 n_target_devices),
                (CHAIN_AXIS, TARGET_AXIS))


def target_sharding(mesh: Mesh, axis: int = 0) -> NamedSharding:
    """Split an array's ``axis`` (default leading = targets/stations)
    over the mesh's targets axis; other dims replicated."""
    return NamedSharding(mesh, P(*([None] * axis + [TARGET_AXIS])))


def sharded_gf_logp(mesh: Mesh, partial_llk, in_specs):
    """
    Wrap a *per-target-block* partial log-likelihood into a shard_map
    over the ``(chains, targets)`` mesh.

    ``partial_llk(*local_args) -> (local_chains,)`` computes the llk
    contribution of this device's target block for its chain block;
    the wrapper ``psum``s over the targets axis so every chain's full
    llk materialises chain-sharded.  ``in_specs`` is a pytree of
    ``PartitionSpec``s matching the arguments (use ``P('chains')`` for
    chain-batched parameters, ``P('targets')``/``P('chains','targets')``
    for per-target arrays, ``P()`` for replicated).
    """
    def local(*args):
        return jax.lax.psum(partial_llk(*args), TARGET_AXIS)

    return jax.shard_map(local, mesh=mesh, in_specs=in_specs,
                         out_specs=P(CHAIN_AXIS), check_vma=False)


def make_chain_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over all (or the first n) local devices.

    Fails loudly when fewer devices exist than requested — a silent
    1-device mesh would fake multi-chip results."""
    devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devices)} device(s) are available "
                f"(platform={devices[0].platform})")
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (CHAIN_AXIS,))


def chain_sharding(mesh: Mesh) -> NamedSharding:
    """Rows (chains) split across the mesh; trailing dims replicated."""
    return NamedSharding(mesh, P(CHAIN_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_chain_state(state, mesh: Mesh):
    """
    Place a :class:`MetropolisState` (or any pytree whose array leaves
    have a leading chains axis) on the mesh: chain-indexed leaves are
    sharded, scalars/keys replicated.
    """
    cs = chain_sharding(mesh)
    rep = replicated(mesh)
    n_chains = state.q.shape[0]

    def place(leaf):
        if hasattr(leaf, "shape") and leaf.ndim >= 1 and leaf.shape[0] == n_chains:
            return jax.device_put(leaf, cs)
        return jax.device_put(leaf, rep)

    return jax.tree_util.tree_map(place, state)


def pad_chains(n_chains: int, n_devices: int) -> int:
    """Round the chain count up to a multiple of the device count."""
    return ((n_chains + n_devices - 1) // n_devices) * n_devices


# ---------------------------------------------------------------------------
# multi-host (the reference's MPI tier, ``beat/sampler/distributed.py``)
# ---------------------------------------------------------------------------


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> int:
    """
    Join a multi-host JAX runtime: the replacement of the reference's
    MPI launcher (``beat/sampler/distributed.py:95-146`` mpirun + SIGINT
    cleanup).

    Pass the arguments explicitly, or set ``JAX_COORDINATOR_ADDRESS``
    (``host:port``) / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``;
    nothing resolves them automatically on a GPU cluster.  After this
    call ``jax.devices()`` is GLOBAL across hosts, so
    :func:`make_chain_mesh` / :func:`make_gf_mesh` build cluster-wide
    meshes unchanged — put the chain axis across hosts and keep the
    targets axis within a host, where NVLink joins the cards.

    Returns this host's process index.  Call once, before any other
    backend-initializing JAX call.
    """
    import os

    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = _int_env("JAX_NUM_PROCESSES")
    if process_id is None:  # NOT `or`: process 0 is falsy but valid
        process_id = _int_env("JAX_PROCESS_ID")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)
    idx = jax.process_index()
    logger.info("Distributed runtime: process %i/%i, %i global devices",
                idx, jax.process_count(), len(jax.devices()))
    return idx


def _int_env(name: str):
    val = __import__("os").environ.get(name)
    return int(val) if val is not None else None


def is_io_process() -> bool:
    """True on the process that should write checkpoints/traces
    (process 0; trivially true single-host)."""
    return jax.process_index() == 0

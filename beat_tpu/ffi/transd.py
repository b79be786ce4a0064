"""
Trans-dimensional Voronoi slip sampling (reversible-jump MCMC).

The reference reserves this mode but never implements it (its
``voronoi_ext.c`` nearest-node kernel and the ``voronoi_locations``
config hook at ``beat/config.py:88`` are the stubs); here it is designed
for lockstep device execution and complete:

* the variable-dimension state lives in FIXED-shape arrays — ``K_max``
  node slots with an ``active`` mask — so every chain/step has static
  shapes and the whole sampler is one jitted ``lax.scan`` over lockstep
  ``vmap``-ped chains (no ragged structures, no recompiles across k);
* patch slips are the masked nearest-active-node values (inactive nodes
  at +inf distance) — one fused argmin per chain, the hot op of
  ``beat_tpu.ops.voronoi`` generalised with a mask;
* moves follow Bodin & Sambridge (2009): value perturbation, node move,
  birth (new node value drawn from the prior) and death.  With a
  uniform prior on k, uniform node positions and birth-from-prior
  values, the reversible-jump acceptance reduces to the likelihood
  ratio — verified here by the constant-likelihood test, under which
  the sampler must reproduce the uniform prior on k exactly.

Move types are drawn PER CHAIN per step: under ``vmap`` the four cheap
proposal branches all evaluate and a per-chain select picks one — the
expensive part (the likelihood) still runs once per chain, and the
lockstep batch stays branch-free.  (A shared per-step move type would
correlate every chain's k-walk and destroy the across-chain effective
sample size.)
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

logger = logging.getLogger("beat_tpu.ffi.transd")

VALUE, MOVE, BIRTH, DEATH = 0, 1, 2, 3


def masked_voronoi_slips(node_s, node_d, values, active, patch_s, patch_d):
    """
    Patch slips = value of the nearest ACTIVE Voronoi node.

    node_s, node_d, values, active : (K,) node slots (active: bool/0-1)
    patch_s, patch_d : (N,) patch centres on the fault plane
    Returns (N,) slips.
    """
    d2 = ((patch_s[:, None] - node_s[None, :]) ** 2
          + (patch_d[:, None] - node_d[None, :]) ** 2)
    d2 = jnp.where(active[None, :] > 0, d2, jnp.inf)
    idx = jnp.argmin(d2, axis=1)
    return values[idx]


@dataclass
class TransDParams:
    """Sampler configuration.

    k_max : node-slot capacity (static shape); k_min ≥ 1.
    value_bounds : uniform prior on node slip values.
    n_steps : total MCMC steps; value/move step scales as fractions of
        the plane extents.
    """

    k_max: int = 20
    k_min: int = 1
    n_chains: int = 128
    n_steps: int = 2000
    value_step: float = 0.1
    move_step_frac: float = 0.1
    record_every: int = 10
    seed: int = 0


def _uniform_choice(key, mask):
    """Uniform index among mask>0 slots (Gumbel-max over the mask)."""
    g = jax.random.gumbel(key, mask.shape)
    return jnp.argmax(jnp.where(mask > 0, g, -jnp.inf))


def transd_sample(
    logp_fn: Callable,
    patch_s: np.ndarray,
    patch_d: np.ndarray,
    extent_s: tuple,
    extent_d: tuple,
    value_bounds: tuple,
    params: TransDParams,
    logp_args: tuple = (),
):
    """
    Run the trans-dimensional sampler.

    logp_fn : (patch_slips (N,), *logp_args) -> scalar log-likelihood
        (pure JAX; vmapped over chains internally).
    patch_s, patch_d : (N,) patch centres.
    extent_s, extent_d : (lo, hi) node-position bounds on the plane.
    value_bounds : (lo, hi) uniform prior on node values.

    Returns dict with ``k_trace (n_rec, C)``, ``slip_trace (n_rec, C, N)``,
    ``node_traces`` (final state), ``accept_rate``.
    """
    K, C = params.k_max, params.n_chains
    ps = jnp.asarray(patch_s, dtype=jnp.float32)
    pd = jnp.asarray(patch_d, dtype=jnp.float32)
    s_lo, s_hi = (float(x) for x in extent_s)
    d_lo, d_hi = (float(x) for x in extent_d)
    v_lo, v_hi = (float(x) for x in value_bounds)
    move_s = params.move_step_frac * (s_hi - s_lo)
    move_d = params.move_step_frac * (d_hi - d_lo)
    value_step = params.value_step * (v_hi - v_lo)

    rng = np.random.default_rng(params.seed)
    key = jax.random.PRNGKey(params.seed)

    # init: k_min..(k_min+2) active nodes per chain, uniform everywhere
    k0 = rng.integers(params.k_min, min(params.k_min + 3, K) + 1, size=C)
    active0 = (np.arange(K)[None, :] < k0[:, None]).astype(np.float32)
    node_s0 = rng.uniform(s_lo, s_hi, (C, K)).astype(np.float32)
    node_d0 = rng.uniform(d_lo, d_hi, (C, K)).astype(np.float32)
    values0 = rng.uniform(v_lo, v_hi, (C, K)).astype(np.float32)

    def chain_logp(state):
        node_s, node_d, values, active = state
        slips = masked_voronoi_slips(node_s, node_d, values, active, ps, pd)
        return logp_fn(slips, *logp_args)

    v_logp = jax.vmap(chain_logp)

    def propose(state, key, move):
        """Per-chain proposal for the step's move type.  Returns
        (new_state, log_proposal_correction, valid)."""
        node_s, node_d, values, active = state
        k = jnp.sum(active)
        k_pick, k_val, k_pos = jax.random.split(key, 3)

        def do_value():
            j = _uniform_choice(k_pick, active)
            dv = value_step * jax.random.normal(k_val)
            v_new = values.at[j].add(dv)
            ok = (v_new[j] >= v_lo) & (v_new[j] <= v_hi)
            return (node_s, node_d, v_new, active), ok

        def do_move():
            j = _uniform_choice(k_pick, active)
            d_sd = jax.random.normal(k_val, (2,))
            s_new = node_s.at[j].add(move_s * d_sd[0])
            d_new = node_d.at[j].add(move_d * d_sd[1])
            ok = ((s_new[j] >= s_lo) & (s_new[j] <= s_hi)
                  & (d_new[j] >= d_lo) & (d_new[j] <= d_hi))
            return (s_new, d_new, values, active), ok

        def do_birth():
            j = _uniform_choice(k_pick, 1.0 - active)
            u = jax.random.uniform(k_val, (3,))
            s_new = node_s.at[j].set(s_lo + u[0] * (s_hi - s_lo))
            d_new = node_d.at[j].set(d_lo + u[1] * (d_hi - d_lo))
            v_new = values.at[j].set(v_lo + u[2] * (v_hi - v_lo))
            ok = k < K  # capacity
            return (s_new, d_new, v_new, active.at[j].set(1.0)), ok

        def do_death():
            j = _uniform_choice(k_pick, active)
            ok = k > params.k_min
            return (node_s, node_d, values, active.at[j].set(0.0)), ok

        # per-chain move under vmap: evaluate all four cheap branches,
        # select by the chain's move index (likelihood still runs once)
        cands = [f() for f in (do_value, do_move, do_birth, do_death)]

        def pick(*leaves):
            return jnp.select([move == m for m in range(4)], list(leaves))

        new_state = jax.tree_util.tree_map(pick, *[c[0] for c in cands])
        ok = pick(*[jnp.asarray(c[1]) for c in cands])
        return new_state, ok

    record_every = params.record_every

    @partial(jax.jit, static_argnums=(3,))
    def run(state, llk, key, n_steps):
        def step(carry, key):
            state, llk, n_acc = carry
            keys = jax.random.split(key, C + 2)
            moves = jax.random.randint(keys[C + 1], (C,), 0, 4)
            prop, ok = jax.vmap(propose)(state, keys[:C], moves)
            llk_prop = v_logp(prop)
            # birth-from-prior / uniform k prior: acceptance = L'/L
            # (Bodin & Sambridge 2009); invalid proposals auto-reject
            log_r = jnp.where(ok, llk_prop - llk, -jnp.inf)
            u = jax.random.uniform(keys[C], (C,))
            accept = jnp.log(u) < log_r

            def sel(new, old):
                shape = (C,) + (1,) * (old.ndim - 1)
                return jnp.where(accept.reshape(shape), new, old)

            state = jax.tree_util.tree_map(sel, prop, state)
            llk = jnp.where(accept, llk_prop, llk)
            return (state, llk, n_acc + accept.sum()), None

        def block(carry, block_key):
            # record only once per block: trace memory is n_rec blocks,
            # not n_steps (20k steps × 512 chains × 512 patches of
            # per-step slips would be tens of GB of scan outputs)
            carry, _ = jax.lax.scan(
                step, carry, jax.random.split(block_key, record_every))
            state, llk, _ = carry
            slips = jax.vmap(
                lambda st: masked_voronoi_slips(*st, ps, pd))(state)
            return carry, (jnp.sum(state[3], axis=1), slips, llk)

        n_rec = n_steps // record_every
        (state, llk, n_acc), (k_tr, slip_tr, llk_tr) = jax.lax.scan(
            block, (state, llk, jnp.zeros(())),
            jax.random.split(key, n_rec))
        return state, llk, n_acc, k_tr, slip_tr, llk_tr

    state = (jnp.asarray(node_s0), jnp.asarray(node_d0),
             jnp.asarray(values0), jnp.asarray(active0))
    # jit the init evaluation: eager vmap dispatches op-by-op, one
    # launch per op instead of one fused program
    llk = jax.jit(v_logp)(state)
    key, sub = jax.random.split(key)
    n_sampled = (params.n_steps // params.record_every) * params.record_every
    state, llk, n_acc, k_tr, slip_tr, llk_tr = run(
        state, llk, sub, params.n_steps)

    thin = slice(k_tr.shape[0] // 2, None)        # burn-in half
    out = {
        "k_trace": np.asarray(k_tr[thin]),
        "slip_trace": np.asarray(slip_tr[thin]),
        "llk_trace": np.asarray(llk_tr[thin]),
        "final_state": tuple(np.asarray(x) for x in state),
        "accept_rate": float(n_acc) / (n_sampled * C),
    }
    logger.info("trans-d sampling done: accept %.3f, k mean %.2f",
                out["accept_rate"], out["k_trace"].mean())
    return out

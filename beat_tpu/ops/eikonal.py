"""
Eikonal rupture-onset solver on a regular fault-patch grid.

Computes first-arrival times of a rupture front from per-patch slowness
and a nucleation point — the reference solves this with a C fast-sweeping
extension (Zhao 2004; ``beat/fast_sweeping/fast_sweep_ext.c:120``, numpy
reference ``fast_sweep.py:67``).

Device design: Gauss-Seidel sweeps are sequential in both grid
dimensions — hostile to data-parallel hardware.  We iterate the same monotone upwind update
in *Jacobi* fashion (every cell refreshed from the previous iterate),
which converges to the identical viscosity solution; each iteration
advances the front by one cell, so ``lax.while_loop`` with the
reference's convergence threshold (sum of squared changes ≤ 0.1) needs
O(grid diameter) cheap vectorised steps.  The whole solver is jittable,
differentiable and ``vmap``s over chains (slowness fields / nucleation
points).

The numpy Gauss-Seidel implementation is kept as the cross-validation
reference, mirroring the reference test strategy
(``test/test_fastsweep.py`` numpy↔C equivalence).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_INIT_TIME = 1e8
_EPSILON = 0.1


def _upwind_update(times, slowness_h):
    """One monotone upwind (Rouy-Tourin / Zhao) update of all cells."""
    # neighbor minima with edge replication (reference `upwind` clamping)
    pad = jnp.pad(times, 1, mode="edge")
    up = pad[:-2, 1:-1]
    down = pad[2:, 1:-1]
    left = pad[1:-1, :-2]
    right = pad[1:-1, 2:]

    a = jnp.minimum(up, down)      # dip-direction neighbor min
    b = jnp.minimum(left, right)   # strike-direction neighbor min
    fh = slowness_h

    # solution of [(t-a)^+]^2 + [(t-b)^+]^2 = fh^2
    one_sided = jnp.minimum(a, b) + fh
    rad = 2.0 * fh**2 - (a - b) ** 2
    two_sided = 0.5 * (a + b + jnp.sqrt(jnp.maximum(rad, 0.0)))
    candidate = jnp.where(jnp.abs(a - b) >= fh, one_sided, two_sided)
    return jnp.minimum(times, candidate)


def eikonal_rupture_times(slowness, patch_size, nuc_dip_idx, nuc_strike_idx,
                          epsilon: float = _EPSILON, max_iter: int | None = None):
    """
    Rupture onset times [s] for all patches.

    Parameters
    ----------
    slowness : (n_dip, n_strike) per-patch slowness 1/velocity [s/m or s/km]
    patch_size : patch edge length (same length unit as 1/slowness)
    nuc_dip_idx, nuc_strike_idx : nucleation patch indexes (int arrays ok)
    epsilon : convergence threshold on the summed squared update
        (reference ``fast_sweep.py:178`` err ≤ 0.1)
    max_iter : safety bound (default 4·(n_dip+n_strike) + 16)

    Returns (n_dip, n_strike) onset times, 0 at the nucleation patch.
    """
    slowness = jnp.asarray(slowness)
    n_dip, n_strike = slowness.shape
    if max_iter is None:
        max_iter = 4 * (n_dip + n_strike) + 16

    fh = slowness * patch_size
    nuc_mask = jnp.zeros_like(slowness, dtype=bool).at[nuc_dip_idx, nuc_strike_idx].set(True)
    times0 = jnp.where(nuc_mask, 0.0, jnp.full_like(slowness, _INIT_TIME))

    def cond(state):
        times, err, it = state
        return (err > epsilon) & (it < max_iter)

    def body(state):
        times, _, it = state
        new = _upwind_update(times, fh)
        new = jnp.where(nuc_mask, 0.0, new)
        err = jnp.sum((new - times) ** 2)
        return new, err, it + 1

    times, _, _ = jax.lax.while_loop(cond, body, (times0, jnp.inf, 0))
    return times


def eikonal_rupture_times_numpy(slowness, patch_size, nuc_dip_idx, nuc_strike_idx,
                                epsilon: float = _EPSILON):
    """
    Gauss-Seidel fast-sweeping reference implementation (Zhao 2004): four
    directional sweep orders per iteration, in-place updates, iterated to
    the same threshold.  Host-side ground truth for the JAX kernel.
    """
    slowness = np.asarray(slowness, dtype=np.float64)
    n_dip, n_strike = slowness.shape
    fh = slowness * patch_size
    times = np.full((n_dip, n_strike), _INIT_TIME)
    times[nuc_dip_idx, nuc_strike_idx] = 0.0

    def solve_cell(i, j):
        a = min(times[max(i - 1, 0), j], times[min(i + 1, n_dip - 1), j])
        b = min(times[i, max(j - 1, 0)], times[i, min(j + 1, n_strike - 1)])
        f = fh[i, j]
        if abs(a - b) >= f:
            cand = min(a, b) + f
        else:
            cand = 0.5 * (a + b + np.sqrt(max(2.0 * f * f - (a - b) ** 2, 0.0)))
        if cand < times[i, j]:
            times[i, j] = cand

    sweeps = [
        (range(n_dip), range(n_strike)),
        (range(n_dip - 1, -1, -1), range(n_strike)),
        (range(n_dip - 1, -1, -1), range(n_strike - 1, -1, -1)),
        (range(n_dip), range(n_strike - 1, -1, -1)),
    ]
    err = np.inf
    while err > epsilon:
        old = times.copy()
        for ii, jj in sweeps:
            for i in ii:
                for j in jj:
                    if i == nuc_dip_idx and j == nuc_strike_idx:
                        continue
                    solve_cell(i, j)
        err = float(np.sum((times - old) ** 2))
    return times

"""
First-motion polarity forward modeling.

Re-design of the polarity machinery in ``beat/heart.py``
(``PolarityTarget`` :767, ``pol_synthetics`` :4053, radiation-weight
algebra :3891-4051) without pyrocko ray tracing: takeoff vectors are
computed for straight rays in a homogeneous medium (or supplied from an
external travel-time table), and P/SH/SV amplitudes follow the standard
far-field radiation patterns γᵀMγ etc. — pure JAX, linear in m6.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np


@dataclass
class PolarityTarget:
    """One station observing a first-motion polarity
    (reference ``PolarityTarget`` ``heart.py:767``)."""

    station: str
    azimuth_rad: float            # source->station azimuth [rad]
    takeoff_rad: float            # angle from downward vertical [rad]
    polarity: int                 # observed first motion: +1 / -1
    #: epicentral distance [m] from the catalog origin — needed for
    #: per-draw takeoff re-interpolation when the location is sampled
    distance_m: float | None = None


@dataclass
class TakeoffTable:
    """
    First-arrival takeoff angles on a (depth × distance) grid, bilinearly
    gathered *inside the jitted likelihood* so the polarity geometry
    follows the sampled source location.  The reference re-ray-traces
    targets and radiation weights each draw when the location is not
    fixed (``beat/pytensorf.py:345-362``) via cake interpolation tables
    (``beat/heart.py:2333``); this is the device-resident equivalent —
    the host ray tracer fills the grid once, the gather is pure XLA.
    """

    depth_grid: object    # (nd,) source depths [m], ascending
    dist_grid: object     # (nr,) epicentral distances [m], ascending
    angles_rad: object    # (nd, nr) takeoff angles [rad from down]

    @staticmethod
    def _locate(grid, x):
        i = jnp.clip(jnp.searchsorted(grid, x, side="right") - 1,
                     0, grid.shape[0] - 2)
        w = (x - grid[i]) / (grid[i + 1] - grid[i])
        return i, jnp.clip(w, 0.0, 1.0)

    def interp(self, depth, distance):
        """Bilinear takeoff [rad] at scalar ``depth`` (traced) and
        per-target ``distance`` (traced, any shape)."""
        dg = jnp.asarray(self.depth_grid)
        rg = jnp.asarray(self.dist_grid)
        A = jnp.asarray(self.angles_rad)
        iz, wz = self._locate(dg, depth)
        ir, wr = self._locate(rg, distance)
        a00 = A[iz, ir]
        a01 = A[iz, ir + 1]
        a10 = A[iz + 1, ir]
        a11 = A[iz + 1, ir + 1]
        return ((1 - wz) * ((1 - wr) * a00 + wr * a01)
                + wz * ((1 - wr) * a10 + wr * a11))

    def as_device(self) -> dict:
        return {"to_depth_grid": jnp.asarray(self.depth_grid),
                "to_dist_grid": jnp.asarray(self.dist_grid),
                "to_angles": jnp.asarray(self.angles_rad)}

    @classmethod
    def from_device(cls, dev: dict) -> "TakeoffTable":
        return cls(depth_grid=dev["to_depth_grid"],
                   dist_grid=dev["to_dist_grid"],
                   angles_rad=dev["to_angles"])


def build_takeoff_table(model, depth_grid, dist_grid,
                        phase: str = "p") -> TakeoffTable:
    """Fill a :class:`TakeoffTable` with the host ray tracer
    (:func:`beat_tpu.heart.velocity_model.first_arrival`)."""
    from beat_tpu.heart.velocity_model import first_arrival

    depth_grid = np.asarray(depth_grid, dtype=float)
    dist_grid = np.asarray(dist_grid, dtype=float)
    ang = np.empty((depth_grid.size, dist_grid.size))
    for i, z in enumerate(depth_grid):
        for j, r in enumerate(dist_grid):
            ang[i, j] = np.deg2rad(first_arrival(model, z, r, phase)[1])
    return TakeoffTable(depth_grid=jnp.asarray(depth_grid),
                        dist_grid=jnp.asarray(dist_grid),
                        angles_rad=jnp.asarray(ang))


def radiation_weights(wavename: str, gvec, azimuth_rad, takeoff_rad):
    """Dispatch the P/SH/SV radiation linear form by phase-map name
    (reference ``calculate_radiation_weights`` ``heart.py:3891``)."""
    if wavename.lower().endswith("sh"):
        return radiation_weights_sh(gvec, azimuth_rad)
    if wavename.lower().endswith("sv"):
        return radiation_weights_sv(gvec, azimuth_rad, takeoff_rad)
    return radiation_weights_p(gvec)


def takeoff_vector(azimuth_rad, takeoff_rad):
    """Unit ray vector at the source in NED.  takeoff measured from the
    downward vertical (0 = straight down, π = straight up)."""
    st = jnp.sin(takeoff_rad)
    return jnp.stack([st * jnp.cos(azimuth_rad),
                      st * jnp.sin(azimuth_rad),
                      jnp.cos(takeoff_rad)], axis=-1)


def straight_ray_takeoff(distance, depth):
    """Takeoff angle for a direct up-going ray in a homogeneous medium."""
    return jnp.pi - jnp.arctan2(distance, depth)


def radiation_weights_p(gamma):
    """
    P radiation as a linear form on m6: amplitude = w·m6 with
    w = (γn², γe², γd², 2γnγe, 2γnγd, 2γeγd)
    (the m6-linearised γᵀMγ; reference ``calculate_radiation_weights``
    ``heart.py:3891``).
    gamma : (..., 3) unit ray vectors (NED).  Returns (..., 6).
    """
    gn, ge, gd = gamma[..., 0], gamma[..., 1], gamma[..., 2]
    return jnp.stack([gn * gn, ge * ge, gd * gd,
                      2 * gn * ge, 2 * gn * gd, 2 * ge * gd], axis=-1)


def radiation_weights_sh(gamma, azimuth_rad):
    """SH radiation linear form: (Mγ)·φ̂ with φ̂ the horizontal transverse
    unit vector."""
    phi = jnp.stack([-jnp.sin(azimuth_rad), jnp.cos(azimuth_rad),
                     jnp.zeros_like(azimuth_rad)], axis=-1)
    return _bilinear_weights(gamma, phi)


def radiation_weights_sv(gamma, azimuth_rad, takeoff_rad):
    """SV radiation linear form: (Mγ)·θ̂."""
    ct, st = jnp.cos(takeoff_rad), jnp.sin(takeoff_rad)
    theta = jnp.stack([ct * jnp.cos(azimuth_rad),
                       ct * jnp.sin(azimuth_rad),
                       -st], axis=-1)
    return _bilinear_weights(gamma, theta)


def _bilinear_weights(a, b):
    """Linear form of aᵀMb + bᵀMa (symmetrised) on m6."""
    an, ae, ad = a[..., 0], a[..., 1], a[..., 2]
    bn, be, bd = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack([an * bn, ae * be, ad * bd,
                      an * be + ae * bn,
                      an * bd + ad * bn,
                      ae * bd + ad * be], axis=-1)


def pol_synthetics(m6, weights):
    """Radiation amplitudes for precomputed weights (ntargets, 6)
    (reference ``pol_synthetics`` ``heart.py:4053``)."""
    return weights @ m6

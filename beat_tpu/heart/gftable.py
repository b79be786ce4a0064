"""
Device-resident Green's-function tables and the on-device seismic forward.

This replaces the reference's per-draw calls into pyrocko's
``engine.process`` + disk-resident fomosto stores
(``heart.seis_synthetics`` ``beat/heart.py:3564``, op wrapper
``pytensorf.SeisSynthesizer`` :129) with a fixed-shape XLA pipeline:

    table gather (bilinear in distance × depth, frequency domain)
    → moment-tensor weighting (einsum, azimuth-rotated m6)
    → × STF spectrum × time-shift phasor × bandpass response
    → inverse DFT (matmul basis) → per-target window gather → taper

Design notes:

* The table stores the response to the **six elementary moment tensors**
  for a receiver at azimuth 0, in (Z, R, T) components, on a regular
  (distance, depth) grid, as rfft spectra.  A 1-D (layered) medium is
  rotationally symmetric, so any source-receiver azimuth reduces to
  rotating the MT into the ray frame — no azimuth axis in the table.
* **All device arrays are real float32**: spectra carry a trailing
  (re, im) axis and the inverse rFFT is a matmul against a precomputed
  cos/sin basis (:mod:`beat_tpu.ops.cplx`), which folds per-target
  windowing and the taper into one product.
* Everything the sampler varies (location → distance/azimuth/depth,
  magnitude/MT, origin time, STF duration) enters through gathers and
  phase factors — shapes are chain-invariant, so one compiled program
  serves every draw (SURVEY §7 "hard part 1").
* Tables can be built (a) analytically for a homogeneous medium
  (hermetic tests; far-field P+S ray theory) or (b) converted from
  pyrocko fomosto stores offline (``beat_tpu.heart.store_convert``,
  import-gated).

Conventions: N-E-D source frame for the MT; (Z up, R radial away from
source, T = E at azimuth 0) receiver components; distances/depths in
metres; table time axis starts at ``t0`` seconds after origin time.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from beat_tpu.heart.taper import stf_spectrum_pair
from beat_tpu.ops.cplx import cexp, cmul, irfft_basis, irfft_pair

logger = logging.getLogger("beat_tpu.heart.gftable")


COMP_Z, COMP_R, COMP_T = 0, 1, 2
component_index = {"Z": COMP_Z, "R": COMP_R, "T": COMP_T}


def rotate_m6_to_ray_frame(m6, azimuth_rad):
    """
    Rotate an NED moment tensor so the receiver azimuth maps to 0 (north):
    the rotated tensor drives the azimuth-0 table entries.  Linear in m6.

    m6: (..., 6) = (mnn, mee, mdd, mne, mnd, med); azimuth in radians
    (clockwise from north, source→receiver).
    """
    ca = jnp.cos(azimuth_rad)
    sa = jnp.sin(azimuth_rad)
    mnn, mee, mdd, mne, mnd, med = (m6[..., i] for i in range(6))
    # rotation of horizontal indices by -azimuth: n' = ca·n + sa·e, e' = -sa·n + ca·e
    mnn_r = ca * ca * mnn + sa * sa * mee + 2 * ca * sa * mne
    mee_r = sa * sa * mnn + ca * ca * mee - 2 * ca * sa * mne
    mne_r = (ca * ca - sa * sa) * mne + ca * sa * (mee - mnn)
    mnd_r = ca * mnd + sa * med
    med_r = -sa * mnd + ca * med
    mdd_b = jnp.broadcast_to(mdd, mnn_r.shape)
    return jnp.stack([mnn_r, mee_r, mdd_b, mne_r, mnd_r, med_r], axis=-1)


@dataclass
class GreensTable:
    """
    Elementary-MT Green's-function spectra on a (distance, depth) grid.

    spectra : (6, 3, ndist, ndepth, nfreq, 2) float32 — rfft (re, im)
        pairs of the response to unit elementary MTs (order mnn, mee,
        mdd, mne, mnd, med), receiver at azimuth 0, components (Z, R, T).
    distances, depths : grid nodes [m]
    dt : sample interval [s]; nt : time samples; t0 : time of the first
        sample relative to origin time [s].
    """

    spectra: jnp.ndarray
    distances: np.ndarray
    depths: np.ndarray
    dt: float
    nt: int
    t0: float = 0.0
    #: medium metadata for travel-time / moment computations
    vp: float = 6000.0
    vs: float = 3500.0
    rho: float = 2700.0
    #: optional first-arrival travel-time tables (ndist, ndepth) [s] —
    #: filled by the layered builders from the ray tracer (reference
    #: stores carry cake travel-time tables, ``heart.py:2532``);
    #: straight-ray vp/vs estimates are the fallback
    tt_p: np.ndarray = None
    tt_s: np.ndarray = None
    _ibasis: tuple = field(default=None, repr=False)

    def __post_init__(self):
        # the bilinear gathers (spectra + travel times) index with a
        # uniform step — reject non-uniform grids loudly instead of
        # silently mis-weighting the interpolation
        for name in ("distances", "depths"):
            g = np.asarray(getattr(self, name), dtype=np.float64)
            if g.size > 1:
                steps = np.diff(g)
                if steps.min() <= 0 or (steps.max() - steps.min()
                                        > 1e-6 * steps.mean()):
                    raise ValueError(
                        f"GreensTable {name} must be uniformly spaced "
                        f"and increasing (bilinear index assumes a "
                        f"constant step); got steps "
                        f"[{steps.min():g}, {steps.max():g}]")
        # eager so it is never first materialised inside a jit trace
        if self._ibasis is None:
            IC, IS = irfft_basis(self.nt)
            self._ibasis = (jnp.asarray(IC), jnp.asarray(IS))

    @property
    def freqs(self) -> np.ndarray:
        return np.fft.rfftfreq(self.nt, self.dt)

    @property
    def ibasis(self):
        """(IC, IS) inverse-rFFT basis matrices (nf, nt), device arrays."""
        return self._ibasis

    def astype(self, dtype) -> "GreensTable":
        """Copy with the spectra stored in ``dtype``.

        ``jnp.bfloat16`` halves the device-memory *footprint* — a
        capacity lever for tables larger than the card.  It is not
        recommended for production likelihoods: the ~1e-3 rounding of
        the spectra is amplified by data-covariance whitening and shifts
        whitened log-likelihoods by more than the sampler's noise.
        Validate with the tests/test_float32_llk.py harness before
        using."""
        return GreensTable(spectra=jnp.asarray(self.spectra, dtype),
                           distances=self.distances, depths=self.depths,
                           dt=self.dt, nt=self.nt, t0=self.t0,
                           vp=self.vp, vs=self.vs, rho=self.rho,
                           tt_p=self.tt_p, tt_s=self.tt_s,
                           _ibasis=self._ibasis)

    def travel_time(self, phase: str, distance, depth):
        """First-arrival time [s]: bilinear lookup in the table's
        ray-traced travel-time grid when present (layered builders /
        store converters fill it), straight-ray ``r/v`` otherwise."""
        is_p = phase.lower().endswith("p")
        tt = self.tt_p if is_p else self.tt_s
        if tt is not None:
            d_grid = np.asarray(self.distances)
            z_grid = np.asarray(self.depths)
            d_step = float(d_grid[1] - d_grid[0]) if d_grid.size > 1 else 1.0
            z_step = float(z_grid[1] - z_grid[0]) if z_grid.size > 1 else 1.0
            di = jnp.clip((distance - d_grid[0]) / d_step,
                          0.0, float(d_grid.size - 1))
            zi = jnp.clip((depth - z_grid[0]) / z_step,
                          0.0, float(z_grid.size - 1))
            # cell index clamps to the LAST cell so a query at the top
            # grid node lands exactly on it (fd/fz reach 1.0) instead of
            # blending 0.1 % of the neighbour in
            d0 = jnp.minimum(jnp.floor(di).astype(jnp.int32),
                             max(d_grid.size - 2, 0))
            z0 = jnp.minimum(jnp.floor(zi).astype(jnp.int32),
                             max(z_grid.size - 2, 0))
            fd, fz = di - d0, zi - z0
            t = jnp.asarray(tt)
            return ((1 - fd) * (1 - fz) * t[d0, z0]
                    + fd * (1 - fz) * t[jnp.minimum(d0 + 1, d_grid.size - 1), z0]
                    + (1 - fd) * fz * t[d0, jnp.minimum(z0 + 1, z_grid.size - 1)]
                    + fd * fz * t[jnp.minimum(d0 + 1, d_grid.size - 1),
                                  jnp.minimum(z0 + 1, z_grid.size - 1)])
        r = jnp.sqrt(distance**2 + depth**2)
        v = self.vp if is_p else self.vs
        return r / v

    # -- the forward kernel --------------------------------------------------

    def gather_spectra(self, distance, depth, comp_idx=None):
        """
        Bilinear (distance, depth) interpolation of the table for a batch
        of targets: distance (ntargets,), depth scalar/() traced.

        With ``comp_idx`` (ntargets,) the per-target channel selection is
        FUSED into the gather — each target reads only its own Z/R/T
        block, cutting the device-memory traffic of the sampler's hottest
        gather 3×.  Returns (ntargets, 6, nfreq, 2); without it,
        (ntargets, 6, 3, nfreq, 2).

        A plain 4-corner gather: under the sampler's vmap XLA reads
        only the indexed rows.  On an NVIDIA H100 80GB HBM3 (400 W
        power limit) it runs within 1.4× of the byte floor (4 rows read
        and 1 written per query) at both the 1 MB and the 228 MB table,
        ahead of a flat-row ``take`` end to end and far ahead of a
        one-hot matmul (PERF.md § 6).
        """
        d_grid = np.asarray(self.distances)
        z_grid = np.asarray(self.depths)

        # size-1 axes degrade to nearest-node lookup (step of 1.0 keeps
        # the fractional weight at 0; the +1 corner index clamps in XLA)
        d_step = float(d_grid[1] - d_grid[0]) if d_grid.size > 1 else 1.0
        z_step = float(z_grid[1] - z_grid[0]) if z_grid.size > 1 else 1.0
        di = jnp.clip((distance - d_grid[0]) / d_step,
                      0.0, float(d_grid.size - 1))
        zi = jnp.clip((depth - z_grid[0]) / z_step,
                      0.0, float(z_grid.size - 1))
        # cell index clamps to the LAST cell so a query at the top grid
        # node is exact (fd/fz reach 1.0) — clamping the fractional
        # coordinate to size−1.001 instead blended 0.1 % of the
        # neighbour into top-edge queries
        d0 = jnp.minimum(jnp.floor(di).astype(jnp.int32),
                         max(d_grid.size - 2, 0))
        z0 = jnp.minimum(jnp.floor(zi).astype(jnp.int32),
                         max(z_grid.size - 2, 0))

        sp = self.spectra  # (6, 3, nd, nz, nf, 2)
        if comp_idx is not None:
            c = comp_idx.astype(jnp.int32)
            fd = (di - d0)[..., None, None, None]
            fz = (zi - z0)[..., None, None, None]
            g00 = sp[:, c, d0, z0]      # (6, ntargets, nf, 2)
            g10 = sp[:, c, d0 + 1, z0]
            g01 = sp[:, c, d0, z0 + 1]
            g11 = sp[:, c, d0 + 1, z0 + 1]
            return ((1 - fd) * (1 - fz) * jnp.moveaxis(g00, 1, 0)
                    + fd * (1 - fz) * jnp.moveaxis(g10, 1, 0)
                    + (1 - fd) * fz * jnp.moveaxis(g01, 1, 0)
                    + fd * fz * jnp.moveaxis(g11, 1, 0))  # (nt, 6, nf, 2)

        fd = (di - d0)[..., None, None, None, None]
        fz = (zi - z0)[..., None, None, None, None]
        g00 = sp[:, :, d0, z0]      # (6, 3, ntargets, nf, 2)
        g10 = sp[:, :, d0 + 1, z0]
        g01 = sp[:, :, d0, z0 + 1]
        g11 = sp[:, :, d0 + 1, z0 + 1]
        out = ((1 - fd) * (1 - fz) * jnp.moveaxis(g00, 2, 0)
               + fd * (1 - fz) * jnp.moveaxis(g10, 2, 0)
               + (1 - fd) * fz * jnp.moveaxis(g01, 2, 0)
               + fd * fz * jnp.moveaxis(g11, 2, 0))
        return out  # (ntargets, 6, 3, nf, 2)

    def point_spectra(self, m6, east_shift, north_shift, depth,
                      station_east, station_north, comp_idx,
                      filter_response=None):
        """
        Raw (no STF / no time shift) channel spectra of a point MT source:
        gather + azimuth-rotated weighting + optional filter.
        Returns (ntargets, nfreq, 2) float32.
        """
        de = station_east - east_shift
        dn = station_north - north_shift
        distance = jnp.sqrt(de**2 + dn**2)
        azimuth = jnp.arctan2(de, dn)

        # channel selection fused into the gather (3× less memory traffic
        # than gathering all Z/R/T and discarding two after the einsum)
        g = self.gather_spectra(distance, depth, comp_idx)     # (nt, 6, nf, 2)
        m6_ray = rotate_m6_to_ray_frame(m6[None, :], azimuth)  # (nt, 6)
        spec = jnp.einsum("tk,tkfr->tfr", m6_ray.astype(g.dtype), g)
        if filter_response is not None:
            spec = cmul(spec, filter_response[None])
        return spec

    def synthesize_spectra(self, m6, east_shift, north_shift, depth, time_shift,
                           duration, station_east, station_north,
                           comp_idx, stf_type="HalfSinusoid",
                           filter_response=None):
        """
        Frequency-domain synthesis for a batch of targets.

        m6 : (6,) NED moment tensor [Nm]
        east_shift/north_shift/depth/time_shift/duration : traced source
            scalars ([m], [s])
        station_east/station_north : (ntargets,) station coordinates [m]
        comp_idx : (ntargets,) int — 0 Z / 1 R / 2 T channel per target
        filter_response : (nfreq, 2) float or None

        Returns (ntargets, nfreq, 2) spectra of full-length traces whose
        time axis starts at ``t0`` after origin.
        """
        # route through a jitted wrapper even for eager callers (data
        # synthesis, `beat-tpu check`, bench setup): an eager call chain
        # dispatches hundreds of small ops one by one, each paying the
        # host's launch overhead; under an outer jit the nested jit is
        # transparent
        return _synthesize_spectra_jit(
            self, m6, east_shift, north_shift, depth, time_shift,
            duration, station_east, station_north, comp_idx,
            stf_type, filter_response)

    def _synthesize_spectra_impl(self, m6, east_shift, north_shift, depth,
                                 time_shift, duration, station_east,
                                 station_north, comp_idx, stf_type,
                                 filter_response):
        spec = self.point_spectra(m6, east_shift, north_shift, depth,
                                  station_east, station_north, comp_idx,
                                  filter_response)
        freqs = jnp.asarray(self.freqs)
        w = 2.0 * jnp.pi * freqs
        phasor = cexp(-w * time_shift)
        stf = stf_spectrum_pair(freqs, duration, stf_type)
        return cmul(spec, cmul(phasor, stf)[None])

    def to_time_domain(self, spec):
        """Full-length time traces from (…, nf, 2) pair spectra
        (jitted — see synthesize_spectra)."""
        return _to_time_domain_jit(self, spec)

    # -- persistence ----------------------------------------------------------

    def save(self, path: str) -> None:
        extra = {}
        if self.tt_p is not None:
            extra["tt_p"] = np.asarray(self.tt_p)
        if self.tt_s is not None:
            extra["tt_s"] = np.asarray(self.tt_s)
        np.savez_compressed(
            path, spectra=np.asarray(self.spectra, dtype=np.float32),
            distances=self.distances, depths=self.depths,
            meta=np.array([self.dt, float(self.nt), self.t0, self.vp, self.vs,
                           self.rho]), **extra)

    @classmethod
    def load(cls, path: str) -> "GreensTable":
        with np.load(path) as z:
            meta = z["meta"]
            return cls(spectra=jnp.asarray(z["spectra"]),
                       distances=z["distances"], depths=z["depths"],
                       dt=float(meta[0]), nt=int(meta[1]), t0=float(meta[2]),
                       vp=float(meta[3]), vs=float(meta[4]),
                       rho=float(meta[5]) if meta.size > 5 else 2700.0,
                       tt_p=z["tt_p"] if "tt_p" in z.files else None,
                       tt_s=z["tt_s"] if "tt_s" in z.files else None)

    def synthesize_windows(self, spec, window_starts, window_taper, nsamples_win):
        """
        Inverse DFT (matmul) + per-target window extraction + taper.

        spec : (ntargets, nfreq, 2) from :meth:`synthesize_spectra`
        window_starts : (ntargets,) static int start samples (precomputed
            from reference arrival times — chain-invariant shapes)
        window_taper : (nsamples_win,) taper amplitudes
        """
        traces = self.to_time_domain(spec)

        def cut(tr, start):
            return jax.lax.dynamic_slice(tr, (start,), (nsamples_win,))

        wins = jax.vmap(cut)(traces, window_starts)
        return wins * window_taper[None, :]

    def windowed_ibasis(self, window_starts, window_taper, nsamples_win):
        """
        Per-target inverse-DFT basis restricted to each target's taper
        window WITH the taper folded in: (ICw, ISw), each
        (ntargets, nfreq, nsamples_win).

        ``wins = einsum('tf,tfw->tw', re, ICw) + …(im, ISw)`` then equals
        :meth:`synthesize_windows` in one fused matmul — the hot-loop
        version: no full-length traces, ~nt/nsamples_win fewer iDFT
        FLOPs, no dynamic slices, taper free.  Precompute once per
        wavemap (window starts are chain-invariant).
        """
        IC, IS = self.ibasis
        starts = np.asarray(window_starts, dtype=int)
        ICw = np.stack([np.asarray(IC)[:, s:s + nsamples_win] for s in starts])
        ISw = np.stack([np.asarray(IS)[:, s:s + nsamples_win] for s in starts])
        taper = np.asarray(window_taper, dtype=np.float32)[None, None, :]
        return jnp.asarray(ICw * taper), jnp.asarray(ISw * taper)

    @staticmethod
    def synthesize_windows_fused(spec, ICw, ISw):
        """Tapered windows from pair spectra via the per-target windowed
        basis of :meth:`windowed_ibasis` → (ntargets, nsamples_win)."""
        return (jnp.einsum("tf,tfw->tw", spec[..., 0], ICw)
                + jnp.einsum("tf,tfw->tw", spec[..., 1], ISw))


def _table_flatten(t: "GreensTable"):
    """GreensTable as a JAX pytree: the device-resident arrays are
    children (so jit receives them as *arguments*, never as constants
    folded into the executable — a 100+ MB constant bloats compilation
    and the executable alike), grid/metadata are static aux data."""
    children = (t.spectra, t._ibasis[0], t._ibasis[1])

    def _tt_aux(tt):
        return (None if tt is None
                else (tuple(map(float, np.asarray(tt).ravel())),
                      np.asarray(tt).shape))

    aux = (tuple(map(float, np.asarray(t.distances).ravel())),
           tuple(map(float, np.asarray(t.depths).ravel())),
           t.dt, t.nt, t.t0, t.vp, t.vs, t.rho,
           _tt_aux(t.tt_p), _tt_aux(t.tt_s))
    return children, aux


def _table_unflatten(aux, children) -> "GreensTable":
    dists, deps, dt, nt, t0, vp, vs, rho, tt_p_aux, tt_s_aux = aux
    spectra, ic, is_ = children

    def _tt(aux_tt):
        return (None if aux_tt is None
                else np.asarray(aux_tt[0], dtype=np.float64).reshape(aux_tt[1]))

    return GreensTable(spectra=spectra,
                       distances=np.asarray(dists, dtype=np.float64),
                       depths=np.asarray(deps, dtype=np.float64),
                       dt=dt, nt=nt, t0=t0, vp=vp, vs=vs, rho=rho,
                       tt_p=_tt(tt_p_aux), tt_s=_tt(tt_s_aux),
                       _ibasis=(ic, is_))


jax.tree_util.register_pytree_node(GreensTable, _table_flatten, _table_unflatten)


def gather_spectra_numpy(table: GreensTable, distance, depth, comp_idx=None):
    """Host float64 reference of :meth:`GreensTable.gather_spectra` for
    cross-validation: the same clamping (fractional index into the grid,
    cell index into the last cell, corner index into the last node) and
    bilinear weights, evaluated in numpy.  Batched like the sampler's
    vmap: ``distance`` (..., ntargets), ``depth`` (...), giving
    (..., ntargets, 6[, 3], nfreq, 2)."""
    sp = np.asarray(table.spectra, dtype=np.float64)
    distance = np.asarray(distance, np.float64)
    depth = np.broadcast_to(np.asarray(depth, np.float64)[..., None],
                            distance.shape)

    def cell(x, grid):
        grid = np.asarray(grid, dtype=np.float64)
        step = grid[1] - grid[0] if grid.size > 1 else 1.0
        xi = np.clip((x - grid[0]) / step, 0.0, grid.size - 1)
        i0 = np.minimum(np.floor(xi).astype(int), max(grid.size - 2, 0))
        return i0, np.minimum(i0 + 1, grid.size - 1), xi - i0

    d0, d1, fd = cell(distance, table.distances)
    z0, z1, fz = cell(depth, table.depths)
    if comp_idx is None:
        def rows(d, z):                     # (..., nt, 6, 3, nf, 2)
            return np.moveaxis(sp[:, :, d, z], (0, 1), (-4, -3))
    else:
        c = np.asarray(comp_idx, dtype=int)

        def rows(d, z):                     # (..., nt, 6, nf, 2)
            return np.moveaxis(sp[:, c, d, z], 0, -3)
    extra = (None,) * (4 if comp_idx is None else 3)
    fd, fz = fd[(...,) + extra], fz[(...,) + extra]
    return ((1 - fd) * (1 - fz) * rows(d0, z0) + fd * (1 - fz) * rows(d1, z0)
            + (1 - fd) * fz * rows(d0, z1) + fd * fz * rows(d1, z1))


@partial(jax.jit, static_argnames=("stf_type",))
def _synthesize_spectra_jit(table, m6, east_shift, north_shift, depth,
                            time_shift, duration, station_east,
                            station_north, comp_idx, stf_type,
                            filter_response):
    return table._synthesize_spectra_impl(
        m6, east_shift, north_shift, depth, time_shift, duration,
        station_east, station_north, comp_idx, stf_type, filter_response)


@jax.jit
def _to_time_domain_jit(table, spec):
    IC, IS = table.ibasis
    return irfft_pair(spec, IC, IS)


# ---------------------------------------------------------------------------
# Homogeneous-medium analytic table (hermetic builder)
# ---------------------------------------------------------------------------

ELEMENTARY_M6 = np.eye(6)


def _m6_to_matrix_np(m6):
    mnn, mee, mdd, mne, mnd, med = m6
    return np.array([[mnn, mne, mnd], [mne, mee, med], [mnd, med, mdd]])


def build_homogeneous_table(distances, depths, nt, dt, vp=6000.0, vs=3500.0,
                            rho=2700.0, t0=0.0) -> GreensTable:
    """
    Analytic far-field P+S Green's functions for a homogeneous fullspace
    (Aki & Richards eq. 4.96 far-field terms): for each elementary MT,
    receiver at azimuth 0 (due north), distance d on the surface, source
    at depth z:

        u_P(t) = γ (γᵀMγ) / (4πρ vp³ r) · δ(t − r/vp)
        u_S(t) = (Mγ − γ(γᵀMγ)) / (4πρ vs³ r) · δ(t − r/vs)

    expressed directly in the frequency domain (impulses → phasors) —
    band-limited by the subsequent filters, which every dataset shares.
    The free-surface amplification factor 2 for the halfspace is applied.

    This is the hermetic stand-in for layered fomosto stores: it produces
    physically-plausible traces with correct radiation patterns,
    geometric spreading and P/S move-out, enabling full pipeline tests
    without Fortran codes (SURVEY §7 table: "psgrn/pscmp/qseis/qssp kept
    offline + analytic fallback").
    """
    distances = np.asarray(distances, dtype=np.float64)
    depths = np.asarray(depths, dtype=np.float64)
    freqs = np.fft.rfftfreq(nt, dt)
    nf = freqs.size
    spectra = np.zeros((6, 3, distances.size, depths.size, nf), dtype=np.complex128)

    w = 2.0 * np.pi * freqs
    for iz, z in enumerate(depths):
        for id_, d in enumerate(distances):
            r = math.sqrt(d * d + z * z)
            # unit ray vector source->receiver in NED (receiver north, surface)
            gamma = np.array([d, 0.0, -z]) / max(r, 1.0)
            amp_p = 2.0 / (4.0 * np.pi * rho * vp**3 * max(r, 1.0))
            amp_s = 2.0 / (4.0 * np.pi * rho * vs**3 * max(r, 1.0))
            tp = r / vp
            ts = r / vs
            ph_p = np.exp(-1j * w * (tp - t0))
            ph_s = np.exp(-1j * w * (ts - t0))
            for k in range(6):
                M = _m6_to_matrix_np(ELEMENTARY_M6[k])
                mgg = gamma @ M @ gamma
                u_p = gamma * mgg * amp_p               # NED direction vector
                u_s = (M @ gamma - gamma * mgg) * amp_s
                for u, ph in ((u_p, ph_p), (u_s, ph_s)):
                    # NED -> (Z up, R=+N, T=+E at azimuth 0)
                    uz, ur, ut = -u[2], u[0], u[1]
                    spectra[k, COMP_Z, id_, iz, :] += uz * ph
                    spectra[k, COMP_R, id_, iz, :] += ur * ph
                    spectra[k, COMP_T, id_, iz, :] += ut * ph

    pairs = np.stack([spectra.real, spectra.imag], axis=-1).astype(np.float32)
    logger.info("Built homogeneous GF table: %i dist x %i depth x %i samples",
                distances.size, depths.size, nt)
    return GreensTable(spectra=jnp.asarray(pairs), distances=distances,
                       depths=depths, dt=dt, nt=nt, t0=t0, vp=vp, vs=vs,
                       rho=rho)

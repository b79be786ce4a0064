"""
Seismic composites: waveform likelihoods for geometry mode (point/finite
sources via GF-table synthesis) and — later rounds — kinematic FFI.

Re-design of ``beat/models/seismic.py``: ``SeismicGeometryComposite``
(:637) wires ``SeisSynthesizer`` (pytensor op → pyrocko engine) into the
graph; here the full synthesis (table gather → MT weighting → STF/shift
phasors → irfft → window/taper) happens inside the jitted likelihood.
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np

from beat_tpu.distributions import multivariate_normal_chol_batched
from beat_tpu.models.base import Composite
from beat_tpu.ops.cplx import from_np_complex as _pair
from beat_tpu.sources import (CLVDSource, DCSource, DoubleDCSource,
                              ExplosionSource, MTQTSource, MTSource,
                              RectangularSource, RingfaultSource, sdr_to_m6)

logger = logging.getLogger("beat_tpu.models.seismic")


def point_getter(template, point: dict, idx: int, n_sources: int):
    """Accessor for source ``idx``'s traced parameters: sampled point
    values override template attributes (the reference's
    ``utility.split_point`` + source update)."""

    def get(name):
        if name in point:
            val = point[name]
            return val[idx] if getattr(val, "ndim", 0) > 0 and n_sources > 1 \
                else jnp.reshape(val, ())
        return jnp.asarray(getattr(template, name))

    return get


def source_m6(template, point: dict, idx: int, n_sources: int):
    """Traced NED m6 for source ``idx`` from the sampled point, falling
    back to template attribute values."""
    get = point_getter(template, point, idx, n_sources)

    if isinstance(template, MTSource):
        from beat_tpu.sources import SQRT2, magnitude_to_moment

        comps = jnp.stack([get("mnn"), get("mee"), get("mdd"),
                           get("mne"), get("mnd"), get("med")])
        # Frobenius scalar moment: off-diagonals count twice
        # (reference ``MTSourceWithMagnitude.scaled_m6``
        # ``beat/sources.py:630-637``)
        norm = jnp.sqrt(jnp.sum(comps[:3] ** 2) + 2.0 * jnp.sum(comps[3:] ** 2)) / SQRT2
        return comps / jnp.maximum(norm, 1e-20) * magnitude_to_moment(get("magnitude"))
    elif isinstance(template, MTQTSource):
        from beat_tpu.sources import mtqt_to_m6

        return mtqt_to_m6(get("w"), get("v"), get("kappa"), get("sigma"),
                          get("h"), get("magnitude"))
    elif isinstance(template, DCSource):
        from beat_tpu.sources import magnitude_to_moment

        return sdr_to_m6(get("strike"), get("dip"), get("rake"),
                         magnitude_to_moment(get("magnitude")))
    elif isinstance(template, ExplosionSource):
        from beat_tpu.sources import magnitude_to_moment

        m0 = magnitude_to_moment(get("magnitude")) if template.magnitude is not None \
            else 33e9 * get("volume_change")
        zero = jnp.zeros(())
        return jnp.stack([m0, m0, m0, zero, zero, zero])
    elif isinstance(template, CLVDSource):
        from beat_tpu.sources import magnitude_to_moment, matrix_to_m6

        az = jnp.deg2rad(get("azimuth"))
        di = jnp.deg2rad(get("dip"))
        a = jnp.stack([jnp.cos(az) * jnp.cos(di), jnp.sin(az) * jnp.cos(di),
                       jnp.sin(di)])
        m = jnp.outer(a, a) - jnp.eye(3) / 3.0
        m = m / jnp.sqrt(jnp.sum(m * m) / 2.0) \
            * magnitude_to_moment(get("magnitude"))
        return matrix_to_m6(m)
    elif isinstance(template, DoubleDCSource):
        m1, m2 = double_dc_m6_pair(get)
        return m1 + m2  # co-located sum (statics; waveforms split them)
    raise NotImplementedError(f"m6 for {type(template).__name__}")


def offset_getter(get, de, dn, dtim):
    """Wrap a point getter so positional/time reads are shifted by the
    wavemap's event offset (multi-event: source coordinates are relative
    to each event's own origin; reference ``pytensorf.py:278`` adds
    ``events[event_idx].time``)."""
    if de == 0.0 and dn == 0.0 and dtim == 0.0:
        return get
    off = {"east_shift": de, "north_shift": dn, "time": dtim}

    def get_offset(name):
        v = get(name)
        return v + off[name] if name in off else v

    return get_offset


def double_dc_m6_pair(get):
    """The two double couples of a DoubleDCSource, moment split by the
    ``mix`` factor (reference catalog's pyrocko DoubleDCSource)."""
    from beat_tpu.sources import magnitude_to_moment

    m0 = magnitude_to_moment(get("magnitude"))
    mix = get("mix")
    m1 = sdr_to_m6(get("strike1"), get("dip1"), get("rake1"), (1.0 - mix) * m0)
    m2 = sdr_to_m6(get("strike2"), get("dip2"), get("rake2"), mix * m0)
    return m1, m2


def double_dc_sub_sources(get):
    """The two separated point DCs of a DoubleDCSource:
    ``(m6, d_east, d_north, d_depth, d_time)`` per couple.  The couples
    sit at ±distance/2 along ``azimuth``; the second is additionally
    offset by ``delta_depth``/``delta_time`` (pyrocko DoubleDCSource
    semantics, used by the reference for both waveforms and statics)."""
    m1, m2 = double_dc_m6_pair(get)
    az = jnp.deg2rad(get("azimuth"))
    de = get("distance") / 2.0 * jnp.sin(az)
    dn = get("distance") / 2.0 * jnp.cos(az)
    return ((m1, -de, -dn, jnp.zeros(()), jnp.zeros(())),
            (m2, de, dn, get("delta_depth"), get("delta_time")))


def finite_rectangular_spectra(table, get, station_east, station_north,
                               comp_idx, stf_type, filter_response,
                               n_patches=(4, 4), shear_modulus=None,
                               anchor: str = "top"):
    """
    Finite-source waveform spectra of a RectangularSource: the plane is
    discretized into a fixed ``n_patches`` grid of point sources, each
    with the rupture-onset delay of a constant-velocity rupture from the
    nucleation point and 1/npatch of the total moment
    (reference: pyrocko RectangularSource discretization inside
    ``engine.process``, reached via ``heart.seis_synthetics``
    ``beat/heart.py:3564``; source params ``beat/sources.py:46-157``).

    Fixed patch count keeps shapes chain-invariant (one compiled program
    for every draw — SURVEY §7 hard part 1); positions/onsets are traced.

    Conventions: anchor 'top' = top-center (reference anchor handling
    ``sources.py:118-157``); nucleation_x ∈ [-1, 1] along strike from the
    center, nucleation_y ∈ [-1, 1] down dip (-1 = top edge).
    """
    from beat_tpu.sources import rectangular_patch_grid

    length = get("length")
    width = get("width")
    time0 = get("time")
    velocity = get("velocity")
    duration = jnp.maximum(get("duration"), 1e-3)
    slip = get("slip")

    if shear_modulus is None:
        shear_modulus = getattr(table, "rho", 2700.0) * table.vs**2
    m0_total = shear_modulus * length * width * slip

    np_l, np_w = n_patches
    east_p, north_p, depth_p, along, down = rectangular_patch_grid(
        get("strike"), get("dip"), length, width, get("east_shift"),
        get("north_shift"), get("depth"), np_l, np_w, anchor=anchor)

    nuc_along = get("nucleation_x") * length / 2.0
    nuc_down = (get("nucleation_y") + 1.0) / 2.0 * width
    rupture_dist = jnp.sqrt((along - nuc_along) ** 2 + (down - nuc_down) ** 2)
    onset_p = time0 + rupture_dist / jnp.maximum(velocity, 1.0)

    m6_patch = sdr_to_m6(get("strike"), get("dip"), get("rake"),
                         m0_total / (np_l * np_w))

    def one_patch(e, n, d, t):
        return table.synthesize_spectra(
            m6_patch, e, n, d, t, duration, station_east, station_north,
            comp_idx, stf_type=stf_type, filter_response=filter_response)

    specs = jax.vmap(one_patch)(east_p, north_p, depth_p, onset_p)
    return jnp.sum(specs, axis=0)


def recommended_finite_patches(length: float, width: float, fmax: float,
                               velocity: float = 2800.0) -> tuple:
    """
    Minimum (n_length, n_width) finite-source grid that resolves the
    filter band: the rupture-onset step across one patch
    (patch_size / rupture_velocity) must stay below a quarter of the
    shortest period 1/fmax, else the discrete point-source comb aliases
    into the fit band.  The reference delegates this to pyrocko's
    wavelength-aware auto-discretization inside ``engine.process``
    (``beat/heart.py:3564``); with our chain-invariant fixed grids the
    bound becomes a config-validation guard
    (tests/test_finite_source.py sweeps it to convergence).
    """
    def n_for(size):
        return max(2, int(np.ceil(4.0 * float(size) * float(fmax)
                                  / max(float(velocity), 1.0))))

    return n_for(length), n_for(width)


class SeismicGeometryComposite(Composite):
    """
    Waveform likelihood for point-source geometry inversion
    (reference ``SeismicGeometryComposite`` ``models/seismic.py:637``).
    """

    name = "seismic"

    def __init__(self, wavemaps, sources, stf_type="HalfSinusoid",
                 hp_specific=False, noise_analyser=None,
                 finite_patches=(4, 4), n_events=1, ensemble_tables=None):
        """
        finite_patches : (n_length, n_width) discretization of finite
            RectangularSource waveform synthesis (reference: pyrocko RS
            patch discretization inside engine.process, heart.py:3564;
            derived from ``ProblemConfig.decimation_factors``).
        n_events : multi-event problems assign source ``k`` to event
            ``k``; a wavemap then synthesizes only its
            ``sources[wavemap.event_idx]``, offset by that event's
            location/time relative to the main origin (reference
            ``models/seismic.py:798-806``, ``pytensorf.py:274-278``).
        ensemble_tables : optional GreensTables built from perturbed
            earth models (``build_gfs`` ``n_variations``) — at
            ``update_weights`` their synthetics' spread becomes the
            ``Covariance.pred_v`` prediction covariance (reference
            ``seismic_cov_velocity_models`` ``covariance.py:561``).
        """
        self.wavemaps = list(wavemaps)
        self.sources = list(sources)
        self.stf_type = stf_type
        self.hp_specific = hp_specific
        self.noise_analyser = noise_analyser
        self.finite_patches = tuple(finite_patches)
        self.ensemble_tables = list(ensemble_tables or [])
        self.n_events = int(n_events)
        if self.n_events > 1:
            if len(self.sources) != self.n_events:
                raise ValueError(
                    f"multi-event problems need one source per event: "
                    f"{len(self.sources)} sources, {self.n_events} events")
            for wmap in self.wavemaps:
                if not (0 <= wmap.event_idx < self.n_events):
                    raise ValueError(
                        f"wavemap {wmap.name}: event_idx {wmap.event_idx} "
                        f"outside [0, {self.n_events})")
        self._device = []
        for wmap in self.wavemaps:
            if wmap.datasets[0].covariance is None:
                wmap.analyse_noise(noise_analyser)
            self._device.append(self._wavemap_device(wmap))
        n_targets = sum(w.ntargets for w in self.wavemaps)
        logger.info("Seismic composite: %i wavemaps, %i targets",
                    len(self.wavemaps), n_targets)

    def _wavemap_device(self, wmap):
        dev = {
            # the GF table rides along as a pytree leaf-bundle so jit
            # receives the spectra as arguments (beat_tpu.heart.gftable
            # pytree registration), not closure constants
            "table": wmap.table,
            "data": jnp.asarray(wmap.data_fit),
            "station_east": jnp.asarray(wmap.station_east, dtype=jnp.float32),
            "station_north": jnp.asarray(wmap.station_north, dtype=jnp.float32),
            "comp_idx": jnp.asarray(wmap.comp_idx),
            "window_starts": jnp.asarray(wmap.window_starts),
            "taper": jnp.asarray(wmap.taper_window, dtype=jnp.float32),
            # fused per-target windowed iDFT basis (taper folded in) —
            # the hot-loop path; see GreensTable.windowed_ibasis
            "win_basis": wmap.table.windowed_ibasis(
                wmap.window_starts, wmap.taper_window, wmap.nsamples_win),
            # device filter response as a real (re, im) pair
            "filter": jnp.asarray(_pair(wmap.filter_response)),
            "weights": jnp.stack([jnp.asarray(ds.covariance.chol_inverse, dtype=jnp.float32)
                                  for ds in wmap.datasets]),
            "slog_pdets": jnp.asarray([ds.covariance.log_pdet for ds in wmap.datasets],
                                      dtype=jnp.float32),
            "nsamples": jnp.asarray([wmap.nsamples_fit] * wmap.ntargets,
                                    dtype=jnp.float32),
        }
        if wmap.domain == "spectrum":
            C, S = wmap.fit_basis()
            dev["fit_basis"] = (jnp.asarray(C), jnp.asarray(S))
        return dev

    # -- hyperparams --------------------------------------------------------

    def get_hypernames(self):
        if self.hp_specific:
            return [f"{w.hypername}_{i}" for w in self.wavemaps
                    for i in range(w.ntargets)]
        return [w.hypername for w in self.wavemaps]

    def get_hierarchical_names(self):
        names = []
        for wmap in self.wavemaps:
            names.extend(wmap.time_shift_names())
        return names

    # -- forward ------------------------------------------------------------

    def _source_scalar(self, point, name, idx, default):
        if name in point:
            val = point[name]
            return val[idx] if getattr(val, "ndim", 0) > 0 and len(self.sources) > 1 \
                else jnp.reshape(val, ())
        return jnp.asarray(default)

    def device_data(self):
        return list(self._device)

    def synthetics_windows(self, point: dict, wmap_idx: int, data=None):
        """(ntargets, nsamples_win) synthetic windows for one wavemap."""
        wmap = self.wavemaps[wmap_idx]
        dev = (data if data is not None else self._device)[wmap_idx]
        table = dev["table"]
        if self.n_events > 1:
            k = wmap.event_idx
            de, dn, dtim = (float(x) for x in wmap.event_offset)
            selected = [(k, self.sources[k], (de, dn, dtim))]
        else:
            selected = [(i, s, (0.0, 0.0, 0.0))
                        for i, s in enumerate(self.sources)]
        spec_total = 0.0
        for i, src, off in selected:
            get = offset_getter(
                point_getter(src, point, i, len(self.sources)), *off)
            if isinstance(src, RectangularSource):
                # finite source: patch discretization + rupture onsets
                spec = finite_rectangular_spectra(
                    table, get, dev["station_east"], dev["station_north"],
                    dev["comp_idx"], self.stf_type, dev["filter"],
                    n_patches=self.finite_patches, anchor=src.anchor)
            elif isinstance(src, DoubleDCSource):
                # two point DCs at +-distance/2 along azimuth, the second
                # offset by delta_depth/delta_time (pyrocko DoubleDCSource)
                dur = jnp.maximum(self._source_scalar(
                    point, "duration", i, getattr(src, "duration", 0.0) or 1.0), 1e-3)
                spec = 0.0
                for m6_k, de_k, dn_k, dz, dt in double_dc_sub_sources(get):
                    spec = spec + table.synthesize_spectra(
                        m6_k, get("east_shift") + de_k,
                        get("north_shift") + dn_k,
                        get("depth") + dz, get("time") + dt, dur,
                        dev["station_east"], dev["station_north"],
                        dev["comp_idx"], stf_type=self.stf_type,
                        filter_response=dev["filter"])
            elif isinstance(src, RingfaultSource):
                # ring of tangent vertical DCs (caldera collapse) — one
                # point synthesis per sub-source, shared time/duration
                m6s, de, dn, dz = src.sub_sources(get)
                dur = jnp.maximum(self._source_scalar(
                    point, "duration", i, getattr(src, "duration", 0.0) or 1.0), 1e-3)

                def one_sub(m6_k, de_k, dn_k, dz_k):
                    return table.synthesize_spectra(
                        m6_k, get("east_shift") + de_k,
                        get("north_shift") + dn_k, get("depth") + dz_k,
                        get("time"), dur,
                        dev["station_east"], dev["station_north"],
                        dev["comp_idx"], stf_type=self.stf_type,
                        filter_response=dev["filter"])

                spec = jnp.sum(jax.vmap(one_sub)(m6s, de, dn, dz), axis=0)
            else:
                m6 = source_m6(src, point, i, len(self.sources))
                spec = table.synthesize_spectra(
                    m6,
                    east_shift=get("east_shift"),
                    north_shift=get("north_shift"),
                    depth=get("depth"),
                    time_shift=get("time"),
                    duration=self._source_scalar(point, "duration", i,
                                                 getattr(src, "duration", 0.0) or 1.0),
                    station_east=dev["station_east"],
                    station_north=dev["station_north"],
                    comp_idx=dev["comp_idx"],
                    stf_type=self.stf_type,
                    filter_response=dev["filter"])
            spec_total = spec_total + spec

        # station-correction time shifts (reference models/seismic.py:1281)
        if wmap.station_corrections:
            from beat_tpu.ops.cplx import cexp, cmul

            freqs = jnp.asarray(table.freqs)
            shifts = jnp.stack([point[n] for n in wmap.time_shift_names()])
            spec_total = cmul(spec_total,
                              cexp(-2 * jnp.pi * freqs[None, :] * shifts[:, None]))

        return table.synthesize_windows_fused(spec_total, *dev["win_basis"])

    def synthetics_fit(self, point: dict, wmap_idx: int, data=None):
        """Synthetics in fit space: windows, or amplitude spectra when the
        wavemap's domain is 'spectrum' (reference ``fft_transforms``
        ``heart.py:4091``)."""
        wmap = self.wavemaps[wmap_idx]
        wins = self.synthetics_windows(point, wmap_idx, data)
        if wmap.domain == "spectrum":
            from beat_tpu.ops.cplx import amplitude_spectrum

            C, S = (data if data is not None else self._device)[wmap_idx]["fit_basis"]
            return amplitude_spectrum(wins, C, S)
        return wins

    # -- likelihood ---------------------------------------------------------

    def _hyper_vector(self, point, wmap, w_idx):
        if self.hp_specific:
            return jnp.stack([point.get(f"{wmap.hypername}_{i}", 0.0)
                              for i in range(wmap.ntargets)])
        h = point.get(wmap.hypername, 0.0)
        return jnp.broadcast_to(jnp.reshape(jnp.asarray(h), ()), (wmap.ntargets,))

    def loglike(self, point: dict, data=None):
        data = self._device if data is None else data
        total = 0.0
        for w_idx, wmap in enumerate(self.wavemaps):
            dev = data[w_idx]
            synth = self.synthetics_fit(point, w_idx, data)
            res = dev["data"] - synth
            llks = multivariate_normal_chol_batched(
                res, dev["weights"], dev["slog_pdets"],
                self._hyper_vector(point, wmap, w_idx), dev["nsamples"])
            total = total + jnp.sum(llks)
        return total

    def hyper_loglike(self, point: dict, fixed_point: dict, data=None):
        data = self._device if data is None else data
        total = 0.0
        for w_idx, wmap in enumerate(self.wavemaps):
            dev = data[w_idx]
            synth = self.synthetics_fit(fixed_point, w_idx, data)
            res = dev["data"] - synth
            llks = multivariate_normal_chol_batched(
                res, dev["weights"], dev["slog_pdets"],
                self._hyper_vector(point, wmap, w_idx), dev["nsamples"])
            total = total + jnp.sum(llks)
        return total

    def hyper_data(self, fixed_point: dict, data=None):
        """Precomputed fixed-residual terms for the hyper-only posterior:
        one full synthesis at ``fixed_point``, then hyper draws cost
        O(ntargets) (``distributions.hyper_normal``)."""
        from beat_tpu.models.base import wavemap_hyper_terms

        data = self._device if data is None else data
        synths = [self.synthetics_fit(fixed_point, w, data)
                  for w in range(len(self.wavemaps))]
        return wavemap_hyper_terms(data, synths, self.wavemaps,
                                   self.hp_specific)

    # -- updates / diagnostics ----------------------------------------------

    def update_weights(self, point: dict) -> None:
        """Covariance re-estimation at the MAP point between sampler
        stages (reference ``update_weights`` ``models/seismic.py:957``):
        the residual-based non-Toeplitz data part, plus the
        velocity-model prediction part ``pred_v`` when ensemble tables
        are configured — the parts compose into ``Covariance.p_total``."""
        non_toeplitz = (self.noise_analyser is not None
                        and self.noise_analyser.structure == "non-toeplitz")
        if not non_toeplitz and not self.ensemble_tables:
            return
        from beat_tpu.covariance import (Covariance, non_toeplitz_covariance,
                                         seismic_cov_velocity_models)

        for w_idx, wmap in enumerate(self.wavemaps):
            if non_toeplitz:
                # residuals in FIT space: time windows, or amplitude
                # spectra for domain='spectrum' — the covariance must be
                # (nsamples_fit, nsamples_fit) to match the weights
                synth = np.asarray(self.synthetics_fit(
                    {k: jnp.asarray(v) for k, v in point.items()}, w_idx))
                res = wmap.data_fit - synth
                for i, ds in enumerate(wmap.datasets):
                    cov = ds.covariance if ds.covariance is not None else Covariance()
                    cov.data = non_toeplitz_covariance(
                        res[i], window_size=max(4, res[i].size // 5))
                    ds.covariance = cov
            if self.ensemble_tables:
                pred_vs = seismic_cov_velocity_models(
                    self, point, self.ensemble_tables, w_idx)
                for ds, pv in zip(wmap.datasets, pred_vs):
                    cov = ds.covariance if ds.covariance is not None else Covariance()
                    cov.pred_v = pv
                    ds.covariance = cov
            self._device[w_idx] = self._wavemap_device(wmap)

    def get_synthetics(self, point: dict) -> dict:
        point = {k: jnp.asarray(v) for k, v in point.items()}
        out = {}
        for w_idx, wmap in enumerate(self.wavemaps):
            out[wmap.mapid] = np.asarray(
                self._jit_synthetics_windows(point, w_idx))
        return out

    def _jit_synthetics_windows(self, point: dict, w_idx: int):
        """Jit-cached eager entry for diagnostics/plots/exports: an eager
        composite forward is hundreds of separate dispatches, and
        posterior-envelope plots call it once per draw.  Device data
        ride as jit arguments, never closure constants."""
        cache = getattr(self, "_jit_win_cache", None)
        if cache is None:
            cache = self._jit_win_cache = {}
        fn = cache.get(w_idx)
        if fn is None:
            fn = cache[w_idx] = jax.jit(
                lambda p, dev: self.synthetics_windows(p, w_idx, dev))
        return fn(point, self._device)

    def _jit_synthetics_fit(self, point: dict, w_idx: int):
        """Jit-cached fit-space forward (see _jit_synthetics_windows) —
        also the per-ensemble-member entry of the velocity-model
        prediction covariances, where the swapped GF table rides as a
        pytree argument into the SAME compiled function."""
        cache = getattr(self, "_jit_fit_cache", None)
        if cache is None:
            cache = self._jit_fit_cache = {}
        fn = cache.get(w_idx)
        if fn is None:
            fn = cache[w_idx] = jax.jit(
                lambda p, dev: self.synthetics_fit(p, w_idx, dev))
        return fn(point, self._device)

    def get_variance_reductions(self, point: dict) -> dict:
        synths = self.get_synthetics(point)
        out = {}
        for wmap in self.wavemaps:
            obs = wmap.data_windows
            res = obs - synths[wmap.mapid]
            out[wmap.mapid] = 1.0 - float((res * res).sum()) / max(float((obs * obs).sum()), 1e-30)
        return out

    def seis_derivative(self, point: dict, parameter: str, wmap_idx: int = 0,
                        mode: str = "autodiff", h: float = None,
                        stencil_order: int = 3) -> np.ndarray:
        """
        Sensitivity of the synthetic waveform windows with respect to a
        source parameter (reference ``heart.seis_derivative``
        ``heart.py:3768``).  The reference numerically differentiates
        with 3/5-point stencils around re-run pyrocko syntheses; here the
        default is **exact forward-mode autodiff** through the whole
        table synthesis (``jax.jacfwd``, one jit) — ``mode="fd"`` keeps
        the reference's stencil scheme for cross-checks.

        Returns (ntargets, nsamples_win) for scalar parameters, an extra
        trailing axis per parameter component otherwise.
        """
        point = {k: jnp.asarray(v, dtype=jnp.float32) for k, v in point.items()}
        if parameter not in point:
            raise AttributeError(
                f"Parameter '{parameter}' not in point; derivatives are "
                f"available for: {', '.join(sorted(point))}")
        v0 = point[parameter]

        def wins(v):
            p = dict(point)
            p[parameter] = v
            return self.synthetics_windows(p, wmap_idx)

        if mode == "autodiff":
            jac = jax.jit(jax.jacfwd(wins))(v0)
            return np.asarray(jac)
        if mode != "fd":
            raise ValueError(f"mode must be 'autodiff' or 'fd', got {mode!r}")

        # reference-style central stencil (utility.STENCILS)
        from beat_tpu.utility import STENCILS

        if h is None:
            h = 1e-3 * max(float(jnp.max(jnp.abs(v0))), 1.0)
        st = STENCILS[stencil_order]
        offs = np.arange(len(st["coefficients"])) - len(st["coefficients"]) // 2
        f = jax.jit(wins)
        acc = 0.0
        for c, o in zip(st["coefficients"], offs):
            if c == 0.0:
                continue
            acc = acc + c * np.asarray(f(v0 + jnp.float32(o * h)))
        return acc / (st["denominator"] * h)

    def get_standardized_residuals(self, point: dict) -> dict:
        point_j = {k: jnp.asarray(v) for k, v in point.items()}
        out = {}
        for w_idx, wmap in enumerate(self.wavemaps):
            # fit-space residuals: the whitening weights live there
            synth = np.asarray(self.synthetics_fit(point_j, w_idx))
            res = wmap.data_fit - synth
            out[wmap.mapid] = np.stack([
                ds.covariance.chol_inverse @ res[i]
                for i, ds in enumerate(wmap.datasets)])
        return out


def build_seismic_composite(seismic_config, project_dir, sources,
                            event=None, events=None, finite_patches=None,
                            stf_type: str = "HalfSinusoid"):
    """
    Construct the composite from config + project data (CLI path;
    reference ``SeismicComposite.__init__`` + ``init_datahandler``/
    ``init_wavemap`` ``heart.py:3387-3465``).

    Data: ``<project_dir>/seismic_data.npz`` (native format, see
    :mod:`beat_tpu.inputf`).  Green's functions: ``gf_table.npz`` in the
    project dir if present (e.g. converted from a pyrocko store),
    otherwise a homogeneous analytic table from ``gf_config``
    (vp/vs/rho/distance & depth grids/nt/dt).

    events : optional [main EventConfig, *subevents] — wavemaps with
        ``event_idx > 0`` are windowed around their own event's
        location/time and (multi-event) synthesize only that event's
        source (reference ``models/seismic.py:107-108,798-813``).
    finite_patches : RectangularSource discretization grid (from
        ``ProblemConfig.decimation_factors``).
    """
    import os

    from beat_tpu.heart.gftable import GreensTable, build_homogeneous_table
    from beat_tpu.heart.seismic import WaveformMapping
    from beat_tpu.config import build_filterer
    from beat_tpu.heart.taper import ArrivalTaper
    from beat_tpu.inputf import load_seismic_datasets

    datadir = getattr(seismic_config, "datadir", "./")
    datasets = load_seismic_datasets(project_dir, datadir)

    import glob

    table_path = os.path.join(project_dir, "gf_table.npz")
    ensemble_tables = [
        GreensTable.load(p) for p in
        sorted(glob.glob(os.path.join(project_dir, "gf_table.var*.npz")))]
    if ensemble_tables:
        logger.info("Loaded %i velocity-model variation tables "
                    "(prediction covariances active)", len(ensemble_tables))
    if os.path.exists(table_path):
        table = GreensTable.load(table_path)
    else:
        gfc = dict(seismic_config.gf_config or {})
        table = build_homogeneous_table(
            distances=np.linspace(gfc.get("distance_min", 10e3),
                                  gfc.get("distance_max", 150e3),
                                  int(gfc.get("n_distances", 24))),
            depths=np.linspace(gfc.get("depth_min", 1e3),
                               gfc.get("depth_max", 30e3),
                               int(gfc.get("n_depths", 12))),
            nt=int(gfc.get("nt", 512)), dt=float(gfc.get("dt", 0.5)),
            vp=float(gfc.get("vp", 6000.0)), vs=float(gfc.get("vs", 3500.0)),
            rho=float(gfc.get("rho", 2700.0)))

    wavemaps = []
    for mapnumber, wfc in enumerate(seismic_config.waveforms):
        if not getattr(wfc, "include", True):
            continue
        selected = [ds for ds in datasets if ds.channel in wfc.channels]
        if not selected:
            logger.warning("Wavemap %s: no datasets for channels %s",
                           wfc.name, wfc.channels)
            continue
        overrides = None
        arrivals_path = getattr(wfc, "arrivals_path", None)
        if arrivals_path:
            from beat_tpu.inputf import load_arrivals_csv

            overrides = load_arrivals_csv(
                arrivals_path if os.path.isabs(arrivals_path)
                else os.path.join(project_dir, arrivals_path))
        event_idx = int(getattr(wfc, "event_idx", 0))
        event_offset = (0.0, 0.0, 0.0)
        if events and event_idx > 0:
            if event_idx >= len(events):
                raise ValueError(
                    f"wavemap {wfc.name}: event_idx {event_idx} but only "
                    f"{len(events)} events (main + subevents) configured")
            from beat_tpu.heart.geodesy import local_offset

            main, ev = events[0], events[event_idx]
            de, dn = local_offset(main.lat, main.lon, ev.lat, ev.lon)
            event_offset = (de, dn, float(ev.time - main.time))
        wmap = WaveformMapping(
            name=wfc.name, datasets=selected, table=table,
            taper=ArrivalTaper(wfc.arrival_taper.a, wfc.arrival_taper.b,
                               wfc.arrival_taper.c, wfc.arrival_taper.d),
            filterer=build_filterer(wfc.filterer),
            domain=wfc.domain,
            quantity=getattr(wfc, "quantity", "displacement"),
            station_corrections=getattr(seismic_config, "station_corrections",
                                        False),
            arrival_overrides=overrides,
            event_idx=event_idx, event_offset=event_offset,
            mapnumber=mapnumber,
            preprocess_data=getattr(wfc, "preprocess_data", True))
        distances = getattr(wfc, "distances", None)
        if wfc.blacklist or distances:
            deg2m = 111194.9  # mean-Earth degree of arc
            wmap.station_weeding(
                blacklist=wfc.blacklist,
                distances=(tuple(float(d) * deg2m for d in distances)
                           if distances else None),
                # epicentral distance is measured from the wavemap's own
                # event in multi-event problems, consistent with the
                # arrival windows computed from event_offset
                event_east=event_offset[0] if event_offset else 0.0,
                event_north=event_offset[1] if event_offset else 0.0)
        wavemaps.append(wmap)
    if not wavemaps:
        raise ValueError("No wavemaps configured — check waveforms config")

    from beat_tpu.covariance import SeismicNoiseAnalyser

    analyser = None
    ne = getattr(seismic_config, "noise_estimator", None)
    if ne is not None:
        analyser = SeismicNoiseAnalyser(structure=ne.structure,
                                        pre_arrival_time=ne.pre_arrival_time)
    if not getattr(seismic_config, "pre_stack_cut", True):
        logger.info("pre_stack_cut=False requested: the fused "
                    "windowed-iDFT forward is numerically the pre-cut "
                    "path, so this flag has no effect")
    return SeismicGeometryComposite(
        wavemaps, sources, stf_type=stf_type,
        hp_specific=getattr(seismic_config,
                            "dataset_specific_residual_noise_estimation", False),
        noise_analyser=analyser,
        finite_patches=finite_patches or (4, 4),
        n_events=len(events) if events else 1,
        ensemble_tables=ensemble_tables)

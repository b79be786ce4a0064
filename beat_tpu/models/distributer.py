"""
Distributed-slip (FFI) composites — linear forward models over
precomputed Green's-function libraries.

Re-design of the distributer composites in ``beat/models/geodetic.py``
(``GeodeticDistributerComposite`` :929: ``mu += gfs.stack_all(slips)``)
and ``beat/models/seismic.py`` (``SeismicDistributerComposite`` :1056:
eikonal starttimes → 5-D library ``stack_all``).
"""

from __future__ import annotations

import logging

import jax.numpy as jnp
import numpy as np

from beat_tpu.distributions import (multivariate_normal_chol,
                                    multivariate_normal_chol_batched,
                                    pinned_precision)
from beat_tpu.models.base import Composite

logger = logging.getLogger("beat_tpu.models.distributer")


class GeodeticDistributerComposite(Composite):
    """
    Static slip inversion: synthetic = Σ_c G_cᵀ s_c
    (reference ``models/geodetic.py:929-1070``).
    """

    name = "geodetic"

    def __init__(self, datasets, gflibrary, fault, hp_specific=False):
        from beat_tpu.heart.geodesy import DatasetStack

        self.datasets = list(datasets)
        self.stack = DatasetStack.from_datasets(self.datasets)
        self.gflibrary = gflibrary
        self.fault = fault
        self.hp_specific = hp_specific
        self._update_device_arrays()

    def _update_device_arrays(self):
        self._device = {
            # GF library as pytree leaves: jit arguments, shardable
            "gflib": self.gflibrary,
            "data": jnp.asarray(self.stack.displacement, dtype=jnp.float32),
            "odw": jnp.asarray(self.stack.odw, dtype=jnp.float32),
            "weights": [jnp.asarray(ds.covariance.chol_inverse, dtype=jnp.float32)
                        for ds in self.datasets],
            "slog_pdets": [jnp.float32(ds.covariance.log_pdet) for ds in self.datasets],
        }

    def get_hypernames(self):
        if self.hp_specific:
            return [f"h_{ds.typ}_{i}" for i, ds in enumerate(self.datasets)]
        return sorted({f"h_{ds.typ}" for ds in self.datasets})

    def _hyper_of(self, point, i, ds):
        name = f"h_{ds.typ}_{i}" if self.hp_specific else f"h_{ds.typ}"
        return point.get(name, 0.0)

    def synthetics_los(self, point: dict, data=None):
        gflib = self.gflibrary if data is None else data["gflib"]
        slips = {c: point.get(c) for c in gflib.component_names
                 if c in point}
        return gflib.stack_all(**slips)

    def loglike(self, point: dict, data=None):
        data = self._device if data is None else data
        synth = self.synthetics_los(point, data)
        llk = 0.0
        for i, (ds, slc) in enumerate(zip(self.datasets, self.stack.slices)):
            res = (data["data"][slc] - synth[slc]) * data["odw"][slc]
            llk = llk + multivariate_normal_chol(
                res, data["weights"][i], data["slog_pdets"][i],
                self._hyper_of(point, i, ds))
        return llk

    def hyper_loglike(self, point: dict, fixed_point: dict, data=None):
        data = self._device if data is None else data
        synth = self.synthetics_los(fixed_point, data)
        llk = 0.0
        for i, (ds, slc) in enumerate(zip(self.datasets, self.stack.slices)):
            res = (data["data"][slc] - synth[slc]) * data["odw"][slc]
            llk = llk + multivariate_normal_chol(
                res, data["weights"][i], data["slog_pdets"][i],
                self._hyper_of(point, i, ds))
        return llk

    def hyper_data(self, fixed_point: dict, data=None):
        """Precomputed ``||W r||²`` terms for the hyper-only posterior
        (one GF stack at ``fixed_point``; see ``hyper_normal``)."""
        from beat_tpu.models.base import dataset_hyper_terms

        data = self._device if data is None else data
        synth = self.synthetics_los(fixed_point, data)
        residuals = [(data["data"][slc] - synth[slc]) * data["odw"][slc]
                     for slc in self.stack.slices]
        return dataset_hyper_terms(
            residuals, data["weights"], data["slog_pdets"],
            [float(ds.samples) for ds in self.datasets],
            [f"h_{ds.typ}_{i}" if self.hp_specific else f"h_{ds.typ}"
             for i, ds in enumerate(self.datasets)])

    def get_synthetics(self, point: dict):
        point = {k: jnp.asarray(v) for k, v in point.items()}
        synth = np.asarray(self.synthetics_los(point))
        return {ds.name: synth[slc]
                for ds, slc in zip(self.datasets, self.stack.slices)}

    def get_variance_reductions(self, point: dict):
        synth = np.asarray(self.synthetics_los(
            {k: jnp.asarray(v) for k, v in point.items()}))
        out = {}
        for ds, slc in zip(self.datasets, self.stack.slices):
            obs = self.stack.displacement[slc]
            res = obs - synth[slc]
            out[ds.name] = 1.0 - (res @ res) / max(obs @ obs, 1e-30)
        return out

    def lsq_solution(self, ridge: float = 0.0):
        """
        Non-negative least-squares warm start for slip priors
        (reference ``DistributionOptimizer.lsq_solution``
        ``models/problems.py:753`` via scipy nnls).
        Returns dict component -> (npatches,) slips.
        """
        from scipy.optimize import nnls

        comps = self.gflibrary.component_names
        G_blocks = [np.asarray(self.gflibrary.gfs[c]).T for c in comps]  # (ns, np)
        G = np.concatenate(G_blocks, axis=1)
        d = np.asarray(self.stack.displacement, dtype=np.float64)
        # whiten per dataset with the covariance Cholesky inverse — the
        # reference solves the *weighted* LSQ (models/problems.py:753)
        Gw = np.empty_like(G)
        dw = np.empty_like(d)
        for i, slc in enumerate(self.stack.slices):
            W = np.asarray(self._device["weights"][i], dtype=np.float64)
            Gw[slc] = W @ G[slc]
            dw[slc] = W @ d[slc]
        if ridge > 0:
            Gw = np.vstack([Gw, np.sqrt(ridge) * np.eye(Gw.shape[1])])
            dw = np.concatenate([dw, np.zeros(Gw.shape[1])])
        sol, _ = nnls(Gw, dw)
        npatch = self.gflibrary.npatches
        return {c: sol[i * npatch:(i + 1) * npatch] for i, c in enumerate(comps)}


class SeismicDistributerComposite(Composite):
    """
    Kinematic slip inversion (reference ``SeismicDistributerComposite``
    ``models/seismic.py:1056``): eikonal rupture-onset times from
    nucleation + per-patch velocities, then the 5-D GF-library stack.
    """

    name = "seismic"

    def __init__(self, wavemaps_libs, fault, slip_varnames=("uparr",),
                 interpolation="multilinear", hp_specific=False):
        """
        wavemaps_libs : list of (WaveformMapping, {component: SeismicGFLibrary})
        """
        self.wavemaps_libs = list(wavemaps_libs)
        self.fault = fault
        self.slip_varnames = list(slip_varnames)
        self.interpolation = interpolation
        self.hp_specific = hp_specific
        self._device = []
        for wmap, libs in self.wavemaps_libs:
            if wmap.datasets[0].covariance is None:
                wmap.analyse_noise()
            dev = {
                "libs": dict(libs),
                # fit space: windows, or amplitude spectra for
                # domain='spectrum' wavemaps — the covariances/weights are
                # built at nsamples_fit, so the residual must live there
                # too (mirrors SeismicGeometryComposite)
                "data": jnp.asarray(wmap.data_fit),
                "weights": jnp.stack([
                    jnp.asarray(ds.covariance.chol_inverse, dtype=jnp.float32)
                    for ds in wmap.datasets]),
                "slog_pdets": jnp.asarray(
                    [ds.covariance.log_pdet for ds in wmap.datasets], dtype=jnp.float32),
                "nsamples": jnp.asarray([wmap.nsamples_fit] * wmap.ntargets,
                                        dtype=jnp.float32),
            }
            if wmap.domain == "spectrum":
                C, S = wmap.fit_basis()
                dev["fit_basis"] = (jnp.asarray(C), jnp.asarray(S))
            self._device.append(dev)

    def get_hypernames(self):
        if self.hp_specific:
            return [f"{wmap.hypername}_{i}" for wmap, _ in self.wavemaps_libs
                    for i in range(wmap.ntargets)]
        return [wmap.hypername for wmap, _ in self.wavemaps_libs]

    def _hyper_vector(self, point, wmap):
        """Per-target hyper vector (dataset-specific noise scaling when
        ``hp_specific``, reference ``h_<wave>_<i>`` granularity)."""
        if self.hp_specific:
            return jnp.stack([point.get(f"{wmap.hypername}_{i}", 0.0)
                              for i in range(wmap.ntargets)])
        h = point.get(wmap.hypername, 0.0)
        return jnp.broadcast_to(jnp.reshape(jnp.asarray(h), ()),
                                (wmap.ntargets,))

    def get_hierarchical_names(self):
        names = []
        for wmap, _ in self.wavemaps_libs:
            names.extend(wmap.time_shift_names())
        return names

    def point2starttimes(self, point: dict):
        """Eikonal onset times for all patches, SI units (m, m/s).
        Multi-subfault: per-subfault nucleation coordinates/times are
        vector-valued (reference ``hypo_vars`` per subfault,
        ``ffi/fault.py:614``)."""
        velocities = point["velocities"]
        ordering = self.fault.ordering
        times = []
        for i in range(self.fault.nsubfaults):
            sf = self.fault.get_subfault(i)

            def comp(name, default):
                if name not in point:
                    return jnp.asarray(default)
                val = jnp.atleast_1d(jnp.asarray(point[name]))
                return val[i] if val.shape[0] > 1 else val[0]

            nuc_strike = comp("nucleation_strike", sf.plane.length / 2.0)
            nuc_dip = comp("nucleation_dip", sf.plane.width / 2.0)
            time = comp("time", 0.0)
            vel_i = ordering.vector2subfault(i, velocities)
            times.append(self.fault.point2starttimes(i, vel_i, nuc_strike,
                                                     nuc_dip, time))
        return jnp.concatenate(times)

    def device_data(self):
        return list(self._device)

    def synthetics_windows(self, point: dict, w_idx: int, data=None):
        wmap, _ = self.wavemaps_libs[w_idx]
        libs = (data if data is not None else self._device)[w_idx]["libs"]
        starttimes_patch = self.point2starttimes(point)      # (npatches,)
        durations = point.get(
            "durations", jnp.ones(self.fault.npatches))

        ntargets = wmap.ntargets
        st = jnp.broadcast_to(starttimes_patch[None, :],
                              (ntargets, self.fault.npatches))
        # station-correction time shifts subtract from starttimes
        # (reference models/seismic.py:1281-1296)
        ts_names = wmap.time_shift_names()
        if ts_names:
            shifts = jnp.stack([point[n] for n in ts_names])
            st = st - shifts[:, None]

        synth = 0.0
        for comp in self.slip_varnames:
            synth = synth + libs[comp].stack_all(durations, st, point[comp],
                                                 self.interpolation)
        return synth

    def synthetics_fit(self, point: dict, w_idx: int, data=None):
        """Stacked synthetics in fit space (windows or amplitude
        spectra, matching the wavemap's domain)."""
        wmap, _ = self.wavemaps_libs[w_idx]
        wins = self.synthetics_windows(point, w_idx, data)
        if wmap.domain == "spectrum":
            from beat_tpu.ops.cplx import amplitude_spectrum

            C, S = (data if data is not None else self._device)[w_idx]["fit_basis"]
            return amplitude_spectrum(wins, C, S)
        return wins

    def loglike(self, point: dict, data=None):
        data = self._device if data is None else data
        total = 0.0
        for w_idx, (wmap, libs) in enumerate(self.wavemaps_libs):
            dev = data[w_idx]
            synth = self.synthetics_fit(point, w_idx, data)
            res = dev["data"] - synth
            llks = multivariate_normal_chol_batched(
                res, dev["weights"], dev["slog_pdets"],
                self._hyper_vector(point, wmap), dev["nsamples"])
            total = total + jnp.sum(llks)
        return total

    def hyper_loglike(self, point: dict, fixed_point: dict, data=None):
        data = self._device if data is None else data
        total = 0.0
        for w_idx, (wmap, libs) in enumerate(self.wavemaps_libs):
            dev = data[w_idx]
            synth = self.synthetics_fit(fixed_point, w_idx, data)
            res = dev["data"] - synth
            llks = multivariate_normal_chol_batched(
                res, dev["weights"], dev["slog_pdets"],
                self._hyper_vector(point, wmap), dev["nsamples"])
            total = total + jnp.sum(llks)
        return total

    def hyper_data(self, fixed_point: dict, data=None):
        """Precomputed fixed-residual terms for the hyper-only posterior
        (one 5-D stack at ``fixed_point``; see ``hyper_normal``)."""
        from beat_tpu.models.base import wavemap_hyper_terms

        data = self._device if data is None else data
        synths = [self.synthetics_fit(fixed_point, w, data)
                  for w in range(len(self.wavemaps_libs))]
        return wavemap_hyper_terms(
            data, synths, [wm for wm, _ in self.wavemaps_libs],
            self.hp_specific)

    def get_synthetics(self, point: dict):
        point = {k: jnp.asarray(v) for k, v in point.items()}
        return {wmap.mapid: np.asarray(self.synthetics_windows(point, i))
                for i, (wmap, _) in enumerate(self.wavemaps_libs)}

    def get_variance_reductions(self, point: dict):
        synths = self.get_synthetics(point)
        out = {}
        for wmap, _ in self.wavemaps_libs:
            obs = wmap.data_windows
            res = obs - synths[wmap.mapid]
            out[wmap.mapid] = 1.0 - float((res * res).sum()) / max(float((obs * obs).sum()), 1e-30)
        return out


def transd_sample_ffi(composite, params, slip_varname: str | None = None,
                      value_bounds: tuple | None = None,
                      homepath: str | None = None, logp_args=None):
    """
    Trans-dimensional Voronoi slip inversion on a distributer composite
    (the reference's reserved-but-unimplemented trans-d mode,
    ``beat/config.py:88`` ``voronoi_locations``): node birth/death RJ-MCMC
    over the fault plane with patch slips = nearest-active-node values
    (:mod:`beat_tpu.ffi.transd`).

    composite : GeodeticDistributerComposite.  Multi-subfault faults are
        unrolled into one along-strike atlas: subfault ``i`` occupies the
        strike interval ``[Σ_{j<i} length_j, Σ_{j≤i} length_j]`` with its
        local down-dip coordinate, so one Voronoi node field spans the
        whole fault (the reference's ``transd_vars_dist`` registry spans
        all subfaults, ``beat/config.py:88-96``).
    value_bounds : slip prior bounds; defaults to the registry bounds of
        the slip component.
    homepath : optional stage dir — saves the thinned slip trace as a
        final stage so summarize/plot work unchanged.

    Returns the transd output dict (k_trace, slip_trace, …).
    """
    from beat_tpu.ffi.transd import transd_sample

    fault = composite.fault
    comp = slip_varname or composite.gflibrary.component_names[0]
    if value_bounds is None:
        from beat_tpu.parameter import Parameter

        par = Parameter.from_defaults(comp)
        value_bounds = (float(np.atleast_1d(par.lower)[0]),
                        float(np.atleast_1d(par.upper)[0]))

    # unrolled fault atlas: concatenate patch grids side by side along
    # strike (fault ordering is subfault-major, so the concatenated
    # centers line up with the slip-vector layout loglike consumes)
    sfs = [fault.get_subfault(i) for i in range(fault.nsubfaults)]
    s_off = np.concatenate([[0.0],
                            np.cumsum([sf.plane.length for sf in sfs])])
    centers = np.concatenate(
        [sf.patch_centers_local() + np.array([s_off[i], 0.0])
         for i, sf in enumerate(sfs)])

    # GF library/data/weights ride through the jit boundary as an explicit
    # argument pytree (logp_args), never as closure constants — same
    # invariant as Problem.make_logp_fn (models/problem.py)
    args = logp_args if logp_args is not None else (composite._device,)

    @pinned_precision
    def logp(slips, device):
        return composite.loglike({comp: slips}, data=device)

    out = transd_sample(
        logp, centers[:, 0], centers[:, 1],
        extent_s=(0.0, float(s_off[-1])),
        extent_d=(0.0, max(float(sf.plane.width) for sf in sfs)),
        value_bounds=value_bounds, params=params, logp_args=args)

    if homepath is not None:
        from beat_tpu.backend import SampleStage
        from beat_tpu.utility import Ordering

        ordering = Ordering([(comp, (fault.npatches,))])
        handler = SampleStage(homepath, ordering=ordering)
        handler.save_stage(-1, {"q": out["slip_trace"],
                                "llk": out["llk_trace"]},
                           {"beta": 1.0, "k_trace": out["k_trace"],
                            "accept_rate": out["accept_rate"]})
    return out

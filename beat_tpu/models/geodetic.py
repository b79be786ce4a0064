"""
Geodetic composites: static surface-displacement likelihoods.

Re-design of ``beat/models/geodetic.py``: the reference wires a pytensor
graph with a ``GeoSynthesizer`` op calling pyrocko per draw
(``GeodeticGeometryComposite.get_formula`` :605); here the forward model
(Okada halfspace, later layered GF tables) runs inside the jitted
log-likelihood, vmapped over chains.

Data flow per evaluation (matching ``models/geodetic.py:605-680``):
point -> per-source surface displacements (summed) -> LOS projection
``(disp · los).sum(-1)`` -> corrections -> residual ``(obs - synth)·odw``
-> per-dataset Cholesky-weighted Gaussian log-likelihood with noise
hyperparameter scaling.
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np

from beat_tpu.covariance import GeodeticNoiseAnalyser
from beat_tpu.distributions import multivariate_normal_chol
from beat_tpu.heart.corrections import EulerPoleCorrection, RampCorrection, StrainRateCorrection
from beat_tpu.heart.geodesy import DatasetStack
from beat_tpu.heart.okada import okada_surface_displacement
from beat_tpu.models.base import Composite
from beat_tpu.sources import RectangularSource

logger = logging.getLogger("beat_tpu.models.geodetic")


class GeodeticComposite(Composite):
    """
    Shared machinery: dataset stacking, weights, hyperparams, corrections
    (reference ``GeodeticComposite`` ``models/geodetic.py:40``).
    """

    name = "geodetic"

    def __init__(self, datasets, noise_structure="import", hp_specific=False,
                 corrections=None):
        self.datasets = list(datasets)
        self.stack = DatasetStack.from_datasets(self.datasets)
        self.hp_specific = hp_specific
        self.noise_analyser = GeodeticNoiseAnalyser(structure=noise_structure)
        self.corrections = list(corrections or [])
        self._device = {}
        self._update_device_arrays()
        logger.info("Geodetic composite: %i datasets, %i data points",
                    len(self.datasets), self.stack.samples)

    # -- weights ------------------------------------------------------------

    def _update_device_arrays(self):
        """Refresh per-dataset weight matrices on device
        (reference ``init_weights`` ``models/geodetic.py``)."""
        self._device = {
            "data": jnp.asarray(self.stack.displacement, dtype=jnp.float32),
            "los": jnp.asarray(self.stack.los, dtype=jnp.float32),
            "odw": jnp.asarray(self.stack.odw, dtype=jnp.float32),
            "coords": jnp.asarray(self.stack.coords, dtype=jnp.float32),
            "weights": [jnp.asarray(ds.covariance.chol_inverse, dtype=jnp.float32)
                        for ds in self.datasets],
            "slog_pdets": [jnp.float32(ds.covariance.log_pdet) for ds in self.datasets],
        }
        if getattr(self, "static_table", None) is not None:
            self._device["static_table"] = self.static_table

    def update_weights(self, point: dict) -> None:
        """Non-Toeplitz / residual-based covariance update at the MAP point
        (reference ``analyse_noise`` ``models/geodetic.py:143``)."""
        if self.noise_analyser.structure == "import":
            return
        synth = np.asarray(self.synthetics_los_np(point))
        for ds, slc in zip(self.datasets, self.stack.slices):
            # subtract the sampled correction displacements exactly as
            # loglike does — otherwise ramps/plate motions are absorbed
            # into the re-estimated noise covariance
            corr = np.asarray(self._correction_displacement(point, ds, slc))
            residual = self.stack.displacement[slc] - synth[slc] - corr
            ds.covariance.data = self.noise_analyser.get_data_covariance(
                ds.coords, ds.displacement, residual=residual)
        self._update_device_arrays()

    # -- hyperparameters ----------------------------------------------------

    def get_hypernames(self):
        if self.hp_specific:
            return [f"h_{ds.typ}_{i}" for i, ds in enumerate(self.datasets)]
        return sorted({f"h_{ds.typ}" for ds in self.datasets})

    def _hyper_of(self, point, i, ds):
        name = f"h_{ds.typ}_{i}" if self.hp_specific else f"h_{ds.typ}"
        return point.get(name, 0.0)

    # -- hierarchicals ------------------------------------------------------

    def get_hierarchical_names(self):
        names = []
        for corr in self.corrections:
            for n in corr.parameter_names:
                # per-dataset instances of one correction entry share
                # their hierarchicals — register each name once
                if n not in names:
                    names.append(n)
        return names

    def _correction_displacement(self, point, ds, slc, data=None):
        """Summed correction displacement for one dataset (LOS units)."""
        data = self._device if data is None else data
        out = 0.0
        for corr in self.corrections:
            if isinstance(corr, RampCorrection):
                if corr.dataset_name != ds.name:
                    continue
                out = out + corr.displacement(point, data["coords"][slc])
            elif isinstance(corr, (EulerPoleCorrection, StrainRateCorrection)):
                if ds.typ != "GNSS":
                    continue
                # per-dataset instances; a None dataset_name applies to
                # every GNSS dataset (legacy single-dataset setups)
                if corr.dataset_name is not None and corr.dataset_name != ds.name:
                    continue
                out = out + corr.displacement(point, data["los"][slc])
        return out

    # -- likelihood ---------------------------------------------------------

    def loglike(self, point: dict, data=None):
        data = self._device if data is None else data
        synth = self.synthetics_los(point, data)
        llk = 0.0
        for i, (ds, slc) in enumerate(zip(self.datasets, self.stack.slices)):
            corr = self._correction_displacement(point, ds, slc, data)
            res = (data["data"][slc] - synth[slc] - corr) * data["odw"][slc]
            llk = llk + multivariate_normal_chol(
                res, data["weights"][i], data["slog_pdets"][i],
                self._hyper_of(point, i, ds))
        return llk

    def hyper_loglike(self, point: dict, fixed_point: dict, data=None):
        """Hyperparameter-only likelihood with residuals frozen at
        ``fixed_point`` (reference ``get_hyper_formula``)."""
        data = self._device if data is None else data
        synth = self.synthetics_los(fixed_point, data)
        llk = 0.0
        for i, (ds, slc) in enumerate(zip(self.datasets, self.stack.slices)):
            corr = self._correction_displacement(fixed_point, ds, slc, data)
            res = (data["data"][slc] - synth[slc] - corr) * data["odw"][slc]
            llk = llk + multivariate_normal_chol(
                res, data["weights"][i], data["slog_pdets"][i],
                self._hyper_of(point, i, ds))
        return llk

    def hyper_data(self, fixed_point: dict, data=None):
        """Precomputed fixed-residual terms for the hyper-only posterior
        (reference ``hyper_normal``, ``models/distributions.py:176``):
        one forward at ``fixed_point``, then every hyper draw is O(D).
        Returns (``||W r||²`` (D,), slog_pdets (D,), nsamples (D,),
        per-dataset hyper names)."""
        from beat_tpu.models.base import dataset_hyper_terms

        data = self._device if data is None else data
        synth = self.synthetics_los(fixed_point, data)
        residuals = [
            (data["data"][slc] - synth[slc]
             - self._correction_displacement(fixed_point, ds, slc, data))
            * data["odw"][slc]
            for ds, slc in zip(self.datasets, self.stack.slices)]
        return dataset_hyper_terms(
            residuals, data["weights"], data["slog_pdets"],
            [float(ds.samples) for ds in self.datasets],
            [f"h_{ds.typ}_{i}" if self.hp_specific else f"h_{ds.typ}"
             for i, ds in enumerate(self.datasets)])

    # -- diagnostics --------------------------------------------------------

    def get_synthetics(self, point: dict) -> dict:
        synth = np.asarray(self.synthetics_los_np(point))
        return {ds.name: synth[slc] for ds, slc in zip(self.datasets, self.stack.slices)}

    def get_standardized_residuals(self, point: dict) -> dict:
        """Residuals whitened by the covariance Cholesky factor
        (reference ``get_standardized_residuals``)."""
        synth = np.asarray(self.synthetics_los_np(point))
        out = {}
        for i, (ds, slc) in enumerate(zip(self.datasets, self.stack.slices)):
            corr = np.asarray(self._correction_displacement(point, ds, slc))
            res = (self.stack.displacement[slc] - synth[slc] - corr) \
                * self.stack.odw[slc]
            out[ds.name] = ds.covariance.chol_inverse @ res
        return out

    def get_variance_reductions(self, point: dict) -> dict:
        synth = np.asarray(self.synthetics_los_np(point))
        out = {}
        for ds, slc in zip(self.datasets, self.stack.slices):
            corr = np.asarray(self._correction_displacement(point, ds, slc))
            obs = self.stack.displacement[slc]
            res = obs - synth[slc] - corr
            out[ds.name] = 1.0 - (res @ res) / max(obs @ obs, 1e-30)
        return out


class GeodeticGeometryComposite(GeodeticComposite):
    """
    Nonlinear source-geometry forward: sum of rectangular-dislocation
    sources, analytic halfspace (reference ``GeodeticGeometryComposite``
    ``models/geodetic.py:681``; engine replaced by the Okada kernel).
    """

    #: source families with analytic halfspace statics: rectangles via
    #: Okada, explosions via Mogi, MT families via the eigen-crack
    #: decomposition (okada.mt_surface_displacement).  With a
    #: ``static_table`` (layered psgrn analogue,
    #: :mod:`beat_tpu.heart.statictable`) all sources route through the
    #: table instead: point MTs directly, rectangles as fixed patch
    #: grids of point MTs with depth-dependent moduli (pscmp strategy,
    #: reference ``heart.py:4158``).
    def __init__(self, datasets, sources, nu=0.25, shear_modulus=33e9,
                 static_table=None, finite_patches=(4, 4),
                 ensemble_nus=None, ensemble_tables=None, **kwargs):
        """
        ensemble_nus / ensemble_tables : earth-model uncertainty ensemble
            (Poisson-ratio variations for the homogeneous path, perturbed
            layered static tables for the table path) — their synthetics'
            spread becomes ``Covariance.pred_v`` at ``update_weights``
            (reference ``geodetic_cov_velocity_models``
            ``covariance.py:625``).
        """
        super().__init__(datasets, **kwargs)
        self.sources = list(sources)
        self.nu = nu
        self.shear_modulus = shear_modulus
        self.static_table = static_table
        self.finite_patches = tuple(finite_patches)
        self.ensemble_nus = tuple(ensemble_nus) if ensemble_nus else None
        self.ensemble_tables = list(ensemble_tables or [])
        if static_table is not None:
            self._device["static_table"] = static_table

    def update_weights(self, point: dict) -> None:
        super().update_weights(point)
        if not self.ensemble_nus and not self.ensemble_tables:
            return
        from beat_tpu.covariance import geodetic_cov_velocity_models

        pred_vs = geodetic_cov_velocity_models(
            self, point, nus=self.ensemble_nus or (0.2, 0.25, 0.3),
            ensemble_tables=self.ensemble_tables)
        for ds, pv in zip(self.datasets, pred_vs):
            ds.covariance.pred_v = pv
        self._update_device_arrays()

    def _source_kwargs(self, point: dict, i: int) -> dict:
        """Pull source-i parameters from the sampled point, falling back to
        the template source (reference ``utility.split_point`` + sources)."""
        src = self.sources[i]
        kwargs = {}
        for name in ("east_shift", "north_shift", "depth", "strike", "dip",
                     "rake", "length", "width", "slip", "opening_fraction"):
            if name in point:
                val = point[name]
                val = val[i] if getattr(val, "ndim", 0) > 0 and len(self.sources) > 1 else jnp.reshape(val, ())
                kwargs[name] = val
            else:
                kwargs[name] = getattr(src, name)
        return kwargs

    def synthetics_los(self, point: dict, data=None):
        """LOS-projected synthetic displacement, pure JAX (Ntot,)."""
        from beat_tpu.heart.okada import mogi_surface_displacement, mt_surface_displacement
        from beat_tpu.sources import (CLVDSource, DCSource, DoubleDCSource,
                                      ExplosionSource, MTQTSource, MTSource,
                                      RingfaultSource)

        data = self._device if data is None else data
        coords = data["coords"]
        if "static_table" in data:
            return self._synthetics_los_table(point, data)
        disp = jnp.zeros((coords.shape[0], 3))
        for i, src in enumerate(self.sources):
            def get(name, i=i, src=src):
                if name in point:
                    val = point[name]
                    return val[i] if getattr(val, "ndim", 0) > 0 and len(self.sources) > 1 \
                        else jnp.reshape(val, ())
                return jnp.asarray(getattr(src, name))

            if isinstance(src, ExplosionSource):
                disp = disp + mogi_surface_displacement(
                    coords, east_shift=get("east_shift"),
                    north_shift=get("north_shift"), depth=get("depth"),
                    volume_change=get("volume_change"), nu=self.nu)
            elif isinstance(src, DoubleDCSource):
                # two separated point DCs (mirrors the seismic branch;
                # the co-located sum is wrong once distance >> 0)
                from beat_tpu.models.seismic import double_dc_sub_sources

                for m6_k, de_k, dn_k, dz_k, _ in double_dc_sub_sources(get):
                    disp = disp + mt_surface_displacement(
                        coords, m6_k, east_shift=get("east_shift") + de_k,
                        north_shift=get("north_shift") + dn_k,
                        depth=get("depth") + dz_k,
                        nu=self.nu, shear_modulus=self.shear_modulus)
            elif isinstance(src, (MTSource, MTQTSource, DCSource, CLVDSource)):
                from beat_tpu.models.seismic import source_m6

                m6 = source_m6(src, point, i, len(self.sources))
                disp = disp + mt_surface_displacement(
                    coords, m6, east_shift=get("east_shift"),
                    north_shift=get("north_shift"), depth=get("depth"),
                    nu=self.nu, shear_modulus=self.shear_modulus)
            elif isinstance(src, RingfaultSource):
                import jax

                m6s, de, dn, dz = src.sub_sources(get)

                def one_sub(m6_k, de_k, dn_k, dz_k):
                    return mt_surface_displacement(
                        coords, m6_k, east_shift=get("east_shift") + de_k,
                        north_shift=get("north_shift") + dn_k,
                        depth=get("depth") + dz_k,
                        nu=self.nu, shear_modulus=self.shear_modulus)

                disp = disp + jnp.sum(jax.vmap(one_sub)(m6s, de, dn, dz),
                                      axis=0)
            elif isinstance(src, RectangularSource):
                kw = self._source_kwargs(point, i)
                opening_frac = kw.pop("opening_fraction")
                slip_total = kw.pop("slip")
                disp = disp + okada_surface_displacement(
                    coords, slip=slip_total * (1.0 - jnp.abs(opening_frac)),
                    opening=slip_total * opening_frac, nu=self.nu,
                    anchor=src.anchor, **kw)
            else:
                raise NotImplementedError(
                    f"Geodetic statics for {type(src).__name__} (use the BEM "
                    "composite for meshed sources)")
        return jnp.sum(disp * data["los"], axis=-1)

    def _synthetics_los_table(self, point: dict, data):
        """Layered-media statics through the StaticGFTable: point MTs via
        one gather each, rectangles as patch grids of point MTs with the
        local shear modulus (pscmp patch integration, ref heart.py:4158)."""
        from beat_tpu.models.seismic import point_getter, source_m6
        from beat_tpu.sources import (DoubleDCSource, RingfaultSource,
                                      rectangular_patch_grid, sdr_to_m6,
                                      tensile_m6)

        table = data["static_table"]
        coords = data["coords"]
        obs_e, obs_n = coords[:, 0], coords[:, 1]
        disp = jnp.zeros((coords.shape[0], 3))
        for i, src in enumerate(self.sources):
            get = point_getter(src, point, i, len(self.sources))
            if isinstance(src, RectangularSource):
                np_l, np_w = self.finite_patches
                length, width = get("length"), get("width")
                east_p, north_p, depth_p, _, _ = rectangular_patch_grid(
                    get("strike"), get("dip"), length, width,
                    get("east_shift"), get("north_shift"), get("depth"),
                    np_l, np_w, anchor=src.anchor)
                area = length * width / (np_l * np_w)
                slip_total = get("slip")
                frac = get("opening_fraction")
                slip_shear = slip_total * (1.0 - jnp.abs(frac))
                opening = slip_total * frac

                def one_patch(e, n, d):
                    mu_z = table.shear_modulus(d)
                    m6 = sdr_to_m6(get("strike"), get("dip"), get("rake"),
                                   mu_z * area * slip_shear)
                    m6 = m6 + tensile_m6(get("strike"), get("dip"),
                                         area * opening,
                                         lam=table.lame_lambda(d), mu=mu_z)
                    return table.synthesize_enu(m6, e, n, d, obs_e, obs_n)

                import jax

                disp = disp + jnp.sum(
                    jax.vmap(one_patch)(east_p, north_p, depth_p), axis=0)
            elif isinstance(src, RingfaultSource):
                import jax

                m6s, de, dn, dz = src.sub_sources(get)
                disp = disp + jnp.sum(jax.vmap(
                    lambda m6_k, de_k, dn_k, dz_k: table.synthesize_enu(
                        m6_k, get("east_shift") + de_k,
                        get("north_shift") + dn_k, get("depth") + dz_k,
                        obs_e, obs_n))(m6s, de, dn, dz), axis=0)
            elif isinstance(src, DoubleDCSource):
                from beat_tpu.models.seismic import double_dc_sub_sources

                for m6_k, de_k, dn_k, dz_k, _ in double_dc_sub_sources(get):
                    disp = disp + table.synthesize_enu(
                        m6_k, get("east_shift") + de_k,
                        get("north_shift") + dn_k, get("depth") + dz_k,
                        obs_e, obs_n)
            else:
                m6 = source_m6(src, point, i, len(self.sources))
                disp = disp + table.synthesize_enu(
                    m6, get("east_shift"), get("north_shift"), get("depth"),
                    obs_e, obs_n)
        return jnp.sum(disp * data["los"], axis=-1)

    def synthetics_los_np(self, point: dict):
        """Jit-cached eager entry (diagnostics/plots/exports) — an eager
        forward is hundreds of separate dispatches; device data ride as
        jit arguments."""
        point = {k: jnp.asarray(v) for k, v in point.items()}
        fn = getattr(self, "_jit_los", None)
        if fn is None:
            fn = self._jit_los = jax.jit(
                lambda p, d: self.synthetics_los(p, d))
        return fn(point, self._device)

"""
End-to-end geodetic geometry inversion: synthetic InSAR scene from a
known rectangular source, SMC recovery of the source parameters — the
JAX analogue of the reference Rectangular docs example
(``docs/examples/Rectangular.rst``) at toy scale.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from beat_tpu.covariance import Covariance
from beat_tpu.heart.geodesy import DatasetStack, diff_ifg, gnss_compound
from beat_tpu.heart.okada import okada_surface_displacement
from beat_tpu.models.geodetic import GeodeticGeometryComposite
from beat_tpu.models.problem import Problem
from beat_tpu.parameter import Parameter, PriorSet
from beat_tpu.samplers import SMCParams
from beat_tpu.sources import RectangularSource

TRUE = dict(east_shift=1500.0, depth=2000.0, slip=1.2)
FIXED = dict(north_shift=0.0, strike=30.0, dip=60.0, rake=90.0,
             length=8000.0, width=4000.0)
NOISE_SD = 0.002


def make_scene(seed=0, n=144):
    rng = np.random.default_rng(seed)
    g = int(np.sqrt(n))
    e = np.linspace(-15e3, 15e3, g)
    coords = np.stack(np.meshgrid(e, e), axis=-1).reshape(-1, 2)
    src = RectangularSource(**TRUE, **FIXED)
    disp = np.asarray(src.surface_displacement(jnp.asarray(coords)))
    los = np.tile(np.array([-0.6, 0.1, 0.79]), (coords.shape[0], 1))
    los /= np.linalg.norm(los, axis=1, keepdims=True)
    obs = (disp * los).sum(axis=1) + rng.normal(0, NOISE_SD, coords.shape[0])
    from beat_tpu.heart.geodesy import GeodeticDataset

    return GeodeticDataset(
        name="scene_asc", typ="SAR", coords=coords, displacement=obs,
        los_vector=los,
        covariance=Covariance(data=np.eye(coords.shape[0]) * NOISE_SD**2))


def make_problem(tmp_path, datasets=None, **sampler_kw):
    datasets = datasets or [make_scene()]
    template = RectangularSource(**TRUE, **FIXED)
    # sample only the three TRUE parameters; rest fixed at template values
    # testvalues at the truth so hyper estimation (residuals frozen at the
    # test point, as in the reference) sees the correct noise level
    priors = PriorSet()
    priors.add(Parameter("east_shift", [-5e3], [5e3], testvalue=[TRUE["east_shift"]]))
    priors.add(Parameter("depth", [500.0], [5e3], testvalue=[TRUE["depth"]]))
    priors.add(Parameter("slip", [0.1], [3.0], testvalue=[TRUE["slip"]]))
    comp = GeodeticGeometryComposite(datasets, [template])
    return Problem(priors, {"geodetic": comp}, outfolder=str(tmp_path / "out"),
                   sampler_params=SMCParams(n_chains=96, n_steps=40, seed=5, **sampler_kw))


class TestGeodeticInversion:
    def test_forward_at_truth_is_best(self, tmp_path):
        problem = make_problem(tmp_path)
        logp_fn, data = problem.make_logp_fn()
        logp = lambda q: logp_fn(q, data)
        q_true = problem.point_to_array(
            {"east_shift": TRUE["east_shift"], "depth": TRUE["depth"], "slip": TRUE["slip"]})
        l_true = float(logp(jnp.asarray(q_true)))
        q_off = problem.point_to_array(
            {"east_shift": TRUE["east_shift"] + 2e3, "depth": TRUE["depth"] + 1e3,
             "slip": TRUE["slip"] + 0.5})
        l_off = float(logp(jnp.asarray(q_off)))
        assert l_true > l_off

    def test_smc_recovery(self, tmp_path):
        problem = make_problem(tmp_path)
        q_tr, llk_tr = problem.sample()
        post = q_tr[-1]  # (chains, dim)
        mean = post.mean(axis=0)
        order = problem.ordering
        est = order.to_point(mean)
        assert abs(est["east_shift"] - TRUE["east_shift"]) < 300.0
        assert abs(est["depth"] - TRUE["depth"]) < 500.0
        assert abs(est["slip"] - TRUE["slip"]) < 0.25

    def test_synthetics_and_vr(self, tmp_path):
        problem = make_problem(tmp_path)
        point = {"east_shift": TRUE["east_shift"], "depth": TRUE["depth"],
                 "slip": TRUE["slip"]}
        synths = problem.get_synthetics(point)
        assert "geodetic" in synths and "scene_asc" in synths["geodetic"]
        vr = problem.get_variance_reductions(point)["geodetic"]["scene_asc"]
        assert vr > 0.9  # truth explains almost everything


class TestHyperEstimation:
    def test_hyper_logp_matches_direct(self, tmp_path):
        """The precomputed hyper-only posterior (hyper_normal on frozen
        ||W r||²) equals the direct hyper_loglike evaluation."""
        problem = make_problem(tmp_path)
        fixed = problem.priors.test_point()
        logp_fn, data = problem.make_hyper_logp_fn(fixed)
        rng = np.random.default_rng(2)
        lower, upper = problem.priors.bounds_arrays()
        q = jnp.asarray(rng.uniform(lower, upper), dtype=jnp.float32)
        got = float(logp_fn(q, data))
        point = problem.ordering.to_point(q)
        fixed_j = {k: jnp.asarray(v) for k, v in fixed.items()}
        comp = problem.composites["geodetic"]
        want = float(comp.hyper_loglike(point, fixed_j))
        np.testing.assert_allclose(got, want, rtol=1e-5)

    def test_hyper_bounds_rewritten(self, tmp_path):
        problem = make_problem(tmp_path)
        # add explicit deviation: noise hyper exists in space
        assert "h_SAR" in problem.priors.names
        bounds = problem.estimate_hypers(n_steps=400, n_chains=8)
        lo, hi = bounds["h_SAR"]
        # correct noise scaling is h=0 (covariance == truth); bounds must
        # bracket it tightly compared to the default [-2, 6]
        assert lo[0] <= 0.5 and hi[0] >= -0.5
        assert hi[0] - lo[0] < 8.0


class TestCorrections:
    def test_ramp_parameters_enter_space(self, tmp_path):
        from beat_tpu.heart.corrections import RampCorrection

        ds = make_scene()
        comp = GeodeticGeometryComposite(
            [ds], [RectangularSource(**TRUE, **FIXED)],
            corrections=[RampCorrection(dataset_name="scene_asc")])
        priors = PriorSet().add(Parameter("slip", [0.1], [3.0]))
        problem = Problem(priors, {"geodetic": comp}, outfolder=str(tmp_path / "o"))
        for name in ("scene_asc_azimuth_ramp", "scene_asc_range_ramp", "scene_asc_offset"):
            assert name in problem.priors.names
        logp_fn, data = problem.make_logp_fn()
        logp = lambda q: logp_fn(q, data)
        q = problem.priors.test_array()
        assert np.isfinite(float(logp(jnp.asarray(q))))

    def test_diagnostics_subtract_corrections(self, tmp_path):
        """VR / standardized residuals / update_weights use the same
        corrected residual as loglike: data = synth + ramp with the ramp
        parameters in the point must give VR ≈ 1 (previously the ramp
        stayed in the diagnostic residual)."""
        from beat_tpu.heart.corrections import (RampCorrection,
                                                get_ramp_displacement)

        ds = make_scene(seed=9)
        src = RectangularSource(**TRUE, **FIXED)
        synth_los = np.asarray(
            (src.surface_displacement(jnp.asarray(ds.coords))
             * ds.los_vector).sum(axis=1))
        az, rg, off = 2e-6, -1e-6, 0.004
        ramp = np.asarray(get_ramp_displacement(
            ds.coords[:, 0], ds.coords[:, 1], az, rg, off))
        ds.displacement = synth_los + ramp
        comp = GeodeticGeometryComposite(
            [ds], [src], corrections=[RampCorrection(dataset_name=ds.name)])
        point = {"scene_asc_azimuth_ramp": az, "scene_asc_range_ramp": rg,
                 "scene_asc_offset": off}
        vr = comp.get_variance_reductions(point)
        assert vr[ds.name] > 0.999, vr
        std = comp.get_standardized_residuals(point)
        # ramp left in the residual would standardize to O(10); the
        # corrected residual is float32 round-off
        assert np.abs(std[ds.name]).max() < 0.1


class TestMogi:
    def test_peak_uplift_and_ratio(self):
        from beat_tpu.heart.okada import mogi_surface_displacement

        d, dv, nu = 3e3, 2e6, 0.25
        coords = jnp.asarray([[0.0, 0.0], [3e3, 0.0]])
        disp = np.asarray(mogi_surface_displacement(
            coords, depth=d, volume_change=dv, nu=nu))
        # peak uplift (1-nu) dV / (pi d^2)
        np.testing.assert_allclose(disp[0, 2], (1 - nu) * dv / (np.pi * d**2),
                                   rtol=1e-6)
        # at r = d: u_r / u_z = r / d = 1
        np.testing.assert_allclose(disp[1, 0], disp[1, 2], rtol=1e-6)
        assert disp[0, 0] == 0.0 and disp[0, 1] == 0.0

    def test_volcano_inversion(self, tmp_path):
        """Fernandina-style: recover depth + volume change of an inflating
        point source from an InSAR scene."""
        from beat_tpu.sources import ExplosionSource

        rng = np.random.default_rng(3)
        g = 12
        e = np.linspace(-8e3, 8e3, g)
        coords = np.stack(np.meshgrid(e, e), -1).reshape(-1, 2)
        los = np.tile([-0.38, 0.08, 0.92], (coords.shape[0], 1))
        los /= np.linalg.norm(los, axis=1, keepdims=True)
        from beat_tpu.heart.okada import mogi_surface_displacement

        true_d, true_dv = 2.5e3, 3e6
        disp = np.asarray(mogi_surface_displacement(
            jnp.asarray(coords), depth=true_d, volume_change=true_dv))
        obs = (disp * los).sum(1)
        sd = 0.01 * np.abs(obs).max()
        from beat_tpu.heart.geodesy import GeodeticDataset

        ds = GeodeticDataset(
            name="volcano", typ="SAR", coords=coords,
            displacement=obs + rng.normal(0, sd, obs.shape), los_vector=los,
            covariance=Covariance(data=np.eye(obs.size) * sd**2))
        comp = GeodeticGeometryComposite([ds], [ExplosionSource()])
        priors = (PriorSet()
                  .add(Parameter("depth", [1e3], [6e3], testvalue=[true_d]))
                  .add(Parameter("volume_change", [1e5], [1e7],
                                 testvalue=[true_dv])))
        problem = Problem(priors, {"geodetic": comp},
                          outfolder=str(tmp_path / "volcano"),
                          sampler_params=SMCParams(n_chains=64, n_steps=40, seed=6))
        q_tr, _ = problem.sample()
        est = problem.ordering.to_point(q_tr[-1].mean(axis=0))
        assert abs(est["depth"] - true_d) / true_d < 0.1
        assert abs(est["volume_change"] - true_dv) / true_dv < 0.15


def test_dataset_stack_slices():
    ds1 = make_scene(n=16)
    g = gnss_compound("gnss_e", np.zeros((5, 2)), np.zeros(5), "east")
    stack = DatasetStack.from_datasets([ds1, g])
    assert stack.samples == ds1.samples + 5
    assert stack.slices[1] == slice(ds1.samples, ds1.samples + 5)
    assert stack.los.shape == (stack.samples, 3)


class TestGeodeticPredCovariance:
    """Earth-model uncertainty -> Covariance.pred_v at update_weights
    (reference geodetic_cov_velocity_models covariance.py:625)."""

    def test_nu_ensemble_sets_pred_v(self):
        ds = make_scene()
        template = RectangularSource(**TRUE, **FIXED)
        comp = GeodeticGeometryComposite(
            [ds], [template], ensemble_nus=(0.2, 0.25, 0.3))
        point = {k: TRUE[k] for k in ("east_shift", "depth", "slip")}
        w_before = np.asarray(comp._device["weights"][0])
        comp.update_weights(point)
        pv = ds.covariance.pred_v
        assert pv is not None and pv.shape == (ds.coords.shape[0],) * 2
        assert np.diag(pv).max() > 0
        assert comp.nu == 0.25  # restored
        assert not np.allclose(np.asarray(comp._device["weights"][0]),
                               w_before)

    def test_no_ensemble_is_noop(self):
        ds = make_scene()
        comp = GeodeticGeometryComposite(
            [ds], [RectangularSource(**TRUE, **FIXED)])
        point = {k: TRUE[k] for k in ("east_shift", "depth", "slip")}
        comp.update_weights(point)   # import structure + no ensembles
        assert ds.covariance.pred_v is None


class TestEulerPoleStationMasks:
    """Per-dataset Euler-pole/strain instances with station
    white/blacklists (reference EulerPoleConfig.station_blacklist
    config.py:828-834, get_station_indexes models/corrections.py:111)."""

    def _gnss_pair(self):
        rng = np.random.default_rng(0)
        n = 6
        lats = 34.0 + rng.uniform(-1, 1, n)
        lons = -118.0 + rng.uniform(-1, 1, n)
        coords = np.stack([(lons + 118.0), (lats - 34.0)], axis=-1) * 111e3
        stations = np.array([f"G{i}" for i in range(n)])
        out = []
        for comp in ("east", "north"):
            ds = gnss_compound(f"gnss_{comp}", coords, rng.normal(0, 1e-3, n),
                               comp)
            ds.lats, ds.lons, ds.stations = lats, lons, stations
            out.append(ds)
        return out

    def test_per_dataset_instances_and_blacklist(self):
        from beat_tpu.config import (EulerPoleConfig,
                                     GeodeticCorrectionsConfig,
                                     GeodeticConfig, _build_corrections)
        from beat_tpu.heart.corrections import EulerPoleCorrection

        datasets = self._gnss_pair()
        gc = GeodeticConfig(corrections=GeodeticCorrectionsConfig(
            ramps=None,
            euler_poles=[EulerPoleConfig(station_blacklist=["G2", "G4"])]))
        corrections = _build_corrections(gc, datasets)
        assert len(corrections) == 2          # one instance per GNSS dataset
        for corr, ds in zip(corrections, datasets):
            assert isinstance(corr, EulerPoleCorrection)
            assert corr.dataset_name == ds.name
            assert corr.lats.size == ds.samples
            np.testing.assert_array_equal(corr.mask,
                                          [1, 1, 0, 1, 0, 1])
        # shared hierarchicals registered once
        comp = GeodeticGeometryComposite(datasets, [RectangularSource(
            **TRUE, **FIXED)], corrections=corrections)
        names = comp.get_hierarchical_names()
        assert names == ["0_pole_lat", "0_pole_lon", "0_omega"]
        # blacklisted stations get zero correction displacement
        import jax.numpy as jnp

        point = {"0_pole_lat": jnp.asarray(50.0),
                 "0_pole_lon": jnp.asarray(-100.0),
                 "0_omega": jnp.asarray(0.2)}
        disp = np.asarray(corrections[0].displacement(
            point, jnp.asarray(datasets[0].los_vector)))
        assert disp[2] == 0.0 and disp[4] == 0.0
        assert np.abs(disp[[0, 1, 3, 5]]).min() > 0

    def test_station_fields_roundtrip_npz(self, tmp_path):
        from beat_tpu.config import (GeodeticConfig, load_geodetic_datasets,
                                     save_geodetic_datasets)

        datasets = self._gnss_pair()
        save_geodetic_datasets(datasets, str(tmp_path))
        loaded = load_geodetic_datasets(str(tmp_path), GeodeticConfig())
        by_name = {ds.name: ds for ds in loaded}
        for ds in datasets:
            got = by_name[ds.name]
            np.testing.assert_allclose(got.lats, ds.lats)
            np.testing.assert_allclose(got.lons, ds.lons)
            assert list(got.stations) == list(ds.stations)


class TestDatasetTypeSelection:
    """geodetic_config.types / names select which datasets enter the
    problem (reference GeodeticConfig.types config.py:971)."""

    def test_types_and_names_filter(self, tmp_path):
        from beat_tpu.config import (GeodeticConfig, load_geodetic_datasets,
                                     save_geodetic_datasets)

        sar = make_scene()
        g = gnss_compound("gnss_east", np.zeros((4, 2)),
                          np.full(4, 1e-3), "east")
        save_geodetic_datasets([sar, g], str(tmp_path))
        both = load_geodetic_datasets(str(tmp_path), GeodeticConfig())
        assert {ds.typ for ds in both} == {"SAR", "GNSS"}
        only_sar = load_geodetic_datasets(
            str(tmp_path), GeodeticConfig(types=["SAR"]))
        assert [ds.typ for ds in only_sar] == ["SAR"]
        named = load_geodetic_datasets(
            str(tmp_path), GeodeticConfig(names=["gnss_east"]))
        assert [ds.name for ds in named] == ["gnss_east"]
        with pytest.raises(ValueError, match="matches none"):
            load_geodetic_datasets(str(tmp_path),
                                   GeodeticConfig(types=["nope"]))

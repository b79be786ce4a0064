"""
Seismic forward-model and inversion tests.

Strategy mirrors the reference: unit checks on tapers/filters/STF
spectra and radiation symmetry, then an end-to-end FullMT-style
moment-tensor recovery on synthetic waveforms (reference
``docs/examples/FullMT_regional.rst`` at toy scale).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from beat_tpu.covariance import Covariance
from beat_tpu.heart.gftable import (
    GreensTable,
    build_homogeneous_table,
    component_index,
    rotate_m6_to_ray_frame,
)
from beat_tpu.heart.seismic import SeismicDataset, WaveformMapping
from beat_tpu.heart.taper import ArrivalTaper, Filter, stf_spectrum
from beat_tpu.models.seismic import SeismicGeometryComposite, source_m6
from beat_tpu.models.problem import Problem
from beat_tpu.parameter import Parameter, PriorSet
from beat_tpu.samplers import SMCParams
from beat_tpu.sources import DCSource, MTSource, sdr_to_m6


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------


class TestTaper:
    def test_window_shape_and_plateau(self):
        taper = ArrivalTaper(a=-2.0, b=-1.0, c=5.0, d=6.0)
        w = taper.window(0.5)
        assert w.size == taper.nsamples(0.5) == 16
        # plateau at 1 between b and c
        t = taper.a + np.arange(w.size) * 0.5
        plateau = (t >= taper.b) & (t <= taper.c)
        np.testing.assert_allclose(w[plateau], 1.0)
        assert w[0] < 0.1  # ramped up from ~0


class TestSTFSpectrum:
    @pytest.mark.parametrize("stf_type", ["Boxcar", "Triangular", "HalfSinusoid"])
    def test_matches_fft_of_sampled_stf(self, stf_type):
        from beat_tpu.sources import stf_catalog

        dt, n = 0.05, 512
        duration = 3.0
        t = np.arange(n) * dt
        sampled = np.asarray(stf_catalog[stf_type](jnp.asarray(t), duration)) * dt
        want = np.fft.rfft(sampled)
        freqs = jnp.asarray(np.fft.rfftfreq(n, dt))
        got = np.asarray(stf_spectrum(freqs, duration, stf_type))
        # compare over the usable band (discretisation differences at high f)
        band = np.fft.rfftfreq(n, dt) < 2.0
        np.testing.assert_allclose(got[band], want[band], atol=0.02)

    def test_zero_frequency_unit_area(self):
        for stf_type in ("Boxcar", "Triangular", "HalfSinusoid"):
            s0 = complex(stf_spectrum(jnp.asarray([0.0]), 2.5, stf_type)[0])
            np.testing.assert_allclose(s0, 1.0, atol=1e-5)


class TestRotation:
    def test_zero_azimuth_identity(self):
        m6 = jnp.asarray([1.0, -0.5, 0.2, 0.3, -0.1, 0.7])
        out = rotate_m6_to_ray_frame(m6, jnp.asarray(0.0))
        np.testing.assert_allclose(np.asarray(out), np.asarray(m6), atol=1e-7)

    def test_isotropic_invariant(self):
        m6 = jnp.asarray([1.0, 1.0, 1.0, 0.0, 0.0, 0.0])
        out = rotate_m6_to_ray_frame(m6, jnp.asarray(1.1))
        np.testing.assert_allclose(np.asarray(out), np.asarray(m6), atol=1e-6)

    def test_trace_invariant(self):
        m6 = jnp.asarray([0.3, -0.8, 0.5, 0.2, 0.9, -0.4])
        out = rotate_m6_to_ray_frame(m6, jnp.asarray(0.7))
        np.testing.assert_allclose(float(out[0] + out[1] + out[2]),
                                   float(m6[0] + m6[1] + m6[2]), atol=1e-6)


# ---------------------------------------------------------------------------
# table physics
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def table():
    return build_homogeneous_table(
        distances=np.linspace(20e3, 120e3, 11),
        depths=np.linspace(2e3, 20e3, 5),
        nt=256, dt=0.25)


class TestHomogeneousTable:
    def test_explosion_has_no_transverse(self, table):
        """Isotropic source: no T (SH) motion in a 1-D medium."""
        iso = np.array([1.0, 1.0, 1.0, 0.0, 0.0, 0.0])
        spec_t = np.einsum("k,kfr->fr", iso,
                           np.asarray(table.spectra[:, 2, 5, 2]))
        spec_z = np.einsum("k,kfr->fr", iso,
                           np.asarray(table.spectra[:, 0, 5, 2]))
        assert np.abs(spec_t).max() < 1e-6 * np.abs(spec_z).max()

    def test_p_arrival_time(self, table):
        """Z-component energy onset at r/vp."""
        iso = jnp.asarray([1e15, 1e15, 1e15, 0.0, 0.0, 0.0])
        spec = table.synthesize_spectra(
            iso, 0.0, 0.0, jnp.asarray(10e3), 0.0, 0.5,
            jnp.asarray([60e3]), jnp.asarray([0.0]),
            jnp.asarray([0], dtype=jnp.int32))
        trace = np.asarray(table.to_time_domain(spec))[0]
        r = np.sqrt(60e3**2 + 10e3**2)
        tp = r / table.vp
        i_onset = np.argmax(np.abs(trace) > 0.05 * np.abs(trace).max())
        assert abs(i_onset * table.dt - tp) < 1.5  # within STF width

    def test_moment_scaling_linear(self, table):
        m6a = jnp.asarray(sdr_to_m6(30.0, 60.0, 90.0, 1e16))
        m6b = 3.0 * m6a
        kw = dict(east_shift=0.0, north_shift=0.0, depth=jnp.asarray(8e3),
                  time_shift=0.0, duration=1.0,
                  station_east=jnp.asarray([40e3, -70e3]),
                  station_north=jnp.asarray([30e3, 10e3]),
                  comp_idx=jnp.asarray([0, 1], dtype=jnp.int32))
        sa = np.asarray(table.synthesize_spectra(m6a, **kw))
        sb = np.asarray(table.synthesize_spectra(m6b, **kw))
        np.testing.assert_allclose(sb, 3.0 * sa, rtol=1e-5)


# ---------------------------------------------------------------------------
# end-to-end FullMT-style inversion
# ---------------------------------------------------------------------------

TRUE_SDR = dict(strike=40.0, dip=55.0, rake=20.0)
TRUE_MAG = 5.8
TRUE_DEPTH = 9e3
NOISE_REL = 0.02


def make_wavemap(table, seed=0, **wmap_kwargs):
    """Synthetic observed waveforms from the true DC source + noise."""
    rng = np.random.default_rng(seed)
    n_st = 8
    az = np.linspace(0, 2 * np.pi, n_st, endpoint=False) + 0.2
    dist = rng.uniform(40e3, 100e3, n_st)
    st_e = dist * np.sin(az)
    st_n = dist * np.cos(az)

    m6_true = jnp.asarray(sdr_to_m6(TRUE_SDR["strike"], TRUE_SDR["dip"],
                                    TRUE_SDR["rake"],
                                    10 ** (1.5 * TRUE_MAG + 9.05)))
    # full (unfiltered) traces on the table grid
    spec = table.synthesize_spectra(
        m6_true, 0.0, 0.0, jnp.asarray(TRUE_DEPTH), 0.0, 1.5,
        jnp.asarray(st_e), jnp.asarray(st_n),
        jnp.asarray([0] * n_st, dtype=jnp.int32))
    raw = np.asarray(table.to_time_domain(spec))
    scale = np.abs(raw).max()
    raw = raw + rng.normal(0, NOISE_REL * scale, raw.shape)

    datasets = [
        SeismicDataset(station=f"ST{i:02d}", channel="Z", east=st_e[i],
                       north=st_n[i], ydata=raw[i])
        for i in range(n_st)
    ]
    return WaveformMapping(
        name="any_P", datasets=datasets, table=table,
        taper=ArrivalTaper(a=-3.0, b=-1.5, c=15.0, d=18.0),
        filterer=Filter(lower_corner=0.02, upper_corner=0.5, order=3),
        **wmap_kwargs)


@pytest.fixture(scope="module")
def wavemap(table):
    return make_wavemap(table)


class TestSeismicComposite:
    def test_truth_beats_perturbed(self, wavemap):
        comp = SeismicGeometryComposite(
            [wavemap], [DCSource(depth=TRUE_DEPTH, **TRUE_SDR, magnitude=TRUE_MAG)])
        point_true = {"strike": jnp.asarray(TRUE_SDR["strike"]),
                      "dip": jnp.asarray(TRUE_SDR["dip"]),
                      "rake": jnp.asarray(TRUE_SDR["rake"]),
                      "magnitude": jnp.asarray(TRUE_MAG),
                      "depth": jnp.asarray(TRUE_DEPTH)}
        l_true = float(comp.loglike(point_true))
        point_off = dict(point_true)
        point_off["strike"] = jnp.asarray(TRUE_SDR["strike"] + 30.0)
        assert l_true > float(comp.loglike(point_off))

    def test_variance_reduction_at_truth(self, wavemap):
        comp = SeismicGeometryComposite(
            [wavemap], [DCSource(depth=TRUE_DEPTH, **TRUE_SDR, magnitude=TRUE_MAG)])
        vr = comp.get_variance_reductions(
            {"strike": TRUE_SDR["strike"], "dip": TRUE_SDR["dip"],
             "rake": TRUE_SDR["rake"], "magnitude": TRUE_MAG,
             "depth": TRUE_DEPTH, "duration": 1.5})
        assert vr["any_P_0"] > 0.9

    def test_smc_recovers_mechanism(self, wavemap, tmp_path):
        comp = SeismicGeometryComposite(
            [wavemap], [DCSource(depth=TRUE_DEPTH, magnitude=TRUE_MAG,
                                 duration=1.5)])
        priors = PriorSet()
        priors.add(Parameter("strike", [0.0], [90.0]))
        priors.add(Parameter("dip", [30.0], [80.0]))
        priors.add(Parameter("rake", [-40.0], [60.0]))
        priors.add(Parameter("magnitude", [5.0], [6.5]))
        problem = Problem(priors, {"seismic": comp}, outfolder=str(tmp_path / "mt"),
                          sampler_params=SMCParams(n_chains=80, n_steps=40, seed=4))
        q_tr, _ = problem.sample()
        est = problem.ordering.to_point(q_tr[-1].mean(axis=0))
        assert abs(est["strike"] - TRUE_SDR["strike"]) < 10.0
        assert abs(est["dip"] - TRUE_SDR["dip"]) < 10.0
        assert abs(est["rake"] - TRUE_SDR["rake"]) < 15.0
        assert abs(est["magnitude"] - TRUE_MAG) < 0.1


class TestSpectrumDomain:
    def test_spectrum_fit_insensitive_to_time_shift(self, table):
        """Amplitude-spectrum fits ignore pure time shifts (the point of
        domain='spectrum'); time-domain fits do not."""
        wm_t = make_wavemap(table, seed=3)
        wm_s = make_wavemap(table, seed=3)
        wm_s.domain = "spectrum"
        wm_s._process_observed()

        assert wm_s.nsamples_fit == wm_s.nsamples_win // 2 + 1
        assert wm_s.data_fit.shape == (wm_s.ntargets, wm_s.nsamples_fit)

        src = DCSource(depth=TRUE_DEPTH, **TRUE_SDR, magnitude=TRUE_MAG,
                       duration=1.5)
        comp_t = SeismicGeometryComposite([wm_t], [src])
        comp_s = SeismicGeometryComposite([wm_s], [src])
        base = {"strike": jnp.asarray(TRUE_SDR["strike"]),
                "dip": jnp.asarray(TRUE_SDR["dip"]),
                "rake": jnp.asarray(TRUE_SDR["rake"]),
                "magnitude": jnp.asarray(TRUE_MAG),
                "time": jnp.asarray(0.0)}
        shifted = dict(base, time=jnp.asarray(1.2))
        drop_t = float(comp_t.loglike(base)) - float(comp_t.loglike(shifted))
        drop_s = float(comp_s.loglike(base)) - float(comp_s.loglike(shifted))
        assert drop_t > 10.0 * max(abs(drop_s), 1e-3)


class TestSourceM6:
    def test_mt_source_m6_norm(self):
        src = MTSource(magnitude=6.0)
        point = {"mnn": jnp.asarray(1.0), "mee": jnp.asarray(-0.3),
                 "mdd": jnp.asarray(0.1), "mne": jnp.asarray(0.5),
                 "mnd": jnp.asarray(0.0), "med": jnp.asarray(0.0),
                 "magnitude": jnp.asarray(6.0)}
        m6 = np.asarray(source_m6(src, point, 0, 1))
        # scalar moment of normalized MT = M0(6.0)
        m0 = np.sqrt((m6[:3] ** 2).sum() + 2 * (m6[3:] ** 2).sum()) / np.sqrt(2)
        np.testing.assert_allclose(m0, 10 ** (1.5 * 6.0 + 9.05), rtol=1e-4)


def test_quantity_velocity_is_time_derivative():
    """quantity='velocity' synthetics equal the time derivative of the
    displacement synthetics (iω folded into the response)."""
    import jax.numpy as jnp

    from beat_tpu.heart.gftable import build_homogeneous_table
    from beat_tpu.heart.seismic import SeismicDataset, WaveformMapping
    from beat_tpu.heart.taper import ArrivalTaper, Filter
    from beat_tpu.models.seismic import SeismicGeometryComposite
    from beat_tpu.sources import DCSource

    table = build_homogeneous_table(np.linspace(20e3, 60e3, 4),
                                    np.linspace(2e3, 10e3, 3), nt=256, dt=0.25)
    rng = np.random.default_rng(7)

    def make(quantity):
        datasets = [SeismicDataset(station=f"S{i}", channel="Z",
                                   east=float(3e4 * np.sin(i + 0.4)),
                                   north=float(3e4 * np.cos(i + 0.4)),
                                   ydata=rng.normal(0, 1e-8, 256))
                    for i in range(3)]
        # keep the band low: the central-difference reference has a
        # sin(ωΔt)/(ωΔt) rolloff (~4 % at 0.3 Hz for Δt=0.25 s)
        wmap = WaveformMapping(name="any_P", datasets=datasets, table=table,
                               taper=ArrivalTaper(-2, -1, 10, 12),
                               filterer=Filter(0.05, 0.3, 3),
                               quantity=quantity)
        comp = SeismicGeometryComposite(
            [wmap], [DCSource(depth=6e3, strike=30.0, dip=60.0, rake=20.0,
                              magnitude=5.5, duration=1.0)])
        return np.asarray(comp.synthetics_windows(
            {"duration": jnp.asarray(1.0)}, 0))

    disp = make("displacement")
    vel = make("velocity")
    # central-difference derivative of the displacement windows
    dt = table.dt
    ddt = np.gradient(disp, dt, axis=1)
    scale = np.abs(vel).max()
    # interior samples (gradient endpoints are one-sided)
    err = np.abs(vel[:, 2:-2] - ddt[:, 2:-2]).max() / scale
    assert err < 0.08, f"velocity vs d/dt displacement mismatch {err:.3f}"
    assert np.abs(vel).max() > 0

    with pytest.raises(ValueError, match="Unknown quantity"):
        make("jerk")


class TestMMGather:
    def test_onehot_matmul_gather_equals_reference(self):
        """The one kept gather path (the plain 4-corner gather; the
        one-hot-matmul and flat-row variants were measured slower on
        the GPU and removed) equals the numpy float64 bilinear reference
        with and without the fused channel selection, and an on-grid
        query returns the exact table row."""
        from beat_tpu.heart.gftable import (build_homogeneous_table,
                                            gather_spectra_numpy)

        table = build_homogeneous_table(
            distances=np.linspace(20e3, 120e3, 11),
            depths=np.linspace(2e3, 20e3, 5), nt=128, dt=0.5)
        rng = np.random.default_rng(3)
        dist = rng.uniform(25e3, 110e3, 8).astype(np.float32)
        depth = np.float32(7.3e3)
        cidx = rng.integers(0, 3, 8)

        got = np.asarray(table.gather_spectra(
            jnp.asarray(dist), jnp.float32(depth),
            jnp.asarray(cidx, dtype=jnp.int32)))
        ref = gather_spectra_numpy(table, dist, depth, cidx)
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got / scale, ref / scale, atol=2e-6)
        got3 = np.asarray(table.gather_spectra(jnp.asarray(dist),
                                               jnp.float32(depth)))
        ref3 = gather_spectra_numpy(table, dist, depth)
        np.testing.assert_allclose(got3 / scale, ref3 / scale, atol=2e-6)

        # on-grid point: exact table row
        exact = np.asarray(table.gather_spectra(
            jnp.asarray([float(table.distances[4])]), jnp.float32(table.depths[2]),
            jnp.asarray([1], dtype=jnp.int32)))
        np.testing.assert_allclose(
            exact[0], np.asarray(table.spectra)[:, 1, 4, 2], rtol=2e-6)


class TestMultiEvent:
    """Multi-event (subevents) problems: each wavemap synthesizes only
    its own event's source, offset by that event's location/time
    relative to the main origin (reference ``config.py:1939`` subevents,
    ``models/seismic.py:798-813``, ``pytensorf.py:274-278``)."""

    def test_wavemap_uses_only_its_event_source(self, table):
        de, dn, dtim = 12e3, -8e3, 3.0
        wm0 = make_wavemap(table, seed=11)
        wm1 = make_wavemap(table, seed=12, event_idx=1,
                           event_offset=(de, dn, dtim))
        srcs = [DCSource(depth=8e3, magnitude=5.5, duration=1.5),
                DCSource(depth=11e3, magnitude=5.2, duration=1.0)]
        comp = SeismicGeometryComposite([wm0, wm1], srcs, n_events=2)
        point = {"strike": jnp.asarray([40.0, 120.0]),
                 "dip": jnp.asarray([55.0, 70.0]),
                 "rake": jnp.asarray([20.0, -90.0]),
                 "magnitude": jnp.asarray([5.5, 5.2]),
                 "depth": jnp.asarray([8e3, 11e3]),
                 "east_shift": jnp.asarray([0.0, 0.0]),
                 "north_shift": jnp.asarray([0.0, 0.0]),
                 "time": jnp.asarray([0.0, 0.0]),
                 "duration": jnp.asarray([1.5, 1.0])}

        # wavemap 0 (main event) == single-source composite of source 0
        w0 = np.asarray(comp.synthetics_windows(point, 0))
        comp0 = SeismicGeometryComposite([wm0], [srcs[0]])
        p0 = {k: v[0] for k, v in point.items()}
        ref0 = np.asarray(comp0.synthetics_windows(p0, 0))
        np.testing.assert_allclose(w0, ref0, rtol=1e-5,
                                   atol=1e-6 * np.abs(ref0).max())

        # wavemap 1 (subevent) == single-source composite of source 1
        # with the point manually shifted by the event offset
        w1 = np.asarray(comp.synthetics_windows(point, 1))
        comp1 = SeismicGeometryComposite([wm1], [srcs[1]])
        p1 = {k: v[1] for k, v in point.items()}
        p1["east_shift"] = p1["east_shift"] + de
        p1["north_shift"] = p1["north_shift"] + dn
        p1["time"] = p1["time"] + dtim
        ref1 = np.asarray(comp1.synthetics_windows(p1, 0))
        np.testing.assert_allclose(w1, ref1, rtol=1e-5,
                                   atol=1e-6 * np.abs(ref1).max())
        # the offset actually matters: dropping it changes the windows
        p1_raw = {k: v[1] for k, v in point.items()}
        assert not np.allclose(
            w1, np.asarray(comp1.synthetics_windows(p1_raw, 0)),
            atol=1e-3 * np.abs(ref1).max())

    def test_validation(self, table):
        wm = make_wavemap(table, seed=13, event_idx=2)
        with pytest.raises(ValueError, match="event_idx"):
            SeismicGeometryComposite(
                [wm], [DCSource(), DCSource()], n_events=2)
        with pytest.raises(ValueError, match="one source per event"):
            SeismicGeometryComposite(
                [make_wavemap(table, seed=14)], [DCSource()], n_events=2)

    def test_subevent_windows_follow_offset_arrivals(self, table):
        """prepare() windows a subevent wavemap around its own event:
        arrivals shift by the event time offset and the distance is
        measured from the offset epicenter."""
        wm_main = make_wavemap(table, seed=15)
        dtim = 5.0
        wm_sub = make_wavemap(table, seed=15, event_idx=1,
                              event_offset=(0.0, 0.0, dtim))
        np.testing.assert_allclose(wm_sub.arrival_times,
                                   wm_main.arrival_times + dtim)


class TestPreprocessData:
    def test_prefiltered_data_with_flag_off_matches_raw_with_flag_on(self, table):
        """preprocess_data=False skips filtering the observed traces
        (reference ``WaveformFitConfig.preprocess_data`` config.py:547):
        feeding already-filtered data with the flag off must equal
        feeding raw data with the flag on."""
        wm_on = make_wavemap(table, seed=21)

        # pre-filter the raw traces with the wavemap's own response
        wm_off = make_wavemap(table, seed=21, preprocess_data=False)
        resp = wm_on.filter_response_obs
        for ds in wm_off.datasets:
            spec = np.fft.rfft(ds.ydata, n=table.nt)
            ds.ydata = np.fft.irfft(spec * resp, n=table.nt)
        wm_off.prepare()

        np.testing.assert_allclose(wm_off.data_windows, wm_on.data_windows,
                                   rtol=1e-5,
                                   atol=1e-6 * np.abs(wm_on.data_windows).max())
        # and with the flag ON the pre-filtered data differs (double filter)
        wm_double = make_wavemap(table, seed=21)
        for ds in wm_double.datasets:
            spec = np.fft.rfft(ds.ydata, n=table.nt)
            ds.ydata = np.fft.irfft(spec * resp, n=table.nt)
        wm_double.prepare()
        assert not np.allclose(wm_double.data_windows, wm_on.data_windows,
                               atol=1e-3 * np.abs(wm_on.data_windows).max())


class TestVelocityModelPredCovariance:
    """Ensemble GF tables -> Covariance.pred_v at update_weights
    (reference seismic_cov_velocity_models covariance.py:561 consuming
    heart.ensemble_earthmodel crust variations)."""

    def _ensemble(self, table, factors=(0.97, 1.0, 1.03)):
        return [build_homogeneous_table(
            distances=np.asarray(table.distances),
            depths=np.asarray(table.depths), nt=table.nt, dt=table.dt,
            vp=table.vp * f, vs=table.vs * f, rho=table.rho)
            for f in factors]

    def test_update_weights_sets_pred_v(self, table):
        wmap = make_wavemap(table, seed=3)
        comp = SeismicGeometryComposite(
            [wmap], [DCSource(depth=TRUE_DEPTH, **TRUE_SDR,
                              magnitude=TRUE_MAG, duration=1.5)],
            ensemble_tables=self._ensemble(table))
        point = {"strike": TRUE_SDR["strike"], "dip": TRUE_SDR["dip"],
                 "rake": TRUE_SDR["rake"], "magnitude": TRUE_MAG,
                 "depth": TRUE_DEPTH}
        w_before = np.asarray(comp._device[0]["weights"])
        llk_before = float(comp.loglike({k: jnp.asarray(v)
                                         for k, v in point.items()}))
        comp.update_weights(point)
        for ds in wmap.datasets:
            pv = ds.covariance.pred_v
            assert pv is not None and pv.shape[0] == pv.shape[1]
            assert np.diag(pv).min() >= 0 and np.diag(pv).max() > 0
            # data part untouched (no non-toeplitz analyser here)
            assert ds.covariance.data is not None
        # composite state restored after the ensemble sweep
        assert wmap.table is table
        assert comp._device[0]["table"] is table
        # widened covariance -> different weights and llk
        w_after = np.asarray(comp._device[0]["weights"])
        assert not np.allclose(w_before, w_after)
        llk_after = float(comp.loglike({k: jnp.asarray(v)
                                        for k, v in point.items()}))
        assert llk_after != llk_before

    def test_faster_models_shift_arrivals_into_pred_v(self, table):
        """The pred_v diagonal must concentrate where the ensemble
        synthetics disagree — i.e. inside the signal window, not in the
        pre-arrival noise."""
        from beat_tpu.covariance import seismic_cov_velocity_models

        wmap = make_wavemap(table, seed=4)
        comp = SeismicGeometryComposite(
            [wmap], [DCSource(depth=TRUE_DEPTH, **TRUE_SDR,
                              magnitude=TRUE_MAG, duration=1.5)],
            ensemble_tables=self._ensemble(table, (0.9, 1.0, 1.1)))
        point = {"strike": TRUE_SDR["strike"], "dip": TRUE_SDR["dip"],
                 "rake": TRUE_SDR["rake"], "magnitude": TRUE_MAG,
                 "depth": TRUE_DEPTH}
        covs = seismic_cov_velocity_models(comp, point,
                                           comp.ensemble_tables, 0)
        assert len(covs) == wmap.ntargets
        d = np.diag(covs[0])
        assert d.max() > 100.0 * max(d.min(), 1e-30)


class TestFilterChain:
    """List-of-filters semantics (reference WaveformFitConfig.filterer
    is a list, config.py:563; responses multiply on the rfft grid)."""

    def test_chain_response_is_product(self):
        from beat_tpu.heart.taper import (BandstopFilter, FilterChain,
                                          FrequencyFilter)

        f1 = Filter(0.02, 0.5, 3)
        f2 = BandstopFilter(0.1, 0.2, 2)
        f3 = FrequencyFilter((0.01, 0.02, 0.3, 0.4))
        chain = FilterChain((f1, f2, f3))
        h = chain.response(256, 0.25)
        want = (f1.response(256, 0.25) * f2.response(256, 0.25)
                * f3.response(256, 0.25))
        np.testing.assert_allclose(h, want, rtol=1e-6)
        # the notch really bites inside the rejected band
        freqs = np.fft.rfftfreq(256, 0.25)
        band = (freqs > 0.14) & (freqs < 0.16)
        assert np.abs(h[band]).max() < 0.2

    def test_config_filterer_list_roundtrip(self, tmp_path):
        from beat_tpu.config import (FilterConfig, build_filterer,
                                     dump_config, init_config, load_config)
        from beat_tpu.heart.taper import FilterChain

        proj = str(tmp_path / "p")
        config = init_config("p", proj, source_types=("MTSource",),
                             n_sources=(1,), datatypes=("seismic",))
        config.seismic_config.waveforms[0].filterer = [
            FilterConfig(0.02, 0.5, 3),
            FilterConfig(0.1, 0.2, 2, type="bandstop"),
            FilterConfig(type="frequency",
                         freqlimits=(0.01, 0.02, 0.3, 0.4)),
        ]
        dump_config(config, proj)
        c2 = load_config(proj)
        fc2 = c2.seismic_config.waveforms[0].filterer
        assert isinstance(fc2, list) and len(fc2) == 3
        assert fc2[1].type == "bandstop"
        built = build_filterer(fc2)
        assert isinstance(built, FilterChain)
        np.testing.assert_allclose(
            built.response(128, 0.5),
            build_filterer(config.seismic_config.waveforms[0].filterer)
            .response(128, 0.5))
        # single spec stays a plain Butterworth (back-compat)
        single = build_filterer(FilterConfig(0.02, 0.5, 3))
        assert isinstance(single, Filter)
        with pytest.raises(ValueError, match="filter type"):
            build_filterer(FilterConfig(type="nope"))


class TestBuildPathWiring:
    def test_stf_type_forwarded(self, tmp_path, table):
        """ProblemConfig.stf_type reaches the geometry composite
        (previously silently replaced by the HalfSinusoid default)."""
        from beat_tpu.config import (dump_config, init_config, load_config,
                                     problem_from_config)
        from beat_tpu.inputf import save_seismic_datasets

        from beat_tpu.config import ArrivalTaperConfig, FilterConfig

        pdir = str(tmp_path / "p")
        config = init_config("p", pdir, source_types=("DCSource",),
                             n_sources=(1,), datatypes=("seismic",))
        config.problem_config.stf_type = "Triangular"
        config.seismic_config.waveforms[0].arrival_taper = \
            ArrivalTaperConfig(a=-3.0, b=-1.5, c=15.0, d=18.0)
        config.seismic_config.waveforms[0].filterer = \
            FilterConfig(0.02, 0.5, 3)
        dump_config(config, pdir)
        datasets = [SeismicDataset(station="S0", channel="Z", east=50e3,
                                   north=0.0, ydata=np.zeros(table.nt))]
        save_seismic_datasets(datasets, pdir)
        table.save(pdir + "/gf_table.npz")
        problem = problem_from_config(load_config(pdir), pdir)
        assert problem.composites["seismic"].stf_type == "Triangular"

    def test_exponential_noise_structure_kept(self, table):
        """analyse_noise with a non-'variance' structure yields a
        window-sized covariance with the configured structure (previously
        a shape mismatch silently degraded it to white noise)."""
        from beat_tpu.covariance import SeismicNoiseAnalyser

        rng = np.random.default_rng(8)
        datasets = [SeismicDataset(station="S0", channel="Z", east=60e3,
                                   north=0.0,
                                   ydata=rng.normal(0, 1e-6, table.nt))]
        wmap = WaveformMapping(
            name="any_P", datasets=datasets, table=table,
            taper=ArrivalTaper(a=-3.0, b=-1.5, c=15.0, d=18.0),
            filterer=Filter(lower_corner=0.02, upper_corner=0.5, order=3))
        wmap.analyse_noise(SeismicNoiseAnalyser(structure="exponential"))
        cov = datasets[0].covariance.data
        assert cov.shape == (wmap.nsamples_win, wmap.nsamples_win)
        # exponential structure: nonzero off-diagonal correlation
        assert cov[0, 1] > 0.1 * cov[0, 0]


def test_patch_grid_anchor_conventions():
    """rectangular_patch_grid honors top/center/bottom anchors: the
    grid's mean depth moves accordingly (previously everything was
    treated as 'top')."""
    from beat_tpu.sources import rectangular_patch_grid

    kw = dict(strike=30.0, dip=60.0, length=8e3, width=4e3,
              east_shift=0.0, north_shift=0.0, depth=6e3,
              n_length=4, n_width=4)
    _, _, d_top, _, down = rectangular_patch_grid(**kw, anchor="top")
    _, _, d_cen, _, _ = rectangular_patch_grid(**kw, anchor="center")
    _, _, d_bot, _, _ = rectangular_patch_grid(**kw, anchor="bottom")
    sd = np.sin(np.deg2rad(60.0))
    np.testing.assert_allclose(np.mean(np.asarray(d_top)),
                               6e3 + sd * 2e3, rtol=1e-6)
    np.testing.assert_allclose(np.mean(np.asarray(d_cen)), 6e3, rtol=1e-6)
    np.testing.assert_allclose(np.mean(np.asarray(d_bot)),
                               6e3 - sd * 2e3, rtol=1e-6)
    # 'down' stays measured from the top edge for rupture-onset math
    np.testing.assert_allclose(np.asarray(down).min(), 4e3 / 8, rtol=1e-6)
    import pytest as _pytest

    with _pytest.raises(ValueError, match="anchor"):
        rectangular_patch_grid(**kw, anchor="nope")


class TestDistanceWeeding:
    """WaveformFitConfig.distances [deg] station weeding (reference
    heart.py:2952) wired through the config build path."""

    def test_distance_range_drops_far_stations(self, tmp_path, table):
        from beat_tpu.config import (ArrivalTaperConfig as _ArrivalTaperConfig,
                                     FilterConfig as _FilterConfig,
                                     SeismicConfig, WaveformFitConfig)
        from beat_tpu.inputf import save_seismic_datasets
        from beat_tpu.models.seismic import build_seismic_composite

        pdir = str(tmp_path)
        deg2m = 111194.9
        dists_m = np.array([0.3, 0.5, 0.7, 0.9]) * deg2m
        datasets = [SeismicDataset(station=f"S{i}", channel="Z",
                                   east=d, north=0.0,
                                   ydata=np.random.default_rng(i).normal(
                                       0, 1e-6, table.nt))
                    for i, d in enumerate(dists_m)]
        save_seismic_datasets(datasets, pdir)
        table.save(pdir + "/gf_table.npz")

        sc = SeismicConfig(waveforms=[WaveformFitConfig(
            distances=(0.4, 0.8),
            arrival_taper=_ArrivalTaperConfig(a=-3.0, b=-1.5, c=15.0, d=18.0),
            filterer=_FilterConfig(0.02, 0.5, 3))])
        comp = build_seismic_composite(sc, pdir, [DCSource(depth=9e3)])
        kept = [ds.station for ds in comp.wavemaps[0].datasets]
        assert kept == ["S1", "S2"]

        sc_bad = SeismicConfig(waveforms=[WaveformFitConfig(
            distances=(5.0, 9.0),
            arrival_taper=_ArrivalTaperConfig(a=-3.0, b=-1.5, c=15.0, d=18.0),
            filterer=_FilterConfig(0.02, 0.5, 3))])
        with pytest.raises(ValueError, match="removed every station"):
            build_seismic_composite(sc_bad, pdir, [DCSource(depth=9e3)])

    def test_subevent_wavemap_weeds_from_its_own_event(self, tmp_path, table):
        """Multi-event problems: epicentral distance is measured from the
        wavemap's event (event_idx), matching its arrival windows."""
        from beat_tpu.config import (ArrivalTaperConfig as _ArrivalTaperConfig,
                                     EventConfig,
                                     FilterConfig as _FilterConfig,
                                     SeismicConfig, WaveformFitConfig)
        from beat_tpu.inputf import save_seismic_datasets
        from beat_tpu.models.seismic import build_seismic_composite

        pdir = str(tmp_path)
        deg2m = 111194.9
        # stations at 0.3 and 0.9 deg east of the MAIN event; the
        # subevent sits 0.6 deg east, so relative to it they are at 0.3
        # deg each and BOTH pass a (0.2, 0.4) deg window
        dists_m = np.array([0.3, 0.9]) * deg2m
        datasets = [SeismicDataset(station=f"S{i}", channel="Z",
                                   east=d, north=0.0,
                                   ydata=np.random.default_rng(i).normal(
                                       0, 1e-6, table.nt))
                    for i, d in enumerate(dists_m)]
        save_seismic_datasets(datasets, pdir)
        table.save(pdir + "/gf_table.npz")

        events = [EventConfig(lat=0.0, lon=0.0),
                  EventConfig(name="sub", lat=0.0, lon=0.6, time=4.0)]
        sc = SeismicConfig(waveforms=[WaveformFitConfig(
            event_idx=1, distances=(0.2, 0.4),
            arrival_taper=_ArrivalTaperConfig(a=-3.0, b=-1.5, c=15.0, d=18.0),
            filterer=_FilterConfig(0.02, 0.5, 3))])
        comp = build_seismic_composite(sc, pdir,
                                       [DCSource(depth=9e3),
                                        DCSource(depth=9e3)], events=events)
        kept = [ds.station for ds in comp.wavemaps[0].datasets]
        assert kept == ["S0", "S1"]  # both ~0.3 deg from the subevent

"""
Every float32 matmul on the likelihood path states its precision: the
jaxpr of each composite's chain-batched logp (and of its gradient, the
MALA/HMC path) holds only ``dot_general``s at HIGHEST.  On the GPU an
unstated precision may run in TF32, which moves whitened
log-likelihoods by more than the sampler's noise.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.extend import core as jcore

HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)


def walk(closed):
    """``closed`` and every jaxpr nested in its equations."""
    yield closed
    for eqn in getattr(closed, "jaxpr", closed).eqns:
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(sub, (jcore.ClosedJaxpr, jcore.Jaxpr)):
                    yield from walk(sub)


def dot_precisions(fn, *args):
    closed = jax.make_jaxpr(fn)(*args)
    return [eqn.params["precision"] for j in walk(closed)
            for eqn in getattr(j, "jaxpr", j).eqns
            if eqn.primitive.name == "dot_general"]


def seismic_geometry(tmp_path):
    from __graft_entry__ import _build_flagship

    return _build_flagship(n_stations=4, nt=128,
                           outfolder=str(tmp_path / "out"))


def kinematic_ffi(tmp_path):
    from beat_tpu.covariance import Covariance
    from beat_tpu.ffi import discretize_sources, seis_construct_gf_linear
    from beat_tpu.heart.gftable import build_homogeneous_table
    from beat_tpu.heart.seismic import SeismicDataset, WaveformMapping
    from beat_tpu.heart.taper import ArrivalTaper, Filter
    from beat_tpu.models.distributer import SeismicDistributerComposite
    from beat_tpu.models.laplacian import LaplacianDistributerComposite
    from beat_tpu.models.problem import Problem
    from beat_tpu.parameter import Parameter, PriorSet
    from beat_tpu.sources import RectangularSource

    table = build_homogeneous_table(distances=np.linspace(10e3, 80e3, 6),
                                    depths=np.linspace(1e3, 12e3, 4),
                                    nt=128, dt=0.25)
    datasets = [SeismicDataset(station=f"S{i}", channel="Z", east=e,
                               north=n, ydata=np.zeros(table.nt))
                for i, (e, n) in enumerate([(30e3, 5e3), (-20e3, 35e3)])]
    wavemap = WaveformMapping(
        name="any_P", datasets=datasets, table=table,
        taper=ArrivalTaper(a=-2.0, b=-1.0, c=8.0, d=10.0),
        filterer=Filter(lower_corner=0.02, upper_corner=0.6, order=3))
    for ds in wavemap.datasets:
        ds.covariance = Covariance(data=np.eye(wavemap.nsamples_win))
    fault = discretize_sources(
        [RectangularSource(depth=3e3, strike=20.0, dip=70.0, length=4e3,
                           width=4e3)], patch_length=2e3, patch_width=2e3)
    lib = seis_construct_gf_linear(
        table, wavemap, fault, duration_bounds=(0.5, 1.5),
        starttime_bounds=(0.0, 2.0))
    n = fault.npatches
    priors = (PriorSet().add(Parameter("uparr", [0.0] * n, [2.0] * n))
              .add(Parameter("durations", [0.5] * n, [1.5] * n))
              .add(Parameter("velocities", [2e3] * n, [4e3] * n)))
    comps = {"seismic": SeismicDistributerComposite(
                 [(wavemap, {"uparr": lib})], fault),
             "laplacian": LaplacianDistributerComposite(fault)}
    return Problem(priors, comps, outfolder=str(tmp_path / "out"))


def geodetic_scene():
    from beat_tpu.covariance import Covariance
    from beat_tpu.heart.geodesy import GeodeticDataset

    e = np.linspace(-15e3, 15e3, 6)
    coords = np.stack(np.meshgrid(e, e), axis=-1).reshape(-1, 2)
    los = np.tile(np.array([-0.6, 0.1, 0.79]), (coords.shape[0], 1))
    los /= np.linalg.norm(los, axis=1, keepdims=True)
    return GeodeticDataset(
        name="scene", typ="SAR", coords=coords,
        displacement=np.zeros(coords.shape[0]), los_vector=los,
        covariance=Covariance(data=np.eye(coords.shape[0]) * 1e-4))


def geodetic_geometry(tmp_path):
    from beat_tpu.models.geodetic import GeodeticGeometryComposite
    from beat_tpu.models.problem import Problem
    from beat_tpu.parameter import Parameter, PriorSet
    from beat_tpu.sources import RectangularSource

    priors = (PriorSet().add(Parameter("depth", [500.0], [5e3]))
              .add(Parameter("slip", [0.1], [3.0])))
    comp = GeodeticGeometryComposite(
        [geodetic_scene()], [RectangularSource(length=8e3, width=4e3)])
    return Problem(priors, {"geodetic": comp}, outfolder=str(tmp_path / "out"))


def static_ffi(tmp_path):
    from beat_tpu.ffi import discretize_sources, geo_construct_gf_linear
    from beat_tpu.models.distributer import GeodeticDistributerComposite
    from beat_tpu.models.problem import Problem
    from beat_tpu.parameter import Parameter, PriorSet
    from beat_tpu.sources import RectangularSource

    scene = geodetic_scene()
    fault = discretize_sources(
        [RectangularSource(depth=2e3, strike=20.0, dip=60.0, length=6e3,
                           width=4e3)], patch_length=2e3, patch_width=2e3)
    lib = geo_construct_gf_linear(fault, scene.coords, scene.los_vector,
                                  components=("uparr",))
    n = fault.npatches
    priors = PriorSet().add(Parameter("uparr", [0.0] * n, [2.0] * n))
    comp = GeodeticDistributerComposite([scene], lib, fault)
    return Problem(priors, {"geodetic": comp}, outfolder=str(tmp_path / "out"))


BUILDERS = {"seismic_geometry": seismic_geometry,
            "kinematic_ffi": kinematic_ffi,
            "geodetic_geometry": geodetic_geometry,
            "static_ffi": static_ffi}


def population(problem, n=3):
    lower, upper = problem.priors.bounds_arrays()
    return jnp.asarray(np.random.default_rng(0).uniform(
        lower, upper, size=(n, lower.size)), dtype=jnp.float32)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_logp_matmuls_at_highest(name, tmp_path):
    problem = BUILDERS[name](tmp_path)
    logp, data = problem.make_logp_fn()
    precs = dot_precisions(jax.vmap(logp, in_axes=(0, None)),
                           population(problem), data)
    assert precs, f"{name}: no matmul found — the test would prove nothing"
    assert all(p == HIGHEST for p in precs), (name, set(precs))


@pytest.mark.parametrize("name", ["seismic_geometry", "static_ffi"])
def test_logp_gradient_matmuls_at_highest(name, tmp_path):
    """The MALA/HMC path differentiates the logp: its transposed
    matmuls keep the precision."""
    problem = BUILDERS[name](tmp_path)
    logp, data = problem.make_logp_fn()
    precs = dot_precisions(
        jax.vmap(jax.value_and_grad(logp), in_axes=(0, None)),
        population(problem), data)
    assert precs and all(p == HIGHEST for p in precs), set(precs)


def test_hyper_logp_matmuls_at_highest(tmp_path):
    problem = seismic_geometry(tmp_path)
    logp, data = problem.make_hyper_logp_fn(problem.priors.test_point())
    precs = dot_precisions(jax.vmap(logp, in_axes=(0, None)),
                           population(problem), data)
    assert all(p == HIGHEST for p in precs), set(precs)


def test_unpinned_logp_is_caught(tmp_path):
    """The walk sees nested matmuls: the logp without its precision
    scope has matmuls at the default precision."""
    problem = seismic_geometry(tmp_path)
    logp, data = problem.make_logp_fn()
    precs = dot_precisions(jax.vmap(logp.__wrapped__, in_axes=(0, None)),
                           population(problem), data)
    assert precs and any(p != HIGHEST for p in precs)

"""
BEM-mode inversion end-to-end: recover the pressure (traction) and
geometry of a buried pressurized crack from InSAR surface displacements
(reference Fernandina BEM example intent at toy scale).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from beat_tpu.bem import BEMEngine, BoundaryCondition, DiskBEMSource
from beat_tpu.covariance import Covariance
from beat_tpu.heart.geodesy import GeodeticDataset
from beat_tpu.models.bem import GeodeticBEMComposite
from beat_tpu.models.problem import Problem
from beat_tpu.parameter import Parameter, PriorSet
from beat_tpu.samplers import SMCParams

TRUE_DEPTH = 3.0e3
TRUE_TRACTION = 20.0  # MPa

# parameter name ported to BC tractions via the template trick: the
# engine BC traction is fixed; we sample the source depth and let
# amplitude enter via traction… simplest observable pair: depth + a_half_axis


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    g = 8
    e = np.linspace(-6e3, 6e3, g)
    coords = np.stack(np.meshgrid(e, e), -1).reshape(-1, 2)
    los = np.tile([0.1, -0.05, 0.99], (coords.shape[0], 1))
    los /= np.linalg.norm(los, axis=1, keepdims=True)

    engine = BEMEngine(
        [BoundaryCondition("normal", [0], [0], traction=TRUE_TRACTION)],
        mesh_size=900.0, check_mesh_intersection=False,
        quadrature_level=1, near_quadrature_level=5)
    true_src = DiskBEMSource(depth=TRUE_DEPTH, a_half_axis=1000.0)
    resp = engine.process([true_src], coords)
    obs = np.einsum("ni,ni->n", resp.displacements, los)
    sd = 0.03 * np.abs(obs).max()
    ds = GeodeticDataset(
        name="volcano", typ="SAR", coords=coords,
        displacement=obs + rng.normal(0, sd, obs.shape), los_vector=los,
        covariance=Covariance(data=np.eye(obs.size) * sd**2))
    return ds, engine


class TestBEMComposite:
    @pytest.mark.slow
    def test_forward_informative(self, setup):
        ds, engine = setup
        comp = GeodeticBEMComposite([ds], [DiskBEMSource(a_half_axis=1000.0)],
                                    engine)
        l_true = float(comp.loglike({"depth": jnp.asarray(TRUE_DEPTH)}))
        l_off = float(comp.loglike({"depth": jnp.asarray(5.5e3)}))
        assert np.isfinite(l_true) and l_true > l_off

    def test_invalid_geometry_rejected(self, setup):
        ds, _ = setup
        engine = BEMEngine(
            [BoundaryCondition("normal", [0], [0], traction=TRUE_TRACTION)],
            mesh_size=900.0, check_mesh_intersection=True,
            quadrature_level=1, near_quadrature_level=5)
        comp = GeodeticBEMComposite([ds], [DiskBEMSource(a_half_axis=1000.0)],
                                    engine)
        # source breaching the free surface → -99 fill → terrible llk
        l_bad = float(comp.loglike({"depth": jnp.asarray(-500.0)}))
        l_ok = float(comp.loglike({"depth": jnp.asarray(TRUE_DEPTH)}))
        assert l_ok > l_bad

    def test_smc_recovers_traction_linear(self, setup, tmp_path):
        """Fixed geometry → the linear BEM composite samples tractions
        fully on-device (precomputed unit responses): the on-device BEM
        inversion path."""
        from beat_tpu.models.bem import GeodeticBEMLinearComposite

        ds, engine = setup
        comp = GeodeticBEMLinearComposite(
            [ds], [DiskBEMSource(depth=TRUE_DEPTH, a_half_axis=1000.0)], engine)
        assert comp._unit_los.shape == (ds.samples, 1)

        priors = PriorSet()
        for p in comp.traction_parameters():
            p.lower = np.asarray([1.0])
            p.upper = np.asarray([60.0])
            p.testvalue = np.asarray([TRUE_TRACTION])
            priors.add(p)
        assert "normal_traction" in priors.names

        problem = Problem(priors, {"geodetic": comp},
                          outfolder=str(tmp_path / "bem_lin"),
                          sampler_params=SMCParams(n_chains=64, n_steps=30,
                                                   seed=4))
        q_tr, _ = problem.sample()
        est = problem.ordering.to_point(q_tr[-1].mean(axis=0))
        assert abs(est["normal_traction"] - TRUE_TRACTION) / TRUE_TRACTION < 0.1

    @pytest.mark.slow
    def test_vmapped_callback_batches_on_host(self, setup):
        """Under vmap the chain batch arrives in ONE host call and the
        thread-pooled per-chain solves equal the per-point forwards;
        sampled tractions enter the solve."""
        import jax

        ds, engine = setup
        comp = GeodeticBEMComposite([ds], [DiskBEMSource(a_half_axis=1000.0)],
                                    engine)
        depths = jnp.asarray([2.5e3, 3.0e3, 3.5e3])
        tracs = jnp.asarray([10.0, 20.0, 30.0])

        batched = jax.vmap(lambda d, t: comp.synthetics_los(
            {"depth": d, "normal_traction": t}))(depths, tracs)
        singles = np.stack([
            comp.synthetics_los_np({"depth": float(d),
                                    "normal_traction": float(t)})
            for d, t in zip(depths, tracs)])
        np.testing.assert_allclose(np.asarray(batched), singles,
                                   rtol=1e-5, atol=1e-9)
        # different (depth, traction) per chain → different responses
        assert not np.allclose(singles[0], singles[2])

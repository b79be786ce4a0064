"""
BEM inversion of a pressurized crack from InSAR (reference Fernandina
BEM example intent): halfspace triangular-dislocation engine with a
normal-traction boundary condition.

This example uses the on-device LINEAR path
(:class:`GeodeticBEMLinearComposite`): the geometry is fixed, the
unit-traction LOS responses are precomputed once, and every likelihood
evaluation is an on-device matvec — so the SMC runs at full lockstep
speed and recovers the driving overpressure.  (Geometry sampling via
the host-callback composite works the same way but pays one BEM solve
per draw; see tests/test_bem_inversion.py.)

Run:  python examples/bem_dike.py   (~2 min)
"""

import sys

import numpy as np

sys.path.insert(0, ".")

from beat_tpu.bem import BEMEngine, BoundaryCondition, DiskBEMSource
from beat_tpu.covariance import Covariance
from beat_tpu.heart.geodesy import GeodeticDataset
from beat_tpu.models.bem import GeodeticBEMLinearComposite
from beat_tpu.models.problem import Problem
from beat_tpu.parameter import Parameter, PriorSet

TRUE_DEPTH = 3.0e3
TRUE_TRACTION = 20.0  # MPa overpressure


def main(outdir="bem_run"):
    rng = np.random.default_rng(0)
    g = 8
    e = np.linspace(-6e3, 6e3, g)
    coords = np.stack(np.meshgrid(e, e), -1).reshape(-1, 2)
    los = np.tile([0.1, -0.05, 0.99], (coords.shape[0], 1))
    los /= np.linalg.norm(los, axis=1, keepdims=True)

    engine = BEMEngine(
        [BoundaryCondition("normal", [0], [0], traction=TRUE_TRACTION)],
        mesh_size=1200.0, check_mesh_intersection=False,
        quadrature_level=1, near_quadrature_level=4)
    resp = engine.process([DiskBEMSource(depth=TRUE_DEPTH,
                                         a_half_axis=1000.0)], coords)
    obs = np.einsum("ni,ni->n", resp.displacements, los)
    sd = 0.03 * np.abs(obs).max()
    ds = GeodeticDataset(
        name="volcano", typ="SAR", coords=coords,
        displacement=obs + rng.normal(0, sd, obs.shape), los_vector=los,
        covariance=Covariance(data=np.eye(obs.size) * sd**2))

    comp = GeodeticBEMLinearComposite(
        [ds], [DiskBEMSource(depth=TRUE_DEPTH, a_half_axis=1000.0)], engine)
    priors = PriorSet().add(Parameter("normal_traction", [0.0], [60.0]))
    problem = Problem(priors, {"geodetic": comp}, outfolder=outdir)

    from beat_tpu.samplers import SMCParams

    problem.sampler_params = SMCParams(n_chains=128, n_steps=30, seed=1)
    problem.sample()

    from beat_tpu.backend import SampleStage, summarize_trace

    summary = summarize_trace(
        SampleStage(outdir, ordering=problem.ordering).load_trace(-1))
    rec = summary["normal_traction"]
    print(f"overpressure: {rec['mean']:.1f} ± {rec['sd']:.1f} MPa "
          f"(truth {TRUE_TRACTION})")


if __name__ == "__main__":
    main(*sys.argv[1:2])

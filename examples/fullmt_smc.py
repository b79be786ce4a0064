"""
FullMT-style moment-tensor inversion (reference docs example
``docs/examples/FullMT_regional.rst``): synthesize waveforms from a
known mechanism, invert the full MT + depth + time + duration with SMC.

Run:  python examples/fullmt_smc.py [outdir]  (GPU wall time not
measured yet; shrink N_CHAINS/N_STEPS for a smoke run on the CPU)
"""

import sys

import numpy as np

sys.path.insert(0, ".")

from __graft_entry__ import _build_flagship  # hermetic FullMT problem

from beat_tpu.backend import SampleStage, summarize_trace
from beat_tpu.samplers import SMCParams


def main(outdir="fullmt_run", n_chains=1000, n_steps=60):
    problem = _build_flagship(n_stations=8, nt=256)
    problem.outfolder = outdir
    problem.sampler_params = SMCParams(n_chains=n_chains, n_steps=n_steps,
                                       seed=0)
    problem.sample()

    handler = SampleStage(outdir, ordering=problem.ordering)
    summary = summarize_trace(handler.load_trace(-1))
    for name in ("depth", "magnitude", "duration"):
        rec = summary[name]
        print(f"{name:>10}: {rec['mean']:.3f} ± {rec['sd']:.3f}")
    print("truth: depth 9000 m, Mw 5.8, duration 1.5 s")
    return summary


if __name__ == "__main__":
    main(*sys.argv[1:2])

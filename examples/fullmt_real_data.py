"""
REAL-data moment-tensor inversion: the reference's bundled FullMT
project end-to-end through the native stack.

Pipeline (one command, no pyrocko required):
  1. ``beat-tpu import`` machinery migrates the reference project —
     tag-tolerant guts-YAML config parse, shim-unpickled
     ``seismic_data.pkl`` (10 real test stations, 30 traces), custom
     layered velocity model;
  2. a native DWN (Kennett-recursion) GF table is built for the
     project's velocity model at the stations' 135-955 km ranges;
  3. the observed traces are windowed/filtered exactly like the
     synthetics and inverted with lockstep SMC;
  4. the posterior is checked against the GCMT mechanism embedded in
     the config (the truth of the example's synthetic data, see
     reference ``docs/examples/FullMT_regional.rst``).

Expected result (n_chains=500): MT direction cosine vs GCMT > 0.97,
magnitude ≈ 5.85, origin-time shift ≈ -12 s, depth ≈ 7-8 km.

Run:  python examples/fullmt_real_data.py [workdir]
      (~5 min on a 1-core CPU host: ~1 min table build + sampling;
      GPU time not measured)
"""

import os
import shutil
import sys
import time

import numpy as np

sys.path.insert(0, ".")

SRC = "/root/reference/data/examples/FullMT"
GCMT = {"mnn": -0.43283071, "mee": 0.65741974, "mdd": -0.22458903,
        "mne": 0.63839719, "mnd": 0.50698292, "med": 0.02063122}


def main(workdir="/tmp/beat_tpu_fullmt_real_example"):
    from beat_tpu import interop
    from beat_tpu.models.problem import load_model
    from beat_tpu.samplers import SMCParams

    if not os.path.isdir(SRC):
        print(f"reference example not found at {SRC}")
        return 1

    if not os.path.exists(os.path.join(workdir, "gf_table.npz")):
        shutil.rmtree(workdir, ignore_errors=True)
        t0 = time.time()
        interop.import_beat_project(
            SRC, workdir, build=True,
            # the bundled synthetic data match the plain custom velocity
            # model (no ak135 continuation): see interop docstring
            gf_overrides={"join_base_model": False, "n_distances": 96,
                          "n_depths": 8, "nt": 1024, "n_variations": 0})
        print(f"import + native GF table build: {time.time() - t0:.0f} s")

    problem = load_model(workdir, "geometry")
    problem.sampler_params = SMCParams(n_chains=500, n_steps=100,
                                       tune_interval=20, seed=5)
    t0 = time.time()
    q_tr, llk_tr = problem.sample()
    print(f"SMC inversion: {time.time() - t0:.0f} s")

    final = np.asarray(q_tr[-1])
    llk = np.asarray(llk_tr[-1])
    for tag, vec in (("posterior mean", final.mean(axis=0)),
                     ("MAP", final[np.argmax(llk)])):
        pt = problem.ordering.to_point(vec)
        est = np.array([float(np.asarray(pt[k])) for k in GCMT])
        ref = np.array(list(GCMT.values()))
        cos = est @ ref / (np.linalg.norm(est) * np.linalg.norm(ref))
        print(f"{tag}: MT cosine vs GCMT {cos:+.3f}  "
              f"Mw {float(np.asarray(pt['magnitude'])):.2f}  "
              f"time {float(np.asarray(pt['time'])):+.1f} s  "
              f"depth {float(np.asarray(pt['depth'])) / 1e3:.1f} km")

    comp = problem.composites["seismic"]
    map_pt = problem.ordering.to_point(final[np.argmax(llk)])
    vrs = comp.get_variance_reductions(map_pt)
    for wname, vr in vrs.items():
        print(f"variance reduction [{wname}]: {vr:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))

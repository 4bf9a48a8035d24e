"""FastSLAM-vs-PHD robustness grid: the evidence behind filter_type = 2.

The reference repo's entire premise (its thesis and the vestigial
src/fastslam.cu skeleton it abandoned) is that vector-based FastSLAM
degrades under clutter and measurement noise where the RFS (PHD) filter
does not — data association errors in a per-particle ML/joint-assignment
map are unrecoverable, while the PHD update hedges across all
associations. This script measures that claim on OUR working FastSLAM
(filter/fastslam.py) against the PHD filter on the same streams: a
(clutter_rate x std_range) grid of 150-step synthetic runs through the
full `slam_step` (256 particles, same scenario/noise/RNG per cell pair).

Writes results/fastslam_grid.json (merge-per-cell, resumable). Rendered
into RESULTS.md by eval_baselines.py.

Usage: python \
           scripts/fastslam_evidence.py [--cell CLUTTER STD FTYPE] [--smoke]
       (no --cell: runs the full default grid)
"""

from __future__ import annotations

import json
import os
import sys


import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SMOKE = "--smoke" in sys.argv

# (clutter_rate, std_range, filter_type): FastSLAM across the regime +
# PHD anchors at the corners
GRID = [
    (2.0, 0.25, 2), (2.0, 1.0, 2), (20.0, 0.25, 2), (20.0, 1.0, 2),
    (2.0, 0.25, 0), (20.0, 1.0, 0),
]

OUT = "results/fastslam_grid.json"


def run_cell(clutter, sr, ftype, T=150, n_particles=256):
    import jax
    import jax.numpy as jnp

    from phdslam_tpu.config import load_config
    from phdslam_tpu.filter.state import Measurements, SlamState
    from phdslam_tpu.filter.step import slam_step
    from phdslam_tpu.io.loaders import MeasurementSet, pad_measurement_sets
    from phdslam_tpu.simdata import generate_run, make_scenario
    from phdslam_tpu.utils import configure_compile_cache

    configure_compile_cache()
    cfg = load_config("cfg/fastslam_synth.cfg" if ftype == 2
                      else "cfg/ackerman_synth.cfg")
    cfg = cfg.replace(clutterRate=clutter, stdRange=sr, nSteps=T,
                      n_particles=n_particles, x0=0.0, y0=0.0, yaw0=0.0)
    # fixed streams per cell: scenario seed 7, run seed 8, filter key 5 —
    # the SAME data reaches both filter types so the comparison is paired
    rng = np.random.default_rng(7)
    sc = make_scenario(rng, n_landmarks=80, n_steps=T, clutter_rate=clutter)
    sc = sc.__class__(**{**sc.__dict__, "std_range": sr})
    controls, meas = generate_run(np.random.default_rng(8), sc,
                                  control_noise=(0.2, 0.01))
    sets = [MeasurementSet(z[:, 0], z[:, 1], np.zeros(len(z), np.int32))
            for z in meas]
    rb, labels, valid = pad_measurement_sets(sets, cfg.maxMeasurements)
    state = SlamState.create(cfg)
    key = jax.random.PRNGKey(5)
    errs = []
    for t in range(T):
        z = Measurements(rb=jnp.asarray(rb[t]), label=jnp.asarray(labels[t]),
                         valid=jnp.asarray(valid[t]))
        u = (jnp.float32(controls[t - 1, 0] if t > 0 else 0),
             jnp.float32(controls[t - 1, 1] if t > 0 else 0))
        key, sk = jax.random.split(key)
        state, aux = slam_step(state, sk, u, z, jnp.float32(cfg.dt),
                               jnp.asarray(t > 0), cfg)
        errs.append(float(np.linalg.norm(
            np.asarray(aux.expected_pose[:2]) - sc.traj[t, :2])))
    errs = np.asarray(errs)
    return {
        "clutter_rate": clutter, "std_range": sr, "filter_type": ftype,
        "steps": T, "n_particles": n_particles,
        "pose_mean": round(float(errs.mean()), 2),
        "pose_late_mean": round(float(errs[T // 2:].mean()), 2),
        "pose_max": round(float(errs.max()), 2),
    }


def main():
    cells = GRID
    if "--cell" in sys.argv:
        i = sys.argv.index("--cell")
        cells = [(float(sys.argv[i + 1]), float(sys.argv[i + 2]),
                  int(sys.argv[i + 3]))]
    data = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            data = json.load(f)
    for clutter, sr, ftype in cells:
        kw = dict(T=20, n_particles=32) if SMOKE else {}
        row = run_cell(clutter, sr, ftype, **kw)
        key = f"c{clutter:g}_s{sr:g}_f{ftype}"
        data[key] = row
        print(json.dumps(row), flush=True)
        if not SMOKE:
            with open(OUT, "w") as f:
                json.dump(data, f, indent=1)


if __name__ == "__main__":
    main()

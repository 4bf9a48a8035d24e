"""Generate the shipped synthetic Ackerman range-bearing dataset
(data/ackerman_synth/), which cfg/{ackerman,cv,fastslam,mixed}_synth.cfg
read.

The SynthSetup2 recipe through phdslam_tpu.simdata: 80 landmarks in a
40 m square, a looping Ackerman trajectory of 330 steps, range-bearing
detections with the cfg's sensor model (10 m, 180 deg FOV, std_range 1.0,
pd 0.95, clutter 20 per scan) and encoder/steering noise at the cfg's
std_encoder / std_alpha. The scene is shifted so the truth starts at the
cfgs' initial pose (0, -15, 0). Writes measurements.txt, controls.txt,
traj.txt (x y theta vx vy vtheta per step) and landmarks.txt (x y).

    python scripts/gen_ackerman_data.py [out_dir] [seed]
"""

import os
import sys

import numpy as np

from phdslam_tpu.simdata import generate_run, make_scenario, write_run_files
from phdslam_tpu.utils import REPO_ROOT

START = np.array([0.0, -15.0])      # the cfgs' initial_x, initial_y
CONTROL_NOISE = (0.2, 0.01)         # the cfgs' std_encoder, std_alpha


def main(out_dir=os.path.join(REPO_ROOT, "data", "ackerman_synth"),
         seed=2):
    rng = np.random.default_rng(int(seed))
    sc = make_scenario(rng, n_landmarks=80, n_steps=330)
    sc.landmarks = sc.landmarks + START
    sc.traj[:, :2] += START
    controls, meas = generate_run(rng, sc, CONTROL_NOISE)
    write_run_files(out_dir, controls, meas)
    with open(os.path.join(out_dir, "traj.txt"), "w") as f:
        f.write("% ground truth: x y theta vx vy vtheta\n")
        for x, y, th in sc.traj:
            f.write(f"{x:.6f} {y:.6f} {th:.6f} 0 0 0\n")
    with open(os.path.join(out_dir, "landmarks.txt"), "w") as f:
        f.write("% landmarks: x y\n")
        for x, y in sc.landmarks:
            f.write(f"{x:.6f} {y:.6f}\n")
    sizes = [len(z) for z in meas]
    print(f"wrote {out_dir}: {len(meas)} steps, "
          f"{min(sizes)}-{max(sizes)} measurements/step, "
          f"{sc.landmarks.shape[0]} landmarks")


if __name__ == "__main__":
    main(*sys.argv[1:])

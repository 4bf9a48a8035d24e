"""Shipped-Ackerman accuracy vs the reference's own knobs (r3 item 7).

Sweeps, on the shipped measurements_synth_ackerman.txt dataset (BASELINE
config 2, 331 steps, matched control noise), the tools the reference
provides for exactly this scenario:

  - n_particles            (src/main.cpp:991)
  - n_predict_particles    (particle shotgunning, phdfilter.cu:1185-1238)
  - subdivide_predict      (prediction sub-stepping, src/main.cpp:1248-1254)

Scores per variant x seed: pose RMSE over the run, final OSPA(p=1,c=5) of
the MAP map vs the cumulative ground truth, and warm ms/step — the
error-vs-cost tradeoff curve for RESULTS.md. Writes
results/ackerman_knobs.json.

Run: python scripts/ackerman_knobs.py
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from phdslam_tpu.utils import configure_compile_cache

configure_compile_cache()

from phdslam_tpu.config import load_config  # noqa: E402
from eval_baselines import load_ackerman, map_ospa, run_engine  # noqa: E402

QUICK = "--quick" in sys.argv

VARIANTS = [
    ("base P=256", dict(n_particles=256)),
    ("P=1024", dict(n_particles=1024)),
    ("P=4096", dict(n_particles=4096)),
    ("P=256 shotgun x4", dict(n_particles=256, nPredictParticles=4)),
    ("P=256 subdiv=3", dict(n_particles=256, subdividePredict=3)),
    ("P=1024 shotgun x4", dict(n_particles=1024, nPredictParticles=4)),
    ("P=4096 shotgun x4", dict(n_particles=4096, nPredictParticles=4)),
]


def main():
    traj, us, ms, gt = load_ackerman()
    T = 120 if QUICK else 331
    n_seeds = 1 if QUICK else 3
    base = load_config("cfg/ackerman_synth.cfg")
    rows = []
    if os.path.exists("results/ackerman_knobs.json"):
        with open("results/ackerman_knobs.json") as f:
            prev = json.load(f)
        if prev.get("T") == T and prev.get("n_seeds") == n_seeds:
            rows = prev["rows"]       # resume: skip finished variants
    done = {r["name"] for r in rows}
    for name, kw in VARIANTS[: 3 if QUICK else len(VARIANTS)]:
        if name in done:
            continue
        cfg = base.replace(**kw)
        rmses, ospas, steps_ms = [], [], []
        for seed in range(n_seeds):
            rng_s = np.random.default_rng(100 + seed)
            noisy = (us[: T - 1] + rng_s.normal(0, (0.2, 0.01), (T - 1, 2))
                     ).astype(np.float32)
            final, poses, ms_step = run_engine(cfg, ms, noisy, T, seed=seed)
            err = np.linalg.norm(poses[:, :2] - traj[:2, :T].T, axis=1)
            (osp, _loc, _card), n_est, n_gt = map_ospa(final, gt[T - 1])
            rmses.append(float(np.sqrt((err ** 2).mean())))
            ospas.append(float(osp))
            steps_ms.append(ms_step)
        row = dict(name=name, knobs=kw,
                   pose_rmse_mean=round(float(np.mean(rmses)), 3),
                   pose_rmse_per_seed=[round(r, 3) for r in rmses],
                   ospa_mean=round(float(np.mean(ospas)), 3),
                   ospa_per_seed=[round(o, 3) for o in ospas],
                   ms_per_step=round(float(np.mean(steps_ms)), 2))
        rows.append(row)
        print(f"{name:22s} poseRMSE {row['pose_rmse_mean']:6.2f} m  "
              f"OSPA {row['ospa_mean']:5.2f}  {row['ms_per_step']:7.2f} "
              f"ms/step", flush=True)
        # incremental dump: a long sweep keeps the rows finished so far
        os.makedirs("results", exist_ok=True)
        with open("results/ackerman_knobs.json", "w") as f:
            json.dump(dict(T=T, n_seeds=n_seeds, rows=rows), f, indent=1)
    print("wrote results/ackerman_knobs.json")


if __name__ == "__main__":
    main()

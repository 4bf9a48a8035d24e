"""Diagnose the CPHD end-of-run cardinality behavior (VERDICT r3 item 2).

Runs the BASELINE config-3 setup (CPHD, 1024 particles, Ackerman synth,
150 steps) with per-step log state, then reconstructs on the host, for the
MAP particle of every step:

  - E[n] from the posterior cardinality pmf (what RESULTS.md plots)
  - the in-range-SUBMAP intensity mass (rclass != 0 features, the set the
    Psi machinery sees and the mean of the Poisson-rebuilt prior)
  - the strict in-FOV intensity mass and confirmed (w > 0.25) feature count
  - the true per-step in-FOV landmark count
  - the number of valid measurements

Writes results/cphd_diag.json + results/cphd_diag.png. The point is to
separate "the posterior tracks a collapsed prior" (submap mass ~ 0 at run
end -> mechanism is map-side) from "the Psi evidence kills the posterior"
(submap mass healthy, E[n] still 0 -> bug in the update).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from phdslam_tpu.utils import configure_compile_cache

configure_compile_cache()

from phdslam_tpu.config import load_config  # noqa: E402
from eval_baselines import load_ackerman, run_engine  # noqa: E402


def wrap(a):
    return np.arctan2(np.sin(a), np.cos(a))


def main():
    T = int(sys.argv[1]) if len(sys.argv) > 1 else 150
    traj, us, ms, gt = load_ackerman()
    rng = np.random.default_rng(3)
    noisy = (us[: T - 1] + rng.normal(0, (0.2, 0.01), (T - 1, 2))
             ).astype(np.float32)
    cfg = load_config("cfg/ackerman_synth.cfg").replace(
        n_particles=1024, filterType=1, maxCardinality=127,
        gateBirths=True, gateThreshold=9.0, mapEstimate=2)
    # key=value overrides after T, e.g. resampleThresh=0 gateBirths=0
    tag = ""
    for kv in sys.argv[2:]:
        k, v = kv.split("=")
        cur = getattr(cfg, k)
        cast = type(cur) if cur is not None else float
        cfg = cfg.replace(**{k: cast(float(v))})
        tag += f"_{k}{v}"

    final, poses, ms_step, la = run_engine(cfg, ms, noisy, T, with_log=True)

    cn = np.asarray(la.cardinality)                       # [T, N+1]
    pmf = np.exp(cn - cn.max(axis=1, keepdims=True))
    pmf /= pmf.sum(axis=1, keepdims=True)
    e_n = (pmf * np.arange(pmf.shape[1])).sum(1)

    lw = np.asarray(la.log_weights)                       # [T, P]
    all_poses = np.asarray(la.poses)                      # [T, P, 6]
    map_idx = lw.argmax(axis=1)
    map_pose = all_poses[np.arange(T), map_idx]           # [T, 6]

    w = np.asarray(la.map_w)                              # [T, F]
    mx = np.asarray(la.map_mx)
    my = np.asarray(la.map_my)

    dx = mx - map_pose[:, None, 0]
    dy = my - map_pose[:, None, 1]
    r = np.hypot(dx, dy)
    b = wrap(np.arctan2(dy, dx) - map_pose[:, None, 2])
    in_r = ((r >= cfg.minRange) & (r <= cfg.maxRange)
            & (np.abs(b) <= cfg.maxBearing))
    near = ((r >= 0.8 * cfg.minRange) & (r <= 1.2 * cfg.maxRange)
            & (np.abs(b) <= 1.2 * cfg.maxBearing))
    subm = near & (w > 0)                                 # rclass != 0

    mass_sub = (w * subm).sum(1)                          # Poisson prior mean
    mass_in = (w * in_r).sum(1)
    n_conf = ((w > 0.25) & in_r).sum(1)
    mass_total = w.sum(1)

    # truth: per-step in-FOV landmark count against the TRUE trajectory
    full_map = gt[T - 1]
    d = full_map[None, :, :] - traj[:2, :T].T[:, None, :]
    rt = np.linalg.norm(d, axis=-1)
    bt = wrap(np.arctan2(d[..., 1], d[..., 0]) - traj[2, :T][:, None])
    fov_t = ((rt <= cfg.maxRange) & (rt >= cfg.minRange)
             & (np.abs(bt) <= cfg.maxBearing))
    n_fov = fov_t.sum(1).astype(float)

    n_meas = np.array([len(m.ranges) for m in ms[:T]], float)

    out = dict(T=T, ms_per_step=ms_step,
               e_n=e_n.tolist(), n_fov=n_fov.tolist(),
               mass_submap=mass_sub.tolist(), mass_in_fov=mass_in.tolist(),
               mass_total=mass_total.tolist(),
               n_confirmed_in_fov=n_conf.tolist(), n_meas=n_meas.tolist(),
               err_final=float(abs(e_n[-1] - n_fov[-1])),
               err_mean=float(np.abs(e_n - n_fov).mean()))
    os.makedirs("results", exist_ok=True)
    with open(f"results/cphd_diag{tag}.json", "w") as f:
        json.dump(out, f, indent=1)

    print(f"ms/step {ms_step:.2f}")
    print("last 30 steps: t, E[n], n_fov, submapMass, inFovMass, conf, nMeas")
    for t in range(max(0, T - 30), T):
        print(f"  {t:3d}  {e_n[t]:6.2f}  {n_fov[t]:4.0f}  {mass_sub[t]:7.2f}"
              f"  {mass_in[t]:7.2f}  {n_conf[t]:3d}  {n_meas[t]:3.0f}")
    print(f"|E[n]-n_fov| mean {out['err_mean']:.2f} final {out['err_final']:.2f}")

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(9, 3.6))
        ax.plot(e_n, label="E[n] posterior")
        ax.plot(mass_sub, "--", label="submap intensity mass (prior mean)")
        ax.plot(n_fov, "g-", lw=1, label="in-FOV landmarks (truth)")
        ax.plot(n_conf, ":", label="confirmed in-FOV features (w>0.25)")
        ax.set_xlabel("time step")
        ax.legend(fontsize=8)
        fig.tight_layout()
        fig.savefig(f"results/cphd_diag{tag}.png", dpi=110)
        print(f"wrote results/cphd_diag{tag}.png")
    except Exception as e:  # pragma: no cover
        print("plot skipped:", e)


if __name__ == "__main__":
    main()

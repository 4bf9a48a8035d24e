"""Round-3 evidence generation: Monte-Carlo envelopes and timing
comparisons backing the VERDICT r2 items.

Phases (each standalone; results append to results/round3_evidence.json):
  vmap      item 2: vmapped vs sequential MC batch wall-clock at the
            headline 50x330 shape, bit-comparable envelopes
  merge     item 1: exact vs fast merge-mode accuracy envelopes (>=20
            runs), OSPA overlay -> results/merge_mode_envelopes.png
  variants  item 4: PHD vs CPHD and particleWeighting 0 vs 1 envelopes
            (the reference batch harness's whole purpose, SURVEY 4.2;
            python/plot_results.py:21-66) -> results/variant_envelopes.png
            + cardinality-error curves (item 3 reporting)
  parity    item 9: config-2 statistical parity — >=20 seeds of the JAX
            engine vs reference_cpu.py at the SAME config (64p) on the MC
            scenario -> results/parity_envelopes.png
  cphd_cpu  item 5: CPU CPHD oracle ms/step denominator + pose parity

Usage: python \
           scripts/round3_evidence.py <phase> [--quick]
"""

from __future__ import annotations

import json
import os
import sys
import time


import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

QUICK = "--quick" in sys.argv

RESULTS_JSON = "results/round3_evidence.json"


def _merge_json(update: dict):
    os.makedirs("results", exist_ok=True)
    data = {}
    if os.path.exists(RESULTS_JSON):
        with open(RESULTS_JSON) as f:
            data = json.load(f)
    data.update(update)
    with open(RESULTS_JSON, "w") as f:
        json.dump(data, f, indent=1)
    print(json.dumps(update))


def _scenario(n_steps=None):
    from phdslam_tpu.simdata import make_scenario
    return make_scenario(np.random.default_rng(42), n_landmarks=80,
                         n_steps=n_steps or (60 if QUICK else 330))


def _base_cfg():
    from phdslam_tpu.config import load_config
    return load_config("cfg/ackerman_synth.cfg").replace(n_particles=256)


def phase_vmap():
    """Wall-clock: vmapped vs sequential run_batch at the headline shape.

    Same seeds on both paths -> the same filter runs; the comparison
    fetches everything before the clock stops."""
    from phdslam_tpu.eval.batch import run_batch

    cfg = _base_cfg()
    sc = _scenario()
    n_runs = 6 if QUICK else 50

    # two passes per path: pass 1 includes the compile, pass 2 is the
    # steady-state number (identical shapes -> compiled-executable reuse;
    # sweeps are re-run many times in practice, so pass 2 is the honest
    # comparison — pass-1 times reported for transparency)
    times = {}
    results = {}
    for label, vmapped in (("vmapped", True), ("sequential", False)):
        per_pass = []
        for _ in range(2):
            t0 = time.time()
            res = run_batch(cfg, sc, n_runs=n_runs,
                            control_noise=(0.2, 0.01),
                            vmapped=vmapped, collect_maps_every=4)
            per_pass.append(time.time() - t0)
        times[label] = per_pass
        results[label] = res

    # envelope comparability (same seeds -> same runs up to reassociation)
    pe_v = np.stack([r.pose_err for r in results["vmapped"]]).mean(0)
    pe_s = np.stack([r.pose_err for r in results["sequential"]]).mean(0)
    max_dev = float(np.max(np.abs(pe_v - pe_s)))

    # crossover probe: at small particle counts per-run work underutilizes
    # the chip and the vmapped axis should win; at the headline 256p the
    # sequential path wins (cond->select resampling + worst-case merge
    # trips under vmap — see eval/batch.py module docstring)
    probe = {}
    for p_small in (32,):
        cfg_s = cfg.replace(n_particles=p_small)
        tt = {}
        for label, vmapped in (("vmapped", True), ("sequential", False)):
            for i in range(2):
                t0 = time.time()
                run_batch(cfg_s, sc, n_runs=n_runs,
                          control_noise=(0.2, 0.01), vmapped=vmapped,
                          collect_maps_every=0)
                tt[label] = time.time() - t0
        probe[f"p{p_small}"] = dict(
            vmapped_s=round(tt["vmapped"], 1),
            sequential_s=round(tt["sequential"], 1),
            speedup=round(tt["sequential"] / tt["vmapped"], 2))

    # fast-merge probe: does merge_mode=1 (bounded trip counts) flip the
    # vmapped-vs-sequential verdict? (it removes reason (b) of the vmap
    # loss — see eval/batch.py docstring)
    cfg_f = cfg.replace(mergeMode=1)
    times_f, results_f = {}, {}
    for label, vmapped in (("vmapped", True), ("sequential", False)):
        per_pass = []
        for _ in range(2):
            t0 = time.time()
            res = run_batch(cfg_f, sc, n_runs=n_runs,
                            control_noise=(0.2, 0.01),
                            vmapped=vmapped, collect_maps_every=4)
            per_pass.append(time.time() - t0)
        times_f[label] = per_pass
        results_f[label] = res
    pe_vf = np.stack([r.pose_err for r in results_f["vmapped"]]).mean(0)
    pe_sf = np.stack([r.pose_err for r in results_f["sequential"]]).mean(0)
    fast_probe = dict(
        n_runs=n_runs, merge_mode=1,
        wall_s_vmapped=round(times_f["vmapped"][1], 1),
        wall_s_sequential=round(times_f["sequential"][1], 1),
        wall_s_cold=dict(vmapped=round(times_f["vmapped"][0], 1),
                         sequential=round(times_f["sequential"][0], 1)),
        speedup=round(times_f["sequential"][1] / times_f["vmapped"][1], 2),
        pose_envelope_max_abs_dev_m=round(
            float(np.max(np.abs(pe_vf - pe_sf))), 4))

    _merge_json(dict(vmap=dict(
        n_runs=n_runs, steps=sc.traj.shape[0],
        wall_s_vmapped=round(times["vmapped"][1], 1),
        wall_s_sequential=round(times["sequential"][1], 1),
        wall_s_cold=dict(vmapped=round(times["vmapped"][0], 1),
                         sequential=round(times["sequential"][0], 1)),
        speedup=round(times["sequential"][1] / times["vmapped"][1], 2),
        pose_envelope_max_abs_dev_m=round(max_dev, 4),
        small_p_probe=probe,
        fast_merge_probe=fast_probe)))


def phase_merge():
    """Exact (merge_mode=0) vs fast (merge_mode=1) accuracy envelopes."""
    from phdslam_tpu.eval.batch import aggregate, run_batch
    from phdslam_tpu.eval.plots import plot_error_curves

    cfg = _base_cfg()
    sc = _scenario()
    n_runs = 6 if QUICK else 24

    aggs, labels = [], []
    out = {}
    # third arm: fast mode with the narrower top-2 selection (select_top_k
    # = 2; the pick loop is ~40% of the dense select kernel — 12.8 ->
    # 9.2 ms/step measured at the config-4 shape)
    arms = ((dict(mergeMode=0), "exact merge"),
            (dict(mergeMode=1), "fast merge"),
            (dict(mergeMode=1, selectTopK=2), "fast merge k2"))
    for repl, label in arms:
        res = run_batch(cfg.replace(**repl), sc, n_runs=n_runs,
                        control_noise=(0.2, 0.01), collect_maps_every=4)
        agg = aggregate(res)
        aggs.append(agg)
        labels.append(label)
        half = sc.traj.shape[0] // 2
        out[label.replace(" ", "_")] = dict(
            ospa_late_mean=float(np.nanmean(agg["ospa_mean"][half:])),
            ospa_late_std=float(np.nanmean(agg["ospa_std"][half:])),
            ospa_final_mean=float(agg["ospa_mean"][-1]),
            pose_late_mean=float(agg["pose_err_mean"][half:].mean()))
    plot_error_curves(aggs, "results/merge_mode_envelopes.png",
                      labels=labels)
    d = abs(out["fast_merge"]["ospa_late_mean"]
            - out["exact_merge"]["ospa_late_mean"])
    out["within_one_std"] = bool(d <= out["exact_merge"]["ospa_late_std"])
    d2 = abs(out["fast_merge_k2"]["ospa_late_mean"]
             - out["exact_merge"]["ospa_late_mean"])
    out["k2_within_one_std"] = bool(
        d2 <= out["exact_merge"]["ospa_late_std"])
    out["n_runs"] = n_runs
    _merge_json(dict(merge_modes=out))


def phase_variants():
    """PHD vs CPHD and weighting 0 vs 1 envelopes at equal particle
    counts, incl. cardinality error vs the visited-landmark truth."""
    from phdslam_tpu.eval.batch import aggregate, run_batch
    from phdslam_tpu.eval.plots import plot_error_curves

    cfg = _base_cfg()
    sc = _scenario(n_steps=40 if QUICK else 200)
    n_runs = 4 if QUICK else 20

    # base cfg is particleWeighting=0 (empty-map scheme, the cfg default);
    # the comparison arm is scheme 1 (Vo's cluster-process weighting).
    # Both filters run UNGATED births (identical birth handling) so the
    # envelopes compare the update rules, not the birth gate — gating
    # starves the map equally in either filter (measured in the round-3
    # CPHD diagnostics: gated mass 13.0 vs ungated 27.0 at step 99).
    runs = [
        ("PHD", cfg),
        ("CPHD", cfg.replace(filterType=1, maxCardinality=127)),
        ("PHD w1", cfg.replace(particleWeighting=1)),
        ("PHD w2", cfg.replace(particleWeighting=2)),
        # true carried-cardinality CPHD: the convolution predict
        # (cardinalityPredictKernel) instead of the per-step Poisson
        # rebuild — isolates what cardinality propagation buys
        ("CPHD conv", cfg.replace(filterType=1, maxCardinality=127,
                                  cnPoissonPredict=False)),
    ]
    aggs, labels, out = [], [], {}
    for label, c in runs:
        res = run_batch(c, sc, n_runs=n_runs, control_noise=(0.2, 0.01),
                        collect_maps_every=4)
        agg = aggregate(res)
        aggs.append(agg)
        labels.append(label)
        half = sc.traj.shape[0] // 2
        entry = dict(
            ospa_late_mean=float(np.nanmean(agg["ospa_mean"][half:])),
            ospa_late_std=float(np.nanmean(agg["ospa_std"][half:])),
            pose_late_mean=float(agg["pose_err_mean"][half:].mean()))
        if "card_err_mean" in agg:
            entry.update(
                card_err_late_mean=float(agg["card_err_mean"][half:].mean()),
                card_err_final=float(agg["card_err_mean"][-1]),
                visited_final=float(agg["card_true"][-1]))
        out[label.replace(" ", "_")] = entry
    plot_error_curves(aggs, "results/variant_envelopes.png", labels=labels)
    out["n_runs"] = n_runs
    out["steps"] = sc.traj.shape[0]
    _merge_json(dict(variants=out))


def phase_parity():
    """Config-2 statistical parity: JAX engine vs reference_cpu.py at the
    SAME config and particle count, >=20 seeds, overlaid envelopes."""
    from phdslam_tpu import reference_cpu as R
    from phdslam_tpu.eval.batch import aggregate, run_batch
    from phdslam_tpu.eval.plots import plot_error_curves
    from phdslam_tpu.simdata import generate_run

    cfg = _base_cfg().replace(n_particles=64)
    sc = _scenario(n_steps=40 if QUICK else 150)
    n_runs = 3 if QUICK else 20
    t_len = sc.traj.shape[0]

    res_engine = run_batch(cfg, sc, n_runs=n_runs, control_noise=(0.2, 0.01),
                        collect_maps_every=0)
    agg_engine = aggregate(res_engine)

    cfg_cpu = cfg.replace(x0=float(sc.traj[0, 0]), y0=float(sc.traj[0, 1]),
                          yaw0=float(sc.traj[0, 2]))
    pe_cpu = []
    cpu_ms = []
    for run in range(n_runs):
        rng = np.random.default_rng(0 + 1000 * run)   # run_batch seeding
        controls, meas = generate_run(rng, sc, (0.2, 0.01))
        t0 = time.time()
        poses = R.run(cfg_cpu, controls[: t_len - 1], meas[:t_len],
                      seed=run)
        cpu_ms.append((time.time() - t0) / t_len * 1000)
        pe_cpu.append(np.linalg.norm(
            poses[:, :2] - sc.traj[:t_len, :2], axis=1))
    pe_cpu = np.stack(pe_cpu)
    agg_cpu = dict(pose_err_mean=pe_cpu.mean(0), pose_err_std=pe_cpu.std(0))

    plot_error_curves([agg_engine, agg_cpu], "results/parity_envelopes.png",
                      labels=["JAX engine", "CPU reference (f64)"])
    half = t_len // 2
    m_t = float(agg_engine["pose_err_mean"][half:].mean())
    m_c = float(agg_cpu["pose_err_mean"][half:].mean())
    s_c = float(agg_cpu["pose_err_std"][half:].mean())
    _merge_json(dict(parity_config2=dict(
        n_runs=n_runs, steps=t_len, n_particles=64,
        engine_pose_late_mean=round(m_t, 3),
        cpu_pose_late_mean=round(m_c, 3),
        cpu_pose_late_std=round(s_c, 3),
        within_one_std=bool(abs(m_t - m_c) <= s_c),
        cpu_ms_per_step=round(float(np.mean(cpu_ms)), 1))))


def phase_cphd_cpu():
    """CPU CPHD oracle: ms/step denominator + pose/cardinality parity at
    a common small shape (linear-in-P extrapolation like config 1/2)."""
    from phdslam_tpu import reference_cpu as R
    from phdslam_tpu.eval.batch import run_batch, visited_landmarks
    from phdslam_tpu.simdata import generate_run

    n_p = 16
    cfg = _base_cfg().replace(
        n_particles=n_p, filterType=1, maxCardinality=127)
    sc = _scenario(n_steps=30 if QUICK else 100)
    t_len = sc.traj.shape[0]
    cfg_cpu = cfg.replace(x0=float(sc.traj[0, 0]), y0=float(sc.traj[0, 1]),
                          yaw0=float(sc.traj[0, 2]))

    controls, meas = generate_run(np.random.default_rng(0), sc,
                                  (0.2, 0.01))
    snap = {}

    def cb(t, slam):
        # total-map cardinality estimate = MAP particle's intensity mass
        # (same semantics as RunResult.card_est on the JAX side)
        i = int(np.argmax([p.log_weight for p in slam.particles]))
        snap[t] = slam.particles[i].w.sum()

    t0 = time.time()
    poses = R.run(cfg_cpu, controls[: t_len - 1], meas[:t_len], seed=0,
                  callback=cb)
    cpu_ms = (time.time() - t0) / t_len * 1000
    pe = np.linalg.norm(poses[:, :2] - sc.traj[:t_len, :2], axis=1)
    visited = len(visited_landmarks(sc)[t_len - 1])

    res = run_batch(cfg, sc, n_runs=1, control_noise=(0.2, 0.01),
                    collect_maps_every=4)
    r = res[0]
    _merge_json(dict(cphd_cpu_oracle=dict(
        n_particles=n_p, steps=t_len,
        cpu_ms_per_step=round(cpu_ms, 1),
        cpu_pose_mean=round(float(pe.mean()), 3),
        cpu_card_final=round(float(snap[max(snap)]), 2),
        engine_pose_mean=round(float(r.pose_err.mean()), 3),
        engine_card_final=round(float(r.card_est[-1]), 2)
        if r.card_est is not None else None,
        visited_final=visited)))


PHASES = dict(vmap=phase_vmap, merge=phase_merge, variants=phase_variants,
              parity=phase_parity, cphd_cpu=phase_cphd_cpu)


def main():
    names = [a for a in sys.argv[1:] if not a.startswith("-")]
    if not names:
        names = list(PHASES)
    from phdslam_tpu.utils import configure_compile_cache
    configure_compile_cache()
    for n in names:
        print(f"=== phase {n} ===", flush=True)
        PHASES[n]()


if __name__ == "__main__":
    main()

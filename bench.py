"""Benchmark: dense-stress GM-PHD SLAM step on the GPU.

BASELINE.md primary metric: ms per SLAM step & particle-updates/sec at 8192
particles (dense config: 512 padded map components, clutter-heavy scene),
compared against the CPU reference path (reference_cpu.py — the faithful
NumPy implementation of the reference algorithm; the reference repo's own
CPU path, scphd_cpu.cpp, is an empty stub).

Prints ONE JSON line:
  {"metric": "ms_per_slam_step_8192p", "value": <ms>, "unit": "ms",
   "vs_baseline": <speedup over CPU reference, extrapolated to 8192p>,
   "device": {"platform", "kind", "count"}, ...}

Exits non-zero when JAX finds no GPU.
"""

import json
import os
import sys
import time

import numpy as np


def make_stress_inputs(cfg, n_steps, seed=0):
    """Clutter-heavy measurement stream + wandering controls."""
    rng = np.random.default_rng(seed)
    m = cfg.maxMeasurements
    rb = np.zeros((n_steps, m, 2), np.float32)
    valid = np.zeros((n_steps, m), bool)
    k = int(m * 0.9)
    rb[:, :k, 0] = rng.uniform(0.5, cfg.maxRange, (n_steps, k))
    rb[:, :k, 1] = rng.uniform(-cfg.maxBearing, cfg.maxBearing, (n_steps, k))
    valid[:, :k] = True
    controls = np.zeros((n_steps, 2), np.float32)
    controls[:, 0] = 1.5
    controls[:, 1] = 0.1 * np.sin(np.arange(n_steps) / 10.0)
    return rb, valid, controls


def _make_runner(cfg, n_steps, warmup):
    """Warmed-up closure: run one timed window, return ms/step."""
    import jax
    import jax.numpy as jnp

    from phdslam_tpu.filter.state import Measurements, SlamState
    from phdslam_tpu.filter.step import slam_step

    rb, valid, controls = make_stress_inputs(cfg, n_steps)
    state = SlamState.create(cfg)
    key = jax.random.PRNGKey(0)
    labels = jnp.zeros((cfg.maxMeasurements,), jnp.int32)

    def one(state, key, t):
        z = Measurements(rb=jnp.asarray(rb[t]), label=labels,
                         valid=jnp.asarray(valid[t]))
        u = (jnp.float32(controls[t, 0]), jnp.float32(controls[t, 1]))
        return slam_step(state, key, u, z, jnp.float32(cfg.dt),
                         jnp.asarray(t > 0), cfg)

    # warmup (compile + map fill-in)
    box = {"state": state, "key": key}
    for t in range(warmup):
        box["key"], sk = jax.random.split(box["key"])
        box["state"], aux = one(box["state"], sk, t)
    jax.block_until_ready(box["state"])
    # snapshot the warmed state: every window replays the SAME work from
    # this state (not one evolving filter)
    warm = (box["state"], box["key"])

    def window():
        box["state"], box["key"] = warm
        t0 = time.perf_counter()
        for t in range(warmup, n_steps):
            box["key"], sk = jax.random.split(box["key"])
            box["state"], aux = one(box["state"], sk, t)
        jax.block_until_ready(box["state"])
        assert np.isfinite(float(aux.neff)), "NaN in benchmark run"
        return (time.perf_counter() - t0) / (n_steps - warmup) * 1000.0

    return window


def bench_many(cfgs, n_steps=19, warmup=3, n_windows=5):
    """ms/step per config, min over 5 INTERLEAVED timed windows.

    Interleaving the configs' windows samples all of them under the same
    machine state, so the relative comparison is fair even when absolute
    numbers drift. The aggregate is the per-config MINIMUM window
    (timeit's rationale: host and scheduling delays are additive noise)."""
    runners = [_make_runner(cfg, n_steps, warmup) for cfg in cfgs]
    reps = [[] for _ in cfgs]
    for _w in range(n_windows):
        for i, window in enumerate(runners):
            reps[i].append(window())
    return [float(np.min(r)) for r in reps]


def bench_one(cfg, n_steps=19, warmup=3):
    return bench_many([cfg], n_steps, warmup)[0]


def bench_cpu_reference(cfg, n_particles=32, n_steps=4,
                        anchor_path="results/dense_cpu_anchor.json"):
    """CPU reference path ms/step at a small particle count, extrapolated
    linearly in particle count (the algorithm is independent per particle).

    The measurement is PINNED: the first run on a given (config, workload)
    caches ms/step keyed by a hash of the dense config + stress-input
    parameters (results/dense_cpu_anchor.json, same pattern as
    cv_full_cpu_anchor.json); later runs reuse it, so the derived
    vs_baseline speedup no longer swings with host load. Delete the
    anchor file to force a re-measure."""
    import hashlib

    cfg_small = cfg.replace(n_particles=n_particles)
    # Key on the fields the CPU reference path actually reads (the
    # attribute set of reference_cpu.py), NOT the whole dataclass: hashing
    # the full config invalidated the anchor every time an unrelated
    # config knob was added.
    cpu_fields = (
        "a", "ax", "ay", "ayaw", "b", "beta", "birthNoiseFactor",
        "birthWeight", "birthWeightDynamic", "clutterDensity",
        "clutterRate", "cnPoissonPredict", "covVxBirth", "covVyBirth",
        "dt", "featureModel", "filterType", "gateBirths", "gateThreshold",
        "h", "l", "labeledMeasurements", "maxBearing", "maxCardinality",
        "maxRange", "minFeatureWeight", "minRange", "minSeparation",
        "motionType", "n_particles", "particleWeighting", "pd", "ps",
        "resampleThresh", "stdAlpha", "stdAxMap", "stdAyMap", "stdBearing",
        "stdEncoder", "stdRange", "subdividePredict", "tau", "vx0", "vy0",
        "vyaw0", "x0", "y0", "yaw0", "maxFeatures", "maxMeasurements")
    key = hashlib.sha256(
        repr(([(f, getattr(cfg_small, f, None)) for f in cpu_fields],
              n_steps, "make_stress_inputs-v1-seed0")).encode()
    ).hexdigest()[:16]
    if os.path.exists(anchor_path):
        try:
            with open(anchor_path) as f:
                anchor = json.load(f)
            if anchor.get("key") == key:
                return float(anchor["ms_per_step"]), int(
                    anchor["n_particles"])
        except (ValueError, KeyError):
            pass
    from phdslam_tpu import reference_cpu as R

    rb, valid, controls = make_stress_inputs(cfg_small, n_steps + 1)
    meas = [rb[t][valid[t]] for t in range(n_steps + 1)]
    # one step of warm-in so maps are non-empty
    t0 = time.perf_counter()
    R.run(cfg_small, controls[1:], meas, seed=0)
    total = time.perf_counter() - t0
    ms = total / (n_steps + 1) * 1000.0
    try:
        os.makedirs(os.path.dirname(anchor_path), exist_ok=True)
        with open(anchor_path, "w") as f:
            json.dump({"key": key, "ms_per_step": ms,
                       "n_particles": n_particles, "n_steps": n_steps,
                       "note": "CPU reference anchor for bench.py; "
                               "delete to re-measure"}, f, indent=1)
    except OSError:
        pass
    return ms, n_particles


def dense_stress_config():
    """The headline benchmark config: the SHIPPED cfg/ackerman_synth.cfg
    defaults, scaled to the dense-stress shape. Only SHAPE and SCENE
    knobs are overridden here — merge/selection semantics (mergeMode,
    selectTopK, usePallas, mergeCompactK, ...) are whatever the shipped
    cfg says, which tests/test_bench_contract.py asserts so the headline
    can never silently drift from the shipped defaults again."""
    from phdslam_tpu.config import load_config
    return load_config("cfg/ackerman_synth.cfg").replace(
        n_particles=8192, maxFeatures=512, maxMeasurements=64,
        y0=0.0, birthWeight=1e-3, clutterRate=50.0)


#: the only fields dense_stress_config may override relative to the
#: shipped cfg — shape and scene density, never filter semantics
STRESS_OVERRIDES = ("n_particles", "maxFeatures", "maxMeasurements",
                    "y0", "birthWeight", "clutterRate",
                    "clutterDensity")   # derived from clutterRate


def device_info():
    """The device JAX runs on; exits non-zero when it is not a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"no GPU: JAX runs on {devs[0].platform}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def main():
    from phdslam_tpu.utils import configure_compile_cache
    configure_compile_cache()
    device = device_info()

    stress = dense_stress_config()
    if "--quick" in sys.argv:
        stress = stress.replace(n_particles=512, maxFeatures=128)

    # headline: the SHIPPED DEFAULT configuration — exact greedy merge
    # (merge_mode=0, reference semantics, cfg/*.cfg as shipped; also the
    # faster choice at typical shapes, RESULTS.md "profile" note). The
    # optional fast modes (merge_mode=1 prune+renormalize; select_top_k=2)
    # are reported alongside with their MC accuracy envelopes in
    # RESULTS.md. Interleaved windows -> fair relative comparison (see
    # bench_many).
    ms_exact, ms_fast, ms_fast_k2 = bench_many([
        stress,
        stress.replace(mergeMode=1),
        stress.replace(mergeMode=1, selectTopK=2)])
    cpu_ms, cpu_p = bench_cpu_reference(stress)
    cpu_ms_extrap = cpu_ms * (stress.n_particles / cpu_p)
    speedup = cpu_ms_extrap / ms_exact
    updates_per_sec = stress.n_particles / (ms_exact / 1000.0)

    print(json.dumps({
        "metric": f"ms_per_slam_step_{stress.n_particles}p",
        "device": device,
        "value": round(ms_exact, 3),
        "unit": "ms",
        "vs_baseline": round(speedup, 2),
        "particle_updates_per_sec": round(updates_per_sec),
        "ms_fast_merge": round(ms_fast, 3),
        "ms_fast_k2": round(ms_fast_k2, 3),
        "cpu_reference_ms_extrapolated": round(cpu_ms_extrap, 1),
    }))


if __name__ == "__main__":
    main()

"""Smoke test of the SLAM system on one NVIDIA GPU.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the sharded paths only

One process drives the card. Phases, each printing its own lines:

  device     the card (name, power limit), JAX version, XLA_FLAGS and the
             compile-cache directory; exits non-zero unless JAX runs on a GPU
  cli        the runner in-process on the committed seed dataset
             (data/ackerman_synth): loop mode for 60 steps, then scan mode
             for the whole run; the log contract and the mean pose error
             against the dataset's truth
  kernels    both Triton kernels, compiled for the card, against the plain
             XLA computation at the dense widths (P=8192, F=512, M=64; merge
             pool [8192, 1088] -> 512)
  dense      the 8192 x 512 x 64 SLAM step with the kernels on and off,
             exact and fast merge: ms/step, memory, kernel-on vs kernel-off
  families   one short run of CPHD, mixed, FastSLAM and disparity at their
             shipped sizes, and one vmapped Monte-Carlo batch
  gpu-tests  the pytest tests marked `gpu`, in this process

--four runs only the sharded paths on four cards: `sharded_run_scan` at
65 536 particles x 128 features against `run_scan` on one card, and the
island step over four islands.

Any failure ends the run with a non-zero exit. The last line is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "smoke_out")
SEED_CFG = os.path.join(ROOT, "cfg", "ackerman_synth.cfg")
SEED_DATA = os.path.join(ROOT, "data", "ackerman_synth")

# Mean pose error bounds (m) for the cli phase. The same seed on the CPU
# gives 0.351 m over the 60 loop steps and 0.571 m over the 331-step scan;
# the bounds are about twice that, since the card's float differences
# change which particles resampling keeps.
LOOP_POSE_BOUND = 0.75
SCAN_POSE_BOUND = 1.2

# Tolerances of the kernel checks:
#  - sum_exp: Triton's exp and its reduction order differ from XLA's; the
#    absolute floor is far below clutterDensity + birthWeight, which every
#    normalizer adds to it.
SUM_RTOL, SUM_ATOL = 1e-5, 1e-12
#  - selected weights: the same exp error. Rows where the pick set is not
#    determined to this precision (a near-tie at the k1-th pick, or a
#    weight at the prune threshold) are counted and left out.
W_RTOL, W_ATOL = 1e-5, 1e-12
AMBIGUOUS_REL = 1e-5
#  - selected payloads, compared as weight-weighted sums over the k1 picks
#    because near-ties can swap the order of picks.
PAYLOAD_RTOL, PAYLOAD_ATOL = 2e-4, 1e-6
#  - merge outputs: the kernel takes centred one-pass moments where XLA
#    takes two passes.
MERGE_RTOL, MERGE_ATOL = 1e-5, 1e-5


@contextlib.contextmanager
def phase(name):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== {name} ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def block_time(f, *args, reps=5):
    """Median wall ms of f(*args) to block_until_ready (after one call)."""
    import jax

    jax.block_until_ready(f(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        times.append((time.perf_counter() - t0) * 1000.0)
    return float(np.median(times))


# ---------------------------------------------------------------- device


def phase_device():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU, JAX runs on "
                         f"{devs[0].platform}")
    from phdslam_tpu.utils import configure_compile_cache

    cache = configure_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    print(f"device: {devs[0].device_kind} x {len(devs)}, "
          f"jax {jax.__version__}")
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"compile cache: {cache}")
    print(f"nvidia-smi: {card.strip()}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


# ------------------------------------------------------------------- cli


def pose_error(poses, truth):
    n = min(len(poses), len(truth))
    return float(np.linalg.norm(np.asarray(poses)[:n, :2] - truth[:n, :2],
                                axis=1).mean())


def check_logs(out_dir, n_steps):
    import glob

    logs = glob.glob(os.path.join(out_dir, "state_estimate*.log"))
    assert len(logs) == n_steps, (out_dir, len(logs), n_steps)
    with open(os.path.join(out_dir, "loopTime.log")) as f:
        assert len(f.read().split()) == n_steps
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        assert len(f.readlines()) == n_steps


def phase_cli(out_root=OUT, loop_steps=60, scan_steps=0,
              loop_bound=LOOP_POSE_BOUND, scan_bound=SCAN_POSE_BOUND):
    """Loop mode for loop_steps, then scan mode (scan_steps, 0 = the whole
    dataset), through phdslam_tpu.runner.main on the seed cfg."""
    from phdslam_tpu import runner
    from phdslam_tpu.io.loaders import load_trajectory

    truth = load_trajectory(os.path.join(SEED_DATA, "traj.txt"))
    loop_dir = os.path.join(out_root, "cli_loop")
    res = runner.main([SEED_CFG, "synth", "--out-dir", loop_dir,
                       "--n-steps", str(loop_steps)])
    check_logs(loop_dir, loop_steps)
    err_loop = pose_error(res["poses"], truth)
    print(f"loop: {loop_steps} steps, mean pose error {err_loop:.3f} m "
          f"(bound {loop_bound})")
    scan_dir = os.path.join(out_root, "cli_scan")
    argv = [SEED_CFG, "synth", "--mode", "scan", "--out-dir", scan_dir]
    if scan_steps:
        argv += ["--n-steps", str(scan_steps)]
    res = runner.main(argv)
    n_scan = len(res["poses"])
    assert res["nan_step"] is None, res["nan_step"]
    check_logs(scan_dir, n_scan)
    err_scan = pose_error(res["poses"], truth)
    print(f"scan: {n_scan} steps, mean pose error {err_scan:.3f} m "
          f"(bound {scan_bound}), {res['ms_per_step']:.2f} ms/step")
    assert err_loop < loop_bound and err_scan < scan_bound, \
        (err_loop, err_scan)
    return err_loop, err_scan


# --------------------------------------------------------------- kernels


def select_problem(P, F, M, seed=0):
    """A random 2-D map and measurement set, in the dense config's scene
    (features and measurements inside the sensor's range)."""
    import jax.numpy as jnp

    import bench
    from phdslam_tpu.filter.state import Gaussian2DMixture
    from phdslam_tpu.filter.update import kalman_preupdate

    rng = np.random.default_rng(seed)
    cfg = bench.dense_stress_config().replace(
        n_particles=P, maxFeatures=F, maxMeasurements=M, gateBirths=True,
        gateThreshold=9.0)
    w = (rng.uniform(size=(P, F)) < 0.4) * rng.uniform(0.1, 1.0, (P, F))
    mean = rng.uniform(-8, 8, (P, F, 2))
    cov = np.broadcast_to(np.eye(2) * 0.2, (P, F, 2, 2))
    gm = Gaussian2DMixture.from_arrays(
        jnp.asarray(w, jnp.float32), jnp.asarray(mean, jnp.float32),
        jnp.asarray(cov, jnp.float32))
    pose = jnp.asarray(rng.uniform(-1, 1, (P, 6)), jnp.float32)
    z_rb = jnp.asarray(np.stack([rng.uniform(0.5, 9.0, M),
                                 rng.uniform(-1.0, 1.0, M)], 1), jnp.float32)
    return cfg, gm, kalman_preupdate(pose, gm, cfg), z_rb


def compare_select(got, ref_ext, k1, min_weight, raw):
    """Kernel outputs against select_reference(k1 + 1) (the extra pick
    tells which rows are ambiguous). Returns the ambiguous-row count."""
    g = [np.asarray(a) for a in got]
    r = [np.asarray(a) for a in ref_ext]
    np.testing.assert_allclose(g[0], r[0], rtol=SUM_RTOL, atol=SUM_ATOL,
                               err_msg="sum_exp")
    np.testing.assert_array_equal(g[8], r[8], err_msg="compat")
    w_next = r[1][..., k1]
    r = [a[..., :k1] if a.ndim == 3 else a for a in r]
    wk = r[1][..., k1 - 1]
    amb = (wk > 0) & (np.abs(wk - w_next) <= AMBIGUOUS_REL * wk)
    if not raw:
        near = lambda w: np.any(
            np.abs(w - min_weight) <= AMBIGUOUS_REL * min_weight, axis=-1)
        amb |= near(g[1]) | near(r[1])
    ok = ~amb
    np.testing.assert_allclose(np.sort(g[1], -1)[ok], np.sort(r[1], -1)[ok],
                               rtol=W_RTOL, atol=W_ATOL, err_msg="w_sel")
    for i, name in ((2, "mx"), (3, "my"), (4, "u00"), (5, "u01"),
                    (6, "u11")):
        np.testing.assert_allclose(
            np.sum(g[1] * g[i], -1)[ok], np.sum(r[1] * r[i], -1)[ok],
            rtol=PAYLOAD_RTOL, atol=PAYLOAD_ATOL, err_msg=name)
    return int(amb.sum())


def check_select(P, F, M, k1, raw, n_valid=None, interpret=False, seed=0):
    """The compiled (or interpreted) select against select_reference.
    Returns (ambiguous rows, kernel ms, XLA ms); times only when
    compiled."""
    import jax
    import jax.numpy as jnp

    from phdslam_tpu.kernels.preupdate_pallas import (fused_update_select,
                                                      select_reference)

    cfg, gm, pre, z_rb = select_problem(P, F, M, seed)
    nv = None if n_valid is None else jnp.int32(n_valid)
    kern = jax.jit(lambda z, p, g, n: fused_update_select(
        z, p, g, cfg, k1=k1, raw=raw, n_valid=n, with_compat=True,
        interpret=interpret))
    ref = jax.jit(lambda z, p, g, n, k: select_reference(
        z, p, g, cfg, k1=k, raw=raw, n_valid=n, with_compat=True),
        static_argnums=4)
    got = kern(z_rb, pre, gm, nv)
    amb = compare_select(got, ref(z_rb, pre, gm, nv, k1 + 1), k1,
                         cfg.minFeatureWeight, raw)
    if n_valid is not None:
        assert not np.asarray(got[0])[:, n_valid:].any()
        assert not np.asarray(got[1])[:, n_valid:].any()
    if interpret:
        return amb, None, None
    return (amb, block_time(kern, z_rb, pre, gm, nv),
            block_time(lambda *a: ref(*a, k1), z_rb, pre, gm, nv))


def merge_problem(P, K, seed=0):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    w = (rng.uniform(size=(P, K)) < 0.6) * rng.uniform(0.01, 2.0, (P, K))
    mx = rng.uniform(-20, 20, (P, K))
    my = rng.uniform(-20, 20, (P, K))
    c00 = rng.uniform(0.05, 1.5, (P, K))
    c11 = rng.uniform(0.05, 1.5, (P, K))
    c01 = 0.4 * np.sqrt(c00 * c11) * rng.uniform(-1, 1, (P, K))
    return [jnp.asarray(a, jnp.float32) for a in (w, mx, my, c00, c01, c11)]


def compare_merge(got, ref):
    """Slot by slot, in pick order: both make the same greedy picks with
    first-index tie-breaking. (Sorting slots by weight would reorder
    clusters whose summed weights differ in the last bit.)"""
    for name, a, b in zip(("w", "mx", "my", "c00", "c01", "c11"), got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=MERGE_RTOL, atol=MERGE_ATOL,
                                   err_msg=name)


def check_merge(P, K, cap, metric, interpret=False, seed=0):
    """The compiled (or interpreted) merge against the XLA merge. Returns
    (kernel ms, XLA ms); times only when compiled."""
    import jax

    from phdslam_tpu.kernels.merge_pallas import greedy_merge_pallas
    from phdslam_tpu.ops.gm import greedy_merge_channels

    sep = 4.0 if metric == 0 else 0.6
    args = merge_problem(P, K, seed)
    kern = jax.jit(lambda *a: greedy_merge_pallas(
        *a, sep, cap, metric=metric, interpret=interpret))
    ref = jax.jit(lambda *a: greedy_merge_channels(*a, sep, cap,
                                                   metric=metric))
    got = kern(*args)
    compare_merge(got, ref(*args))
    full = int((np.asarray(got[0]) > 0).all(axis=1).sum())
    print(f"  merge [{P}, {K}] -> {cap} metric {metric}: parity ok, "
          f"{full} rows filled all {cap} slots")
    if interpret:
        return None, None
    return block_time(kern, *args), block_time(ref, *args)


def phase_kernels(P=8192, F=512, M=64, K=1088, cap=512, interpret=False):
    for k1 in (4, 8):
        for raw in (False, True):
            for n_valid in (None, M // 2 + 3):
                amb, tk, tx = check_select(P, F, M, k1, raw, n_valid,
                                           interpret)
                times = "" if tk is None else \
                    f", kernel {tk:.3f} ms vs XLA {tx:.3f} ms"
                print(f"  select P={P} F={F} M={M} k1={k1} raw={raw} "
                      f"n_valid={n_valid}: parity ok, {amb} ambiguous "
                      f"rows{times}")
    for metric in (0, 1):
        tk, tx = check_merge(P, K, cap, metric, interpret)
        if tk is not None:
            print(f"  merge metric {metric}: kernel {tk:.3f} ms vs XLA "
                  f"{tx:.3f} ms")


# ----------------------------------------------------------------- dense


def dense_inputs(cfg, t):
    import jax.numpy as jnp

    import bench
    from phdslam_tpu.filter.state import Measurements

    rb, valid, controls = bench.make_stress_inputs(cfg, t + 1)
    z = Measurements(rb=jnp.asarray(rb[t]),
                     label=jnp.zeros((cfg.maxMeasurements,), jnp.int32),
                     valid=jnp.asarray(valid[t]))
    u = (jnp.float32(controls[t, 0]), jnp.float32(controls[t, 1]))
    return z, u


def compiled_step(cfg, state, key, z, u):
    import jax
    import jax.numpy as jnp

    from phdslam_tpu.filter.step import slam_step

    dt = jnp.float32(cfg.dt)
    return slam_step.lower(state, key, u, z, dt, jnp.asarray(True),
                           cfg=cfg).compile()


def run_steps(cfg, state, key, t0, n, compiled=None):
    """n steps of the dense stream from t0; returns (state, key, aux,
    compiled step, ms/step)."""
    import jax
    import jax.numpy as jnp

    dt = jnp.float32(cfg.dt)
    inputs = [dense_inputs(cfg, t) for t in range(t0, t0 + n)]
    if compiled is None:
        compiled = compiled_step(cfg, state, key, *inputs[0])
    start = time.perf_counter()
    for t, (z, u) in zip(range(t0, t0 + n), inputs):
        key, sk = jax.random.split(key)
        state, aux = compiled(state, sk, u, z, dt, jnp.asarray(t > 0))
    jax.block_until_ready(state)
    return state, key, aux, compiled, \
        (time.perf_counter() - start) / n * 1000.0


def check_step_match(aux_a, aux_b, what):
    """Kernel-on vs kernel-off outputs of one step from the same state:
    the pre-resampling expected pose, log-likelihood and nEff."""
    ea, eb = np.asarray(aux_a.expected_pose), np.asarray(aux_b.expected_pose)
    la, lb = float(aux_a.log_lik), float(aux_b.log_lik)
    na, nb = float(aux_a.neff), float(aux_b.neff)
    print(f"  {what}: log_lik {la!r} vs {lb!r}, neff {na!r} vs {nb!r}, "
          f"|d pose| {np.abs(ea - eb).max():.3g}")
    np.testing.assert_allclose(ea, eb, atol=1e-3, err_msg=what)
    np.testing.assert_allclose(la, lb, rtol=1e-4, atol=1e-3, err_msg=what)
    np.testing.assert_allclose(na, nb, rtol=1e-3, atol=1e-6, err_msg=what)


def check_state(state, what):
    lw = np.asarray(state.log_weights)
    w = np.asarray(state.map_static.w)
    assert np.isfinite(lw).all() and np.isfinite(w).all(), what
    assert np.isfinite(np.asarray(state.pose)).all(), what
    total = float(np.exp(lw.astype(np.float64)).sum())
    assert abs(total - 1.0) < 1e-3, (what, total)


def phase_dense(P=8192, F=512, M=64, warmup=3, steps=5, interpret=False):
    """interpret runs the kernels in interpret mode (the CPU rehearsal)."""
    import jax

    import bench
    from phdslam_tpu.filter.state import SlamState

    base = bench.dense_stress_config().replace(
        n_particles=P, maxFeatures=F, maxMeasurements=M,
        pallasInterpret=interpret)
    dev = jax.devices()[0]
    for merge_mode in (0, 1):
        steppers = []
        for use in (True, False):
            cfg = base.replace(mergeMode=merge_mode, usePallas=use)
            what = f"merge_mode={merge_mode} kernels={'on' if use else 'off'}"
            t0 = time.perf_counter()
            state, key, _, comp, _ = run_steps(
                cfg, SlamState.create(cfg), jax.random.PRNGKey(0), 0,
                warmup)
            setup = time.perf_counter() - t0
            if use:
                warm = (state, key)
            state, key, aux, comp, ms = run_steps(cfg, state, key, warmup,
                                                  steps, comp)
            check_state(state, what)
            calls = kernel_shapes(comp.as_text())
            assert bool(calls) == (use and not interpret), (what, calls)
            mem = comp.memory_analysis()
            peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
            print(f"  {what}: {ms:.3f} ms/step (compile + {warmup} warmup "
                  f"steps {setup:.1f} s); {len(calls)} kernel calls; temp "
                  f"{getattr(mem, 'temp_size_in_bytes', -1)} B, args "
                  f"{getattr(mem, 'argument_size_in_bytes', -1)} B; peak "
                  f"in use {peak} B")
            steppers.append((cfg, comp))
        # one step from the same warmed state, kernels on and off
        outs = [run_steps(cfg, *warm, warmup, 1, comp)[2]
                for cfg, comp in steppers]
        check_step_match(outs[0], outs[1],
                         f"dense merge_mode={merge_mode} on vs off")


# -------------------------------------------------------------- families


def seed_measurements(cfg, n):
    """The first n steps of the seed dataset as padded Measurements and
    the lockstep controls (measurement t with control t - 1)."""
    import jax.numpy as jnp

    from phdslam_tpu.filter.state import Measurements
    from phdslam_tpu.io import loaders

    sets = loaders.load_measurements(os.path.join(SEED_DATA,
                                                  "measurements.txt"))
    ctrl = loaders.load_controls(os.path.join(SEED_DATA, "controls.txt"))
    rb, lab, val = loaders.pad_measurement_sets(sets[:n],
                                                cfg.maxMeasurements)
    zs = [Measurements(rb=jnp.asarray(rb[t]), label=jnp.asarray(lab[t]),
                       valid=jnp.asarray(val[t])) for t in range(n)]
    us = [(jnp.float32(0), jnp.float32(0)) if t == 0 else
          (jnp.float32(ctrl[t - 1][0]), jnp.float32(ctrl[t - 1][1]))
          for t in range(n)]
    return zs, us


def family_run(cfg, n_steps, compare):
    """n_steps of slam_step on the seed data with the kernels on; when
    compare, every step is also taken with the kernels off from the same
    state and the two are checked against each other."""
    import jax
    import jax.numpy as jnp

    from phdslam_tpu.filter.state import SlamState
    from phdslam_tpu.filter.step import slam_step

    zs, us = seed_measurements(cfg, n_steps)
    off = cfg.replace(usePallas=False)
    state = SlamState.create(cfg)
    key = jax.random.PRNGKey(0)
    z_prev = None
    dt = jnp.float32(cfg.dt)
    for t in range(n_steps):
        key, sk = jax.random.split(key)
        args = (state, sk, us[t], zs[t], dt, jnp.asarray(t > 0))
        new, aux = slam_step(*args, cfg, z_prev=z_prev)
        if compare:
            _, aux_off = slam_step(*args, off, z_prev=z_prev)
            check_step_match(aux, aux_off, f"step {t}")
        state, z_prev = new, zs[t]
    check_state(state, "family")
    return state


def phase_families(out_root=OUT, n_steps=4, batch_steps=4):
    from phdslam_tpu import runner
    from phdslam_tpu.config import load_config
    from phdslam_tpu.eval.batch import run_batch
    from phdslam_tpu.simdata import make_scenario

    ack = load_config(SEED_CFG)
    for name, cfg, compare in (
            ("cphd", ack.replace(filterType=1), True),
            ("mixed", load_config(os.path.join(ROOT, "cfg",
                                               "mixed_synth.cfg")), True),
            ("fastslam", load_config(os.path.join(ROOT, "cfg",
                                                  "fastslam_synth.cfg")),
             False)):
        t0 = time.perf_counter()
        family_run(cfg, n_steps, compare)
        print(f"  {name}: {n_steps} steps at P={cfg.n_particles} "
              f"F={cfg.maxFeatures} M={cfg.maxMeasurements} finite"
              f"{', kernels on = off' if compare else ''} "
              f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    res = runner.main([os.path.join(ROOT, "cfg", "disparity_synth.cfg"),
                       "disparity", "--n-steps", str(n_steps), "--no-logs",
                       "--out-dir", os.path.join(out_root, "disparity")])
    assert np.isfinite(np.asarray(res["poses"])).all()
    print(f"  disparity: {n_steps} steps finite "
          f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    scenario = make_scenario(np.random.default_rng(0), n_steps=batch_steps)
    results = run_batch(ack, scenario, n_runs=2, vmapped=True,
                        collect_maps_every=0)
    assert all(np.isfinite(r.poses).all() for r in results)
    print(f"  vmapped batch: 2 runs x {batch_steps} steps finite "
          f"({time.perf_counter() - t0:.1f} s)")


# ------------------------------------------------------------- gpu-tests


class _Outcomes:
    """pytest plugin: counts test outcomes."""

    def __init__(self):
        self.counts = {}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome == "skipped":
            self.counts[report.outcome] = \
                self.counts.get(report.outcome, 0) + 1


def phase_gpu_tests():
    import pytest

    outcomes = _Outcomes()
    rc = pytest.main([os.path.join(ROOT, "tests"), "-m", "gpu", "-q",
                      "-p", "no:cacheprovider"], plugins=[outcomes])
    print(f"  gpu tests: {outcomes.counts}, exit {int(rc)}")
    assert rc == 0 and outcomes.counts.get("passed", 0) > 0 \
        and not outcomes.counts.get("skipped"), outcomes.counts


# ------------------------------------------------------------------ four


def kernel_shapes(hlo_text):
    """Result shapes of the Triton kernel calls in compiled HLO text (the
    operands there are names without shapes)."""
    return [line.split(" = ", 1)[1].split(" custom-call(")[0]
            for line in hlo_text.splitlines()
            if "__gpu$xla.gpu.triton" in line and " custom-call(" in line]


def run_four(P=65536, F=128, steps=20, n_dev=4, interpret=False):
    """sharded_run_scan over n_dev devices against run_scan on one, from
    the same key; then the island step. interpret runs the kernels in
    interpret mode (the CPU rehearsal on virtual devices)."""
    import jax
    import jax.numpy as jnp

    from phdslam_tpu.config import load_config
    from phdslam_tpu.filter.state import Measurements, SlamState
    from phdslam_tpu.filter.step import run_scan
    from phdslam_tpu.parallel.island import (island_slam_step,
                                             make_island_mesh)
    from phdslam_tpu.parallel.mesh import (make_mesh, sharded_run_scan,
                                           shard_state)

    cfg = load_config(SEED_CFG).replace(n_particles=P, maxFeatures=F,
                                        pallasInterpret=interpret)
    zl, ul = seed_measurements(cfg, steps)
    zs = jax.tree.map(lambda *a: jnp.stack(a), *zl)
    ctrl = jnp.asarray([[float(u[0]), float(u[1])] for u in ul])
    dts = jnp.full((steps,), cfg.dt, jnp.float32)
    key = jax.random.PRNGKey(0)

    mesh = make_mesh(n_dev)
    run = sharded_run_scan(cfg, mesh)
    state0 = SlamState.create(cfg)
    if not interpret:
        hlo = run.lower(shard_state(state0, mesh), key, ctrl, zs,
                        dts).compile().as_text()
        shapes = kernel_shapes(hlo)
        local = f"[{P // n_dev},"
        assert shapes and all(local in s for s in shapes) \
            and not any(f"[{P}," in s for s in shapes), shapes[:4]
        print(f"  {len(shapes)} kernel calls, all with per-shard results "
              f"{local}...]")
    t0 = time.perf_counter()
    final4, aux4 = run(shard_state(state0, mesh), key, ctrl, zs, dts)
    jax.block_until_ready(final4)
    t4 = time.perf_counter() - t0
    t0 = time.perf_counter()
    final1, aux1 = run_scan(SlamState.create(cfg), key, ctrl, zs, dts, cfg,
                            steps)
    jax.block_until_ready(final1)
    t1 = time.perf_counter() - t0
    e4, e1 = np.asarray(aux4.expected_pose), np.asarray(aux1.expected_pose)
    l4, l1 = np.asarray(aux4.log_lik), np.asarray(aux1.log_lik)
    print(f"  sharded_run_scan {n_dev} devices vs run_scan on one: "
          f"{steps} steps at P={P} F={F}; max |d pose| "
          f"{np.abs(e4 - e1).max():.3g} m, max |d log_lik| "
          f"{np.abs(l4 - l1).max():.3g}; {t4:.2f} s vs {t1:.2f} s "
          f"(compile included)")
    np.testing.assert_allclose(e4, e1, atol=0.05, err_msg="expected pose")
    np.testing.assert_allclose(l4, l1, rtol=1e-3, atol=1e-2,
                               err_msg="log_lik")
    check_state(final4, "sharded")

    imesh = make_island_mesh(n_dev)
    step, init = island_slam_step(imesh, cfg)
    state, ilw = init()
    for t in range(3):
        key, sk = jax.random.split(key)
        state, ilw, iaux = step(state, ilw, sk, ctrl[t], zl[t],
                                jnp.float32(cfg.dt), jnp.asarray(t > 0))
    assert np.isfinite(np.asarray(iaux.expected_pose)).all()
    assert np.isfinite(np.asarray(state.log_weights)).all()
    print(f"  island step: {n_dev} islands x {P // n_dev} particles, "
          f"3 steps finite")


# ------------------------------------------------------------------ main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded paths, on four cards")
    args = ap.parse_args(argv)

    with phase("device"):
        device = phase_device()
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    if args.four:
        if device["count"] < 4:
            raise SystemExit(f"chip_smoke --four: {device['count']} GPUs")
        with phase("four"):
            run_four()
    else:
        with phase("cli"):
            phase_cli()
        with phase("kernels"):
            phase_kernels()
        with phase("dense"):
            phase_dense()
        with phase("families"):
            phase_families()
        with phase("gpu-tests"):
            phase_gpu_tests()
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()

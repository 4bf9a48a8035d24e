"""The two Triton kernels (kernels/) against the plain XLA computation.

CPU tests run the kernels in Pallas interpret mode at tiny shapes. Tests
marked `gpu` run them compiled and skip without a card; chip_smoke.py runs
them on the card (its gpu-tests phase), beside its parity checks at the
dense widths.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import chip_smoke


def _problem(tiny_cfg, rng, P=7, F=24, M=6):
    from phdslam_tpu.filter.state import Gaussian2DMixture

    cfg = tiny_cfg.replace(n_particles=P, maxFeatures=F, maxMeasurements=M,
                           gateBirths=True, gateThreshold=9.0)
    w = (rng.uniform(size=(P, F)) < 0.4) * rng.uniform(0.1, 1.0, (P, F))
    mean = rng.uniform(-8, 8, (P, F, 2))
    cov = np.tile(np.eye(2, dtype=np.float32) * 0.2, (P, F, 1, 1))
    gm = Gaussian2DMixture.from_arrays(
        jnp.asarray(w, jnp.float32), jnp.asarray(mean, jnp.float32),
        jnp.asarray(cov))
    pose = jnp.asarray(rng.uniform(-1, 1, (P, 6)), jnp.float32)
    z_rb = jnp.stack([
        jnp.asarray(rng.uniform(0.5, 9.0, M), jnp.float32),
        jnp.asarray(rng.uniform(-1.0, 1.0, M), jnp.float32)], axis=1)
    z_valid = jnp.ones((M,), bool)
    return cfg, gm, pose, z_rb, z_valid


# ---------------------------------------------------------------- select


@pytest.mark.parametrize("n_valid", [None, 4])
@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("k1", [4, 8])
def test_select_interpret_matches_reference(k1, raw, n_valid):
    """Odd P, F padded 24 -> 32, M padded 6 -> 8; partial n_valid zeroes
    the trailing measurement columns."""
    chip_smoke.check_select(7, 24, 6, k1, raw, n_valid, interpret=True)


def test_select_vmapped_measurement_counts(tiny_cfg, rng):
    """Under vmap (the Monte-Carlo batch) each run's valid-measurement
    count is its own traced scalar: every run equals its unbatched call,
    and columns past its count are zeros."""
    from phdslam_tpu.filter.update import kalman_preupdate
    from phdslam_tpu.kernels.preupdate_pallas import fused_update_select

    cfg, gm, pose, z_rb, _ = _problem(tiny_cfg, rng, P=5)
    pre = kalman_preupdate(pose, gm, cfg)
    zs = jnp.stack([z_rb, z_rb[::-1]])
    nvs = jnp.asarray([3, 6], jnp.int32)
    run = lambda z, n: fused_update_select(z, pre, gm, cfg, k1=4,
                                           n_valid=n, interpret=True)
    batched = jax.jit(jax.vmap(run))(zs, nvs)
    for b in range(2):
        one = run(zs[b], nvs[b])
        for a, o in zip(batched, one):
            np.testing.assert_array_equal(np.asarray(a[b]), np.asarray(o))
    sum_exp = np.asarray(batched[0])
    assert not sum_exp[0, :, 3:].any() and sum_exp[1, :, 3:].any()


def test_select_dead_output_elision(tiny_cfg, rng):
    """with_compat/with_lpw=False skip the unused reductions: every live
    output is bit-identical, the skipped ones return their zero-fill."""
    from phdslam_tpu.filter.update import kalman_preupdate
    from phdslam_tpu.kernels.preupdate_pallas import fused_update_select

    cfg, gm, pose, z_rb, _ = _problem(tiny_cfg, rng)
    pre = kalman_preupdate(pose, gm, cfg)
    full = fused_update_select(z_rb, pre, gm, cfg, k1=4, interpret=True,
                               with_compat=True, with_lpw=True)
    skim = fused_update_select(z_rb, pre, gm, cfg, k1=4, interpret=True,
                               with_compat=False, with_lpw=False)
    for i in range(7):      # sum_exp + 6 payload channels (w..u11)
        np.testing.assert_array_equal(np.asarray(full[i]),
                                      np.asarray(skim[i]))
    assert np.asarray(full[8]).any()
    assert not np.asarray(skim[8]).any()        # compat zero-filled
    assert not np.asarray(skim[7]).any()        # lpw_sel zero-filled
    live = np.asarray(full[1]) > 0
    np.testing.assert_array_equal(np.asarray(full[7])[live] < -1e29, False)


# ----------------------------------------------------------------- merge


@pytest.mark.parametrize("metric", [0, 1])
def test_merge_interpret_matches_xla(metric):
    """Odd P and K (K padded 40 -> 64); the cap of 12 slots is reached."""
    chip_smoke.check_merge(7, 40, 12, metric, interpret=True)


@pytest.mark.parametrize("cap", [7, 33, 64])
def test_merge_interpret_caps(cap):
    """Caps below, near and above the live candidate count: the exhausted
    slots are the empty convention (weight 0, identity covariance)."""
    from phdslam_tpu.kernels.merge_pallas import greedy_merge_pallas
    from phdslam_tpu.ops.gm import greedy_merge_channels

    args = chip_smoke.merge_problem(5, 48, seed=3)
    ref = greedy_merge_channels(*args, 4.0, cap)
    got = greedy_merge_pallas(*args, 4.0, cap, interpret=True)
    chip_smoke.compare_merge(got, ref)
    w, c00, c01, c11 = (np.asarray(got[i]) for i in (0, 3, 4, 5))
    empty = w == 0
    assert (c00[empty] == 1).all() and (c11[empty] == 1).all()
    assert (c01[empty] == 0).all()
    if cap == 64:
        assert empty.any()


def test_merge_vmapped_matches_xla():
    """Under vmap (the Monte-Carlo batch) the merge kernel gains a batch
    grid axis; every run equals the XLA merge of that run."""
    from phdslam_tpu.kernels.merge_pallas import greedy_merge_pallas
    from phdslam_tpu.ops.gm import greedy_merge_channels

    runs = [chip_smoke.merge_problem(5, 40, seed=s) for s in (1, 2)]
    stacked = [jnp.stack(a) for a in zip(*runs)]
    got = jax.jit(jax.vmap(lambda *a: greedy_merge_pallas(
        *a, 4.0, 12, interpret=True)))(*stacked)
    for b, args in enumerate(runs):
        chip_smoke.compare_merge([g[b] for g in got],
                                 greedy_merge_channels(*args, 4.0, 12))


# ------------------------------------------------- updates through kernels


def _compare_updates(res_k, res_x):
    np.testing.assert_allclose(np.asarray(res_k.log_weight_delta),
                               np.asarray(res_x.log_weight_delta),
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(
        np.sort(np.asarray(res_k.map_out.w), axis=-1),
        np.sort(np.asarray(res_x.map_out.w), axis=-1),
        rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("n_valid", [3, 6])
def test_full_update_kernels_match_xla(tiny_cfg, rng, n_valid):
    """phd_update_static with the kernels (cfg.pallasInterpret, chosen by
    kernels.kernel_mode) against its XLA branch; with 3 of 6 measurement
    slots valid the kernel's measurement loop stops at the count."""
    import phdslam_tpu.filter.update as U

    cfg, gm, pose, z_rb, _ = _problem(tiny_cfg, rng)
    M = z_rb.shape[0]
    z_valid = jnp.asarray(np.arange(M) < n_valid)
    z_label = jnp.zeros((M,), jnp.int32)
    res_x = U.phd_update_static(pose, gm, z_rb, z_label, z_valid,
                                cfg.replace(usePallas=False))
    res_k = U.phd_update_static(pose, gm, z_rb, z_label, z_valid,
                                cfg.replace(pallasInterpret=True))
    _compare_updates(res_k, res_x)
    np.testing.assert_array_equal(np.asarray(res_k.det_mass)[:, n_valid:],
                                  0.0)


def test_cphd_update_kernels_match_xla(tiny_cfg, rng):
    """cphd_update's kernel branch (raw-mode select) against its XLA
    branch."""
    from phdslam_tpu.filter import cphd as C

    cfg, gm, pose, z_rb, z_valid = _problem(tiny_cfg, rng)
    cfg = cfg.replace(filterType=1, maxCardinality=31)
    consts = C.make_constants(cfg)
    ncard = cfg.maxCardinality + 1
    cn = jnp.log(jnp.full((pose.shape[0], ncard), 1.0 / ncard))
    z_label = jnp.zeros((z_rb.shape[0],), jnp.int32)
    map_x, cn_x, dw_x = C.cphd_update(pose, gm, cn, z_rb, z_label, z_valid,
                                      cfg.replace(usePallas=False), consts)
    map_k, cn_k, dw_k = C.cphd_update(pose, gm, cn, z_rb, z_label, z_valid,
                                      cfg.replace(pallasInterpret=True),
                                      consts)
    np.testing.assert_allclose(np.asarray(dw_k), np.asarray(dw_x),
                               rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(cn_k), np.asarray(cn_x),
                               rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(np.sort(np.asarray(map_k.w), axis=-1),
                               np.sort(np.asarray(map_x.w), axis=-1),
                               rtol=1e-3, atol=1e-5)


def test_mixed_update_kernels_match_xla(tiny_cfg, rng):
    """phd_update_mixed: the static half's kernel branch against the XLA
    branch (the dynamic half is XLA either way)."""
    from phdslam_tpu.filter.state import Gaussian4DMixture
    from phdslam_tpu.filter.update4 import phd_update_mixed

    cfg, gm2, pose, z_rb, z_valid = _problem(tiny_cfg, rng)
    cfg = cfg.replace(featureModel=2)
    P, F = gm2.w.shape
    F4 = F // 2
    w4 = (rng.uniform(size=(P, F4)) < 0.3) * rng.uniform(0.1, 1.0, (P, F4))
    mean4 = np.zeros((P, 4, F4), np.float32)
    mean4[:, :2] = rng.uniform(-8, 8, (P, 2, F4))
    mean4[:, 2:] = rng.uniform(-0.5, 0.5, (P, 2, F4))
    gm4 = Gaussian4DMixture(
        w=jnp.asarray(w4, jnp.float32), mean_channels=jnp.asarray(mean4),
        cov_channels=Gaussian4DMixture.empty((P,), F4).cov_channels * 0.3)
    z_label = jnp.zeros((z_rb.shape[0],), jnp.int32)
    g2x, g4x, dwx = phd_update_mixed(pose, gm2, gm4, z_rb, z_label, z_valid,
                                     cfg.replace(usePallas=False))
    g2k, g4k, dwk = phd_update_mixed(pose, gm2, gm4, z_rb, z_label, z_valid,
                                     cfg.replace(pallasInterpret=True))
    np.testing.assert_allclose(np.asarray(dwk), np.asarray(dwx),
                               rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(np.sort(np.asarray(g2k.w), axis=-1),
                               np.sort(np.asarray(g2x.w), axis=-1),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(np.asarray(g4k.w), np.asarray(g4x.w),
                               rtol=1e-3, atol=1e-5)


# -------------------------------------------------------------- dispatch


@pytest.mark.parametrize("platform,use,interpret,expect", [
    ("gpu", True, False, (True, False)),
    ("gpu", False, False, (False, False)),
    ("cpu", True, False, (False, False)),
    ("cpu", True, True, (True, True)),
    ("cpu", False, True, (False, False)),
])
def test_kernel_mode(tiny_cfg, platform, use, interpret, expect):
    from phdslam_tpu.kernels import kernel_mode

    cfg = tiny_cfg.replace(usePallas=use, pallasInterpret=interpret)
    assert kernel_mode(cfg, platform) == expect


def test_kernel_mode_refuses_interpret_on_gpu(tiny_cfg):
    from phdslam_tpu.kernels import kernel_mode

    with pytest.raises(ValueError, match="interpret"):
        kernel_mode(tiny_cfg.replace(pallasInterpret=True), "gpu")


def test_kernel_mode_defaults_to_the_process_backend(tiny_cfg):
    from phdslam_tpu.kernels import kernel_mode

    assert jax.default_backend() == "cpu"
    assert kernel_mode(tiny_cfg) == (False, False)


def test_kernel_mode_reads_the_cfg_platform(tiny_cfg):
    """cfg.kernelPlatform (a mesh's platform) wins over the process
    default backend; an explicit platform wins over both."""
    from phdslam_tpu.kernels import kernel_mode

    cfg = tiny_cfg.replace(kernelPlatform="gpu")
    assert kernel_mode(cfg) == (True, False)
    assert kernel_mode(cfg, "cpu") == (False, False)
    with pytest.raises(ValueError, match="interpret"):
        kernel_mode(cfg.replace(pallasInterpret=True))


def test_resolve_pallas_follows_the_mesh(tiny_cfg):
    from phdslam_tpu.parallel.mesh import make_mesh, resolve_pallas

    mesh = make_mesh(2)
    cfg, pmesh = resolve_pallas(tiny_cfg, mesh)
    assert pmesh is None and not cfg.usePallas
    cfg, pmesh = resolve_pallas(tiny_cfg.replace(pallasInterpret=True), mesh)
    assert pmesh is mesh and cfg.usePallas and cfg.kernelPlatform == "cpu"


def test_make_mesh_raises_without_enough_devices():
    from phdslam_tpu.parallel.mesh import make_mesh

    with pytest.raises(RuntimeError, match="devices"):
        make_mesh(len(jax.devices()) + 1)


# ----------------------------------------------------------------- cache


def test_compile_cache_honours_the_env_var(monkeypatch, tmp_path):
    from phdslam_tpu import utils

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert utils.configure_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; nothing else is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_inside_the_checkout(monkeypatch):
    import os

    from phdslam_tpu import utils

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert utils.compile_cache_dir() == os.path.join(utils.REPO_ROOT,
                                                     ".jax_cache")


# ------------------------------------------------------------------- gpu


@pytest.mark.gpu
@pytest.mark.parametrize("raw", [False, True])
def test_select_compiled_matches_reference(gpu, raw):
    chip_smoke.check_select(300, 96, 16, 8, raw, n_valid=11)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", [0, 1])
def test_merge_compiled_matches_xla(gpu, metric):
    chip_smoke.check_merge(300, 200, 64, metric)


@pytest.mark.gpu
def test_full_update_compiled_matches_xla(gpu, tiny_cfg, rng):
    import phdslam_tpu.filter.update as U

    cfg, gm, pose, z_rb, z_valid = _problem(tiny_cfg, rng, P=64, F=48, M=8)
    z_label = jnp.zeros((z_rb.shape[0],), jnp.int32)
    res_x = U.phd_update_static(pose, gm, z_rb, z_label, z_valid,
                                cfg.replace(usePallas=False))
    res_k = U.phd_update_static(pose, gm, z_rb, z_label, z_valid, cfg)
    _compare_updates(res_k, res_x)

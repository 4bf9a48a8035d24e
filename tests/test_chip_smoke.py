"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its
phases work at tiny sizes (kernels in interpret mode)."""

import json

import numpy as np
import pytest

import chip_smoke


def test_main_exits_nonzero_without_gpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_four_exits_nonzero_without_gpu():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(["--four"])
    assert exc.value.code not in (0, None)


def test_result_line_shape(monkeypatch, capsys):
    """With every phase stubbed, the last line is exactly the result
    object."""
    device = {"platform": "gpu", "kind": "H100", "count": 1}
    monkeypatch.setattr(chip_smoke, "phase_device", lambda: device)
    monkeypatch.setattr(chip_smoke, "OUT", "/nonexistent/chip_smoke")
    monkeypatch.setattr(chip_smoke.shutil, "rmtree", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke.os, "makedirs", lambda *a, **k: None)
    ran = []
    for name in ("phase_cli", "phase_kernels", "phase_dense",
                 "phase_families", "phase_gpu_tests"):
        monkeypatch.setattr(chip_smoke, name,
                            lambda name=name: ran.append(name))
    chip_smoke.main([])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": device}
    assert len(ran) == 5


def test_phase_failure_propagates(monkeypatch):
    monkeypatch.setattr(chip_smoke, "phase_device",
                        lambda: {"platform": "gpu", "kind": "x", "count": 1})
    monkeypatch.setattr(chip_smoke.shutil, "rmtree", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke.os, "makedirs", lambda *a, **k: None)

    def boom():
        raise AssertionError("phase failed")

    monkeypatch.setattr(chip_smoke, "phase_cli", boom)
    with pytest.raises(AssertionError, match="phase failed"):
        chip_smoke.main([])


def test_kernel_shapes_reads_triton_calls():
    hlo = ("  %a = f32[8] add(f32[8] %x, f32[8] %y)\n"
           "  %c = (f32[16384,64]{1,0}) custom-call(s32[1]{0} %n, "
           "f32[16384,128]{1,0} %r), custom_call_target="
           "\"__gpu$xla.gpu.triton\", backend_config={}\n")
    assert chip_smoke.kernel_shapes(hlo) == ["(f32[16384,64]{1,0})"]
    assert chip_smoke.kernel_shapes(hlo.splitlines()[0]) == []


def _select_outputs(w):
    """A fake select result around weights w [P, M, k]."""
    P, M, _ = w.shape
    zeros = np.zeros_like(w)
    return [np.ones((P, M)), w, zeros, zeros, zeros, zeros, zeros, zeros,
            np.zeros((P, M), bool)]


def test_compare_select_leaves_out_only_ambiguous_rows():
    ref = np.array([[[0.5, 0.3, 0.3 * (1 + 1e-7)],      # tie at the cut
                     [0.5, 0.3, 0.1]]])                 # clear cut
    got = np.array([[[0.5, 0.3 * (1 + 1e-7)], [0.5, 0.3]]])
    amb = chip_smoke.compare_select(_select_outputs(got),
                                    _select_outputs(ref), 2, 1e-3, raw=True)
    assert amb == 1
    bad = got.copy()
    bad[0, 1, 1] = 0.2
    with pytest.raises(AssertionError):
        chip_smoke.compare_select(_select_outputs(bad),
                                  _select_outputs(ref), 2, 1e-3, raw=True)


def test_compare_merge_is_slot_by_slot():
    ref = [np.array([[2.0, 1.0, 0.0]])] * 6
    chip_smoke.compare_merge(ref, ref)
    swapped = [np.array([[1.0, 2.0, 0.0]])] * 6
    with pytest.raises(AssertionError):
        chip_smoke.compare_merge(swapped, ref)


def test_phase_cli_tiny(tmp_path):
    err_loop, err_scan = chip_smoke.phase_cli(
        out_root=str(tmp_path), loop_steps=3, scan_steps=3,
        loop_bound=1.0, scan_bound=1.0)
    assert np.isfinite(err_loop) and np.isfinite(err_scan)


def test_phase_dense_tiny():
    chip_smoke.phase_dense(P=16, F=16, M=8, warmup=2, steps=1,
                           interpret=True)


def test_family_run_tiny(tiny_cfg):
    """The families phase's kernel-on vs kernel-off check (CPHD), with
    the kernels in interpret mode."""
    cfg = tiny_cfg.replace(filterType=1, maxCardinality=15,
                           maxMeasurements=40, pallasInterpret=True)
    state = chip_smoke.family_run(cfg, 2, compare=True)
    assert state.cardinality is not None


def test_run_four_on_virtual_devices():
    """The --four path on four virtual CPU devices: sharded_run_scan
    against run_scan on one device, then the island step."""
    chip_smoke.run_four(P=32, F=16, steps=3, n_dev=4, interpret=True)

"""chip_smoke.py's phases at tiny sizes on the CPU (the GPU run uses the
same functions at real sizes), and its refusal of any platform that is not
a GPU."""

import json

import numpy as np
import pytest

import bench
import chip_smoke


def test_refuses_a_platform_that_is_not_a_gpu(capsys):
    assert chip_smoke.main([]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "needs a GPU" in err


def test_bench_refuses_a_platform_that_is_not_a_gpu(capsys):
    assert bench.main([]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("backend", ["auto", "interpret"])
def test_render_phase(backend, capsys):
    rec = chip_smoke.phase_render(24, 16, compare=True, backend=backend)
    assert rec["vs_reference"]["ok"]
    assert json.loads(capsys.readouterr().out)["phase"] == "render"


def test_depth_goldens_phase():
    assert chip_smoke.phase_depth_goldens(backend="interpret")[
        "max_rel_err"] <= 1e-4


def test_grad_and_parity_phases():
    assert chip_smoke.phase_grad(16, 12)["grad_abs_max"] > 0
    rec = chip_smoke.phase_grad_parity(16, 12, iterations=4, bound=2.0)
    assert rec["max_rel_err"] <= 2.0 * rec["noise_floor"]


def test_fit_phase():
    rec = chip_smoke.phase_fit(24, 16, steps=2)
    assert len(rec["losses"]) == 2 and rec["first_loss_rel_err"] <= 5e-2


def test_mesh_phase_matches_sequential_baseline():
    rec = chip_smoke.phase_mesh(24, compare=True)
    assert rec["vertices"] == rec["baseline_vertices"] > 0


def test_icp_phase_with_grid_nn_check():
    rec = chip_smoke.phase_icp(60_000, nn_check_queries=500)
    assert rec["max_alignment_err"] <= 1e-3


def test_image_agreement_contract():
    ref = np.zeros((10, 100, 3), np.float32)
    img = ref.copy()
    img[0, 0] = 1.0  # one flipped pixel in 1000: within 0.1 %
    assert chip_smoke.image_agreement(img, ref)["ok"]
    img[0, :2] = 1.0  # two: over it
    assert not chip_smoke.image_agreement(img, ref)["ok"]


def test_sharded_phases_on_four_devices():
    chip_smoke.phase_sharded_render(4, 24, 16, backend="interpret")
    chip_smoke.phase_sharded_fit(4, 16, 12, steps=2)
    assert chip_smoke.phase_sharded_mesh(4, 24)["bit_identical"]
    chip_smoke.phase_sharded_tiles(4, 24, 16, tile_rows=6)

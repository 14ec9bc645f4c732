"""The controls, at a size a test run holds: the plain reference computed
one precision below the configuration's (bfloat16 for its float32) in the
program's place fails the cells' checks, and so do an AD cell's faults,
planted in the reference put in the program's place. On the CPU with the
reference alone (portbench/calibrate_*.py reads them on the card at the
cells' own sizes)."""

import numpy as np
import pytest
import torch

from portbench import calibrate_ad
from portbench.harness import ad_step, check_ad, check_frame, files

BENCH = files.manifest()
REF = files.reference("path_tracer")
SCENE = files.load_module(files.PKG / "configs" / "matpreview.py")


def _limits(cell):
    w, _, config, _ = files.cell(cell, BENCH)
    return config["limits"][w["traffic"]]


def test_frame_control_fails():
    d = SCENE.build(24, 4, 8, n_sub=2)
    pix = torch.arange(24 * 24)
    want = REF.render_pixels(REF.Scene(d, "cpu"), 11, pix).numpy()
    low = REF.render_pixels(REF.Scene(d, "cpu", torch.bfloat16), 11, pix).float().numpy()
    off, l1 = check_frame.numbers(low, want)
    limits = _limits("matpreview-frame")
    assert off > limits["pixels_off"] and l1 > limits["rel_l1"]
    assert check_frame.numbers(want, want) == (0.0, 0.0)


@pytest.fixture(scope="module")
def ad_case():
    d = SCENE.build(12, 2, 4, n_sub=1)
    scene = REF.Scene(d, "cpu")
    start = {"bsdf.tabulated.table": scene.tables.clone(),
             "bsdf.roughconductor.alpha_u": torch.tensor([0.25]),
             "bsdf.roughconductor.alpha_v": torch.tensor([0.25])}
    target = torch.as_tensor(ad_step.target_image(5, 12, 12))
    seeds = [6, 7, 8]
    sound = check_ad.reference_steps("path_tracer", d, start, target, seeds, 0.02, "cpu")
    return d, start, target, seeds, sound


@pytest.mark.parametrize("what,dtype,loss_of", [
    ("control", torch.bfloat16, None),
    ("half of the batch", torch.float32, calibrate_ad.fault_half_batch("path_tracer")),
    ("an altered answer", torch.float32, calibrate_ad.fault_altered("path_tracer")),
])
def test_ad_control_and_faults_fail(ad_case, what, dtype, loss_of):
    d, start, target, seeds, sound = ad_case
    got = check_ad.reference_steps("path_tracer", d, start, target, seeds, 0.02, "cpu", dtype,
                                   loss_of)
    gaps = check_ad.numbers(got, sound)
    limits = _limits("matpreview-ad")
    assert any(gaps[k] > limits[k] for k in limits), (what, gaps)


def test_a_state_left_unchanged_reads_one(ad_case):
    _, _, _, _, sound = ad_case
    unchanged = (sound[0], sound[1], {k: 0.0 for k in sound[2]})
    assert check_ad.numbers(unchanged, sound)["step_gap"] == pytest.approx(1.0)


def test_gap_is_by_the_worst_leaf_against_the_median():
    ref = {"a": 10.0, "b": 1.0, "c": 0.001}
    prog = {"a": 10.5, "b": 1.0, "c": 0.002}
    # a: 0.5 / 10; c: 0.001 / median 1.0; the worst is a's
    assert check_ad.gap(prog, ref) == pytest.approx(0.05)
    assert check_ad.gap({"a": 10.0, "b": 1.0, "c": 5.0}, ref, floor_ratio=0.01) == 0.0
    assert np.isfinite(check_ad.gap(prog, ref))

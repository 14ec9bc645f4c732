"""A frame cell driven end to end on the CPU at a small size with the
kernels' plain versions: the harness, the window and the check against the
plain reference; and the check failing for each fault a frame cell can
have, planted in the timed path."""

import pytest

from portbench import run
from portbench.harness import files

SMALL = {"config": {"scene_args": {"n_sub": 2, "n_materials": 10},
                    "compact": {"frame": [1.0, 0.98, 0.3, 0.12, 0.05, 0.02, 0.02, 0.02]}},
         "traffic": {"resolution": 32, "spp": 4, "depth": 8, "check_pixels": 128,
                     "check_frames": 2, "warmup_frames": 1}}


def _run(seed=2**31 + 99):
    return run.run_cell("matpreview-frame", seed, 1.0, False, "cpu", overrides=SMALL)


@pytest.fixture
def integrator():
    from mitsuba_customization_tpu_torch.render import integrator

    return integrator


def _patch(monkeypatch, integrator, fn):
    """Break render_jit underneath the harness (it imports the name when a
    run starts)."""
    monkeypatch.setattr(integrator, "render_jit", fn)


def test_small_cell_is_correct():
    out, checks = _run()
    assert out["correct"] is True and out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}
    assert checks["pixels_off"]["value"] == 0.0
    assert checks["rel_l1"]["value"] < 1e-5
    assert list(out)[-1] == "checks"
    assert run.forbidden_modules() == []


def test_half_the_samples_fails(monkeypatch, integrator):
    real = integrator.render_jit
    _patch(monkeypatch, integrator, lambda scene, spp, seed: real(scene, spp // 2, seed))
    out, checks = _run()
    assert out["correct"] is False


def test_another_requests_answer_fails(monkeypatch, integrator):
    real = integrator.render_jit
    _patch(monkeypatch, integrator, lambda scene, spp, seed: real(scene, spp, seed + 1))
    assert _run()[0]["correct"] is False


def test_an_altered_answer_fails(monkeypatch, integrator):
    real = integrator.render_jit
    _patch(monkeypatch, integrator, lambda scene, spp, seed: real(scene, spp, seed) * 1.02)
    out, checks = _run()
    assert out["correct"] is False
    assert checks["rel_l1"]["value"] > checks["rel_l1"]["limit"]


def test_no_card_exits_without_a_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    code = run.main(["--workload", "matpreview-frame", "--seed", "5", "--seconds", "1",
                     "--trace", "0"])
    assert code != 0 and capsys.readouterr().out == ""


def test_limits_sit_between_the_readings():
    # PERF.md: the largest reading of sound runs over 12 seeds, and the
    # smallest of the bfloat16 control and of the faults that read ten
    # times that or more (the card, at the cells' own sizes)
    limits = files.cell("matpreview-frame", files.manifest())[2]["limits"]
    readings = {"frame": {"pixels_off": (0.000366, 0.8247), "rel_l1": (1.42e-5, 0.443)},
                "ad_step": {"loss_gap": (3.27e-4, 0.337), "grad_gap": (3.48e-5, 0.05),
                            "step_gap": (1.02e-5, 0.0064)}}
    for mix, nums in readings.items():
        for k, (lower, upper) in nums.items():
            assert lower * 3 <= upper and lower < limits[mix][k] < upper, (mix, k)


SMALL_AD = {"config": {"scene_args": {"n_sub": 1, "n_materials": 10},
                       "compact": {"ad_step": [1.0, 0.98, 0.6, 0.4]}},
            "traffic": {"resolution": 12, "spp": 2, "depth": 4}}


def test_small_ad_cell_is_correct():
    out, checks = run.run_cell("matpreview-ad", 2**31 + 5, 0.5, False, "cpu",
                               overrides=SMALL_AD)
    assert out["correct"] is True and out["attempted"] >= 4
    assert set(out["metrics"]) == {"step_ms", "step_p95_ms", "setup_s"}
    assert all(c["value"] < 1e-3 for c in checks.values())


def test_ad_step_returning_its_state_fails(monkeypatch):
    from mitsuba_customization_tpu_torch.render import ad

    monkeypatch.setattr(ad.Optimizer, "step", lambda self, grads: self.params)
    out, checks = run.run_cell("matpreview-ad", 2**31 + 5, 0.5, False, "cpu",
                               overrides=SMALL_AD)
    assert out["correct"] is False and checks["step_gap"]["value"] == pytest.approx(1.0)


SMALL_VOL = {"config": {"scene_args": {"n_sub": 1, "n_materials": 10, "grid_res": 12}},
             "traffic": {"resolution": 12, "spp": 2, "depth": 4}}


def test_small_volpath_cell_is_correct():
    out, checks = run.run_cell("volpath-ad", 2**31 + 21, 0.5, False, "cpu",
                               overrides=SMALL_VOL)
    assert out["correct"] is True
    assert all(c["value"] < 1e-3 for c in checks.values())


SMALL_SHARDED = {"config": {"scene_args": {"n_sub": 1, "n_materials": 10},
                            "compact": {"ad_step_4chip": None}},
                 "traffic": {"resolution": 8, "spp": 1, "depth": 3, "ranks": 2}}


def test_small_sharded_cell_is_correct_and_ends_its_ranks():
    import multiprocessing

    out, checks = run.run_cell("matpreview-ad-4chip", 2**31 + 9, 0.5, False, "cpu",
                               overrides=SMALL_SHARDED)
    assert out["correct"] is True
    assert all(c["value"] < 1e-3 for c in checks.values())
    assert not multiprocessing.active_children()

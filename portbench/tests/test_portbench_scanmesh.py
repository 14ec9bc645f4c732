"""The scanmesh-frame cell's parts on the CPU: the B1 / B2 counts on
made-up calls, and a small scanmesh cell (clusters.MAX_PRIMS lowered below
its prims, so that it traces on the BVH as the cell's 7.2M triangles do
past the real cap) end to end with the kernels' plain versions, its calls
recorded at the BVH wrappers and none at the cluster kernels'."""

from types import SimpleNamespace

import pytest
import torch

from portbench import run
from portbench.harness import calls, files, frame

K = files.kernels()

SMALL_SCAN = {"config": {"scene_args": {"n_quads": 8, "n_materials": 10, "seed": 7},
                         "compact": {"frame": [1.0, 1.0, 0.4, 0.2, 0.1, 0.05, 0.05, 0.05]}},
              "traffic": {"resolution": 16, "spp": 2, "depth": 8, "check_pixels": 128,
                          "check_frames": 2, "warmup_frames": 1}}
PRIMS = 772  # 768 triangles of the object, the floor's and the light's two each


@pytest.mark.parametrize("name,out", [("b1", 16), ("b2", 1)])
def test_b1_b2(name, out):
    # the BVH wrappers take (tree, geometry, ray, cylinders)
    ray = SimpleNamespace(o=torch.zeros(6, 3), d=torch.zeros(6, 3),
                          maxt=torch.tensor([1.0, 0.0, float("inf"), -1.0, 2.0, 0.5]))
    rec = dict(K[name].record((None, None, ray, True), {}, None), prims=1000)
    assert rec == {"lanes": 6, "live": 4, "prims": 1000}
    assert K[name].work(rec) == (6 * (4 + out) + 4 * 24 + 1000 * 36, 0)
    assert K[name].WRAPPER == ("mitsuba_customization_tpu_torch.render.bvh",
                               {"b1": "intersect", "b2": "occluded"}[name])


@pytest.fixture
def past_the_cap(monkeypatch):
    from mitsuba_customization_tpu_torch.ops import clusters

    monkeypatch.setattr(clusters, "MAX_PRIMS", PRIMS - 1)


def test_small_scanmesh_cell_is_correct(past_the_cap):
    from mitsuba_customization_tpu_torch.render import bvh

    before = dict(bvh.LAUNCHES)
    out, checks = run.run_cell("scanmesh-frame", 2**31 + 77, 0.5, False, "cpu",
                               overrides=SMALL_SCAN)
    assert out["correct"] is True and out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}
    assert checks["pixels_off"]["value"] == 0.0 and checks["rel_l1"]["value"] < 1e-5
    assert bvh.LAUNCHES == before  # the CPU runs the plain walks: no launch


def test_small_scanmesh_cell_records_b1_b2_and_no_cluster_kernel(past_the_cap):
    import mitsuba_customization_tpu_torch as mt

    config = dict(files.cell("scanmesh-frame", files.manifest())[2], **SMALL_SCAN["config"])
    d = frame.scene_dict(config, dict(SMALL_SCAN["traffic"], name="frame"))
    assert frame.prims_of(d) == PRIMS
    scene = mt.load_dict(d, "cpu")
    assert scene.config.intersector == "bvh"
    with calls.recording(files.kernels(), {"prims": PRIMS}) as rec:
        mt.render(scene, 2, 3)
    # a closest-hit query a bounce, a shadow query each bounce but the last
    assert len(rec["b1"]) == 8 and len(rec["b2"]) == 7
    assert not rec["k3"] and not rec["k4"]
    assert all(c["prims"] == PRIMS and c["live"] <= c["lanes"] for c in rec["b1"] + rec["b2"])
    assert rec["b1"][0]["live"] == rec["b1"][0]["lanes"] == 16 * 16 * 2


def test_limits_sit_between_the_readings():
    # PERF.md: the largest reading of sound runs (12 seeds of
    # calibrate_frame.py and every run of the cell on the card), and the
    # smallest of the bfloat16 control and of the faults (half the
    # samples, another request's answer), on an H100 at the cell's sizes
    limits = files.cell("scanmesh-frame", files.manifest())[2]["limits"]["frame"]
    readings = {"pixels_off": (0.0009765625, 0.7894287109375),
                "rel_l1": (2.2169e-4, 0.2109272)}
    for k, (lower, upper) in readings.items():
        assert lower * 3 <= upper and lower < limits[k] < upper, k

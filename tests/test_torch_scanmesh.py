"""The scanmesh configuration (portbench/configs/scanmesh.py) and its plain
reference (portbench/reference/path_tracer_large.py) on the CPU.

- the builder's count at the configuration's arguments is 7,226,112 by
  formula; at a small tessellation the mesh is closed (every edge has two
  faces, each way once), wound outward, the same on a second build, and
  each band holds only the vertices its faces use;
- with clusters.MAX_PRIMS lowered below its prims the loader puts the
  small scene on the "bvh" intersector, and the port's `render` and
  `render_jit` match path_tracer_large pixel by pixel within the cell's
  limits (16x16, 2 spp, depth 3);
- path_tracer_large equals path_tracer bit for bit on matpreview's
  builder at n_sub=2, with its supergroups as they are and cut to two
  groups each.
"""

import json
import logging

import numpy as np
import pytest
import torch

import mitsuba_customization_tpu_torch as mt
from mitsuba_customization_tpu_torch.ops import clusters
from mitsuba_customization_tpu_torch.render import frame_graph
from mitsuba_customization_tpu_torch.render.integrator import render_jit
from portbench.harness import check_frame, files
from portbench.reference import path_tracer, path_tracer_large
from test_torch_kernels import one_torch_thread  # noqa: F401

SCAN = files.load_module(files.PKG / "configs" / "scanmesh.py")
MATPREVIEW = files.load_module(files.PKG / "configs" / "matpreview.py")
CONFIG = json.loads((files.PKG / "configs" / "scanmesh.json").read_text())


def _triangles(n_quads):
    """Two triangles a quad, n_quads**2 quads on each of the cube's faces."""
    return 12 * n_quads * n_quads


def test_the_cells_count_by_formula():
    args = CONFIG["scene_args"]
    assert _triangles(args["n_quads"]) == 7_226_112 == CONFIG["object_triangles"]
    assert CONFIG["triangles"] == CONFIG["object_triangles"] + 4  # floor and light
    assert 6 * args["n_quads"] ** 2 + 2 == CONFIG["object_vertices"]
    for n in (1, 3, 8):
        dirs, f = SCAN.cube_sphere(n)
        assert f.shape == (_triangles(n), 3) and dirs.shape == (6 * n * n + 2, 3)


@pytest.mark.parametrize("n_quads", [3, 8])
def test_the_small_mesh_is_closed_outward_and_deterministic(n_quads):
    v, f, vn = SCAN.scan_object(n_quads)
    # every edge of two faces, once each way round: closed and consistently wound
    directed = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    assert len(np.unique(directed, axis=0)) == len(directed)
    undirected, count = np.unique(np.sort(directed, 1), axis=0, return_counts=True)
    assert (count == 2).all() and len(undirected) == 3 * len(f) // 2
    assert len(np.unique(f)) == len(v)  # every vertex used
    # outward: the signed volume is positive, and normals point away
    p0, p1, p2 = (v[f[:, k]].astype(np.float64) for k in range(3))
    assert np.einsum("ij,ij->i", p0, np.cross(p1, p2)).sum() > 0
    assert (np.einsum("ij,ij->i", vn, v) > 0).all()
    assert np.abs(np.linalg.norm(v, axis=1)).max() == pytest.approx(SCAN.RADIUS, rel=1e-6)
    again = SCAN.scan_object(n_quads)
    for a, b in zip((v, f, vn), again):
        np.testing.assert_array_equal(a, b)


def test_each_band_holds_only_its_vertices():
    d = SCAN.build(16, 2, 3, n_quads=8, n_materials=10)
    v, f, _ = SCAN.scan_object(8)
    bands = [d[f"scan_{i}"] for i in range(10)]
    assert sum(len(b["faces"]) for b in bands) == len(f)
    seen = set()
    for b in bands:
        assert len(np.unique(b["faces"])) == len(b["vertices"]) == len(b["normals"])
        seen |= {tuple(t) for t in np.sort(b["vertices"][b["faces"]].reshape(-1, 9), 1)}
    assert seen == {tuple(t) for t in np.sort(v[f].reshape(-1, 9), 1)}
    assert {"floor", "light", "sky", "sensor", "integrator"} <= set(d)


@pytest.fixture
def small_scan(monkeypatch, caplog):
    d = SCAN.build(16, 2, 3, n_quads=8, n_materials=10)
    prims = _triangles(8) + 4
    monkeypatch.setattr(clusters, "MAX_PRIMS", prims - 1)
    with caplog.at_level(logging.WARNING, "mitsuba_customization_tpu_torch"):
        scene = mt.load_dict(d, "cpu")
    assert any("capacity contract" in r.getMessage() for r in caplog.records)
    assert scene.config.intersector == "bvh" and scene.clusters is None
    assert scene.geometry.p0.shape[0] == prims
    yield d, scene
    frame_graph.clear()


def test_render_and_render_jit_on_the_bvh_match_the_large_reference(small_scan):
    d, scene = small_scan
    ref = path_tracer_large.scene_of(d, "cpu")
    limits = CONFIG["limits"]["frame"]
    for seed in (5, 2**31 + 11):
        want = path_tracer_large.render_pixels(ref, seed, torch.arange(256)).numpy()
        for img in (mt.render(scene, 2, seed), render_jit(scene, 2, seed)):
            off, l1 = check_frame.numbers(img.numpy().reshape(-1, 3), want)
            assert off <= limits["pixels_off"] and l1 <= limits["rel_l1"], (seed, off, l1)
            assert off == 0.0 and l1 < 1e-5


@pytest.mark.parametrize("sup", [None, 2])
def test_large_reference_is_path_tracer_bit_for_bit(monkeypatch, sup):
    if sup is not None:
        monkeypatch.setattr(path_tracer_large, "SUPER", sup)
    d = MATPREVIEW.build(16, 2, 4, n_sub=2, n_materials=10)
    a = path_tracer.scene_of(d, "cpu")
    b = path_tracer_large.scene_of(d, "cpu")
    n_groups = a.group_ids.shape[0]
    assert b.super_ids.shape[0] == -(-n_groups // path_tracer_large.SUPER)
    if sup is not None:
        assert b.super_ids.shape[0] > 1
    pix = torch.arange(256)
    for seed in (3, 2**32 - 7):
        assert torch.equal(path_tracer.render_pixels(a, seed, pix),
                           path_tracer_large.render_pixels(b, seed, pix))
    # the queries themselves, closest and any hit, on the camera's rays
    o = a.cam_pos.expand(64, 3)
    dirs = torch.nn.functional.normalize(torch.randn(64, 3, generator=torch.Generator()
                                                     .manual_seed(0)), dim=1)
    maxt = torch.full((64,), float("inf"))
    for any_hit in (False, True):
        x = path_tracer._hits(a, o, dirs, maxt, any_hit)
        y = path_tracer_large._hits(b, o, dirs, maxt, any_hit)
        if any_hit:
            x, y = (x,), (y,)
        assert all(torch.equal(p, q) for p, q in zip(x, y))

"""The port's captured-frame entry points (render/integrator.render_jit,
parallel/mesh.render_sharded_jit, render/frame_graph.py) on the CPU,
where the frame's plan and body run with no graph.

- render_jit equals render bit for bit on the flagship, the matpreview
  scene with its probed schedule, the camera scene (thin lens,
  multijitter, gaussian splat), a mesh scene on the BVH (past a lowered
  clusters.MAX_PRIMS), and the kinds whose loops run to a condition per
  lane: volpath with a density grid (T1 / T2), a medium under the path
  integrator, an SDF scene (S1), ptracer and bdpt;
- it agrees with the JAX package's render_jit on the same dicts: image
  means within 1 % and the per-pixel Z-test of
  tests/reference_renderer.ztest_images (both draw the same uniforms);
- the JAX test_replay_deterministic, mirrored;
- the samplers' draws with a 0-d tensor seed (a frame's seed buffer) equal
  the int seed's, for all five samplers;
- render_sharded_jit on 2 gloo ranks equals render_sharded, and on one
  rank render_jit (box and gaussian);
- the body (a light tracer's too) passes a capture-safety guard: under a
  TorchDispatchMode no operator that reads a tensor back to the host or
  makes one from host data runs (the kernels' plain versions excepted,
  T1 / T2 / S1's among them: on the card the kernels run in their
  place);
- the frame cache: a changed scene.config or a replaced tensor plans a new
  frame, an in-place edit of values does not (and is read).

Inputs are made from a seed (numpy, the scene dicts); one torch thread.
The gloo ranks are subprocesses of this file (`__main__`), which import
no JAX.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _disable_current_modes,
    _get_current_dispatch_mode_stack,
)

import mitsuba_customization_tpu_torch as mt
from mitsuba_customization_tpu_torch import scenes
from mitsuba_customization_tpu_torch.core import sampler as tsampler
from mitsuba_customization_tpu_torch.ops import clusters as tcl
from mitsuba_customization_tpu_torch.ops import marginal_sorted, merl_sorted
from mitsuba_customization_tpu_torch.parallel import mesh as pm
from mitsuba_customization_tpu_torch.render import bvh, frame_graph, medium, sdf
from mitsuba_customization_tpu_torch.render import integrator as tint
from reference_renderer import ztest_images
from test_torch_kernels import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _scene(name, monkeypatch=None):
    """(scene on the CPU, spp) of a named test scene."""
    if name == "flagship":
        return mt.load_dict(scenes.flagship_dict(32, 4, 3), "cpu"), 4
    if name == "matpreview_probed":
        scene = mt.load_dict(scenes.matpreview_dict(32, 4, 4, n_sub=2), "cpu")
        scene, fracs = scenes.probe_compact_schedule(scene, spp=4)
        assert min(fracs) < 1.0  # the schedule thins
        return scene, 4
    if name == "camera":
        return mt.load_dict(scenes.camera_dict(32, 4, 3, n_sub=2), "cpu"), 4
    if name == "bvh":
        monkeypatch.setattr(tcl, "MAX_PRIMS", 64)
        scene = mt.load_dict(scenes.matpreview_dict(32, 2, 3, n_sub=2), "cpu")
        assert scene.config.intersector == "bvh"
        return scene, 2
    d = scenes.flagship_dict(16, 4, 3)
    if name in tsampler.SAMPLERS:
        d = scenes.variant_dict(16, 9 if name == "orthogonal" else 4, 3, sampler=name)
        return mt.load_dict(d, "cpu"), 9 if name == "orthogonal" else 4
    if name == "batch":
        d = scenes.batch_strips_dict({
            "type": "batch", "film": {"width": 16, "height": 8},
            "sampler": {"type": "independent", "sample_count": 2},
            "left": {"type": "perspective", "to_world": scenes.BATCH_LOOKS[0]},
            "right": {"type": "thinlens", "aperture_radius": 0.02,
                      "to_world": scenes.BATCH_LOOKS[1]}})
        return mt.load_dict(d, "cpu"), 2
    if name in ("materials", "blend"):
        from chip_smoke import material_bands

        d = scenes.matpreview_dict(16, 2, 4, n_sub=2, n_materials=12)
        material_bands(d, blend=name == "blend")
        return mt.load_dict(d, "cpu"), 2
    if name == "emitters":
        from chip_smoke import emitters_dict

        return mt.load_dict(emitters_dict(16, 2, 3), "cpu"), 2
    if name == "volpath":  # a fog ball and a smoke cube of an 8^3 grid
        return mt.load_dict(scenes.volpath_dict(16, 2, 3, grid_res=8, n_sub=2), "cpu"), 2
    if name == "media":  # a homogeneous fog under the path integrator
        d = scenes.fog_dict(1.0, 0.5, res=8, spp=2)
        d["integrator"] = {"type": "path", "max_depth": 3}
        return mt.load_dict(d, "cpu"), 2
    if name == "sdf":
        tw = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
        tw[:3, 3] = -1.0
        return mt.load_dict(scenes.sdf_sphere_dict(
            {"type": "sdfgrid", "grid": scenes.sphere_sdf(n=16), "to_world": tw,
             "bsdf": {"type": "diffuse"}}, 8, 2), "cpu"), 2
    if name == "ptracer":
        return mt.load_dict(scenes.ptracer_box_dict("ptracer", 2, 3, 12), "cpu"), 2
    if name == "bdpt":
        return mt.load_dict(scenes.bdpt_spheres_dict("bdpt", 2, 3, 12), "cpu"), 2
    d["integrator"] = {"type": name, "max_depth": 3}  # an integrator's name
    return mt.load_dict(d, "cpu"), 4


@pytest.fixture
def root_on_path(monkeypatch):
    monkeypatch.syspath_prepend(ROOT)


# the loops that run to a condition per lane: T1 / T2 (volpath, media),
# S1 (sdf), the light tracers' bodies (ptracer, bdpt)
LOOPED = ["volpath", "media", "sdf", "ptracer", "bdpt"]
FRAMES = ["flagship", "matpreview_probed", "camera", "bvh"] + LOOPED


@pytest.mark.parametrize("name", FRAMES)
def test_render_jit_equals_render(name, monkeypatch):
    """The same plan and passes as render (or the same light tracer's
    plan and body), a seed tensor in place of the int: bit for bit, at
    two seeds, each call a new tensor, the image not blank."""
    scene, spp = _scene(name, monkeypatch)
    for seed in (0, 7):
        want = tint.render(scene, spp, seed)
        got = tint.render_jit(scene, spp, seed)
        assert torch.equal(got, want), seed
        assert bool((got > 0).any())
    assert tint.render_jit(scene, spp, 7) is not got


@pytest.mark.parametrize("name", ["flagship", "camera"])
def test_render_jit_matches_jax_render_jit(name):
    """The port's render_jit against the JAX package's on the same dict
    (16x16): means within 1 % and the per-pixel Z-test (variance from
    the port's frames at two seeds)."""
    import mitsuba_customization_tpu as mct
    from mitsuba_customization_tpu.render.integrator import render_jit as jax_render_jit

    spp = 8
    d = (scenes.flagship_dict(16, spp, 3) if name == "flagship"
         else scenes.camera_dict(16, spp, 3, n_sub=2))
    scene = mt.load_dict(d, "cpu")
    got = tint.render_jit(scene, spp, 0).numpy()
    other = tint.render_jit(scene, spp, 1).numpy()
    want = np.asarray(jax_render_jit(mct.load_dict(d), spp, 0))
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)), rtol=0.01)
    var = 0.5 * (got - other) ** 2 * spp + 1e-4
    ok, z = ztest_images(got, var, want, var, spp, spp)
    assert ok, z


def test_replay_deterministic():
    """The JAX package's tests/test_ad.py::test_replay_deterministic: the
    same seed gives equal frames, another seed another frame; the three
    frames, held at once, are three tensors (no frame aliases another)."""
    d = scenes.flagship_dict(24, 8, 3)
    d["merl_sphere"]["bsdf"] = {"type": "diffuse"}
    scene = mt.load_dict(d, "cpu")
    plans = frame_graph.PLANS
    a = tint.render_jit(scene, spp=8, seed=7)
    b = tint.render_jit(scene, spp=8, seed=7)
    c = tint.render_jit(scene, spp=8, seed=8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert len({a.data_ptr(), b.data_ptr(), c.data_ptr()}) == 3
    assert frame_graph.PLANS == plans + 1  # the seed went through the seed buffer


@pytest.mark.parametrize("name", ["independent", "stratified", "sobol", "multijitter",
                                  "orthogonal"])
def test_sampler_draws_with_a_tensor_seed_equal_the_int_seeds(name):
    """make_sampler with a 0-d int64 tensor seed (a frame's seed buffer,
    negative and past 32 bits masked alike) draws the int seed's uniforms
    bit for bit: 1-D and 2-D draws over several dimension bases."""
    spp = 9 if name == "orthogonal" else 8
    lanes = torch.arange(64 * spp, dtype=torch.int64)
    pixel, sidx = lanes // spp, lanes % spp
    for seed in (0, 123457, -5, (1 << 33) + 9):
        a = tsampler.make_sampler(name, seed, pixel, sidx, spp)
        b = tsampler.make_sampler(name, torch.tensor(seed, dtype=torch.int64), pixel, sidx,
                                  spp)
        for base in (0, 4, 12):
            a, b = a.with_dim(base), b.with_dim(base)
            for draw in ("next_2d", "next_1d", "next_2d", "next_1d"):
                assert torch.equal(getattr(a, draw)(), getattr(b, draw)()), (seed, base, draw)


def _worker(rfilter, rank, world, store, out):
    """One gloo rank: render_sharded and render_sharded_jit (twice, at two
    seeds) of the filter's scene, saved to out/rank<r>.npz."""
    torch.set_num_threads(1)
    pm.initialize_distributed(f"file://{store}", world, rank, device="cpu", timeout=60)
    scene = mt.load_dict(_sharded_dict(rfilter), "cpu")
    mesh = pm.make_mesh()
    res = {}
    for seed in (0, 3):
        res[f"eager{seed}"] = pm.render_sharded(scene, mesh, 4, seed).numpy()
        res[f"jit{seed}"] = pm.render_sharded_jit(scene, mesh, 4, seed).numpy()
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    torch.distributed.destroy_process_group()


def _sharded_dict(rfilter):
    d = scenes.variant_dict(16, 4, 3, rfilter=rfilter)
    d["integrator"] = {"type": "path", "max_depth": 3}
    return d


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("rfilter", ["box", "gaussian"])
def test_render_sharded_jit_equals_render_sharded(tmp_path, rfilter, world):
    """On 2 gloo ranks (subprocesses of this file meeting through a file://
    store; 60 s group timeout, 120 s wait) every rank's render_sharded_jit
    image equals its render_sharded image at two seeds; on one rank (no
    process group) render_sharded_jit equals render_jit."""
    if world == 1:
        scene = mt.load_dict(_sharded_dict(rfilter), "cpu")
        for seed in (0, 3):
            got = pm.render_sharded_jit(scene, None, 4, seed)
            assert torch.equal(got, tint.render_jit(scene, 4, seed))
            assert torch.equal(got, pm.render_sharded(scene, None, 4, seed))
        return
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, HERE, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, __file__, rfilter, str(r), str(world), str(tmp_path / "store"),
         str(tmp_path)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    outs = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]
    for o in outs:
        for seed in (0, 3):
            np.testing.assert_array_equal(o[f"jit{seed}"], o[f"eager{seed}"])
            np.testing.assert_array_equal(o[f"jit{seed}"], outs[0][f"jit{seed}"])
    assert not np.array_equal(outs[0]["jit0"], outs[0]["jit3"])


# operators that read a tensor back to the host, or make one from host data:
# on the card each is a synchronisation or a copy that a capture refuses or
# bakes in (torch.tensor(5) shows as lift_fresh, bool(t) as
# _local_scalar_dense)
_HOST_OPS = ("aten._local_scalar_dense", "aten.nonzero", "aten.lift_fresh",
             "aten.masked_select", "aten.unique", "aten._unique", "aten.repeat_interleave.Tensor")


class _Guard(TorchDispatchMode):
    """Records the host operators of _HOST_OPS and indexing by a bool mask."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith(_HOST_OPS):
            self.found.append(name)
        if func is torch.ops.aten.index.Tensor and any(
                i is not None and i.dtype == torch.bool for i in args[1]):
            self.found.append("aten.index.Tensor (bool mask)")
        return func(*args, **(kwargs or {}))


def _outside_the_guard(fn):
    def run(*args, **kwargs):
        with _disable_current_modes():
            return fn(*args, **kwargs)

    return run


GUARDED = FRAMES + ["stratified", "sobol", "orthogonal", "batch", "materials", "blend",
                    "emitters", "direct", "depth", "aov_normals", "aov_uv", "moment"]


# each kernel's plain version, which a guarded body calls outside the guard
PLAINS = ((merl_sorted, ("eval_trilinear_plain",)),
          (marginal_sorted, ("cond_sample_pdf_plain",)),
          (tcl, ("intersect_plain", "occluded_plain")),
          (bvh, ("intersect_plain", "occluded_plain")),
          (medium, ("delta_track_plain", "ratio_track_plain")),
          (sdf, ("march_plain",)))


@pytest.mark.parametrize("name", GUARDED)
def test_body_is_capture_safe(name, monkeypatch, root_on_path):
    """render_jit's body (rows_body and develop on the plan's inputs, or a
    light tracer's body on its plan, the seed a 0-d tensor) runs no host
    operator: nothing of _HOST_OPS, no bool-mask index, no Tensor.tolist
    / item / numpy, no torch.as_tensor or from_numpy. The kernels' plain
    versions (K1, K2, K3 / K4, B1 / B2, T1 / T2, S1) run outside the
    guard: on the card the kernels launch in their place."""
    scene, spp = _scene(name, monkeypatch)
    kind = tint._integrator_kind(scene, None)
    if kind in tint.TRACERS:
        plan = tint.tracer(kind).plan(scene, spp)

        def body(seed):
            return tint.tracer(kind).body(scene, plan, seed)[0]
    else:
        plan = tint.plan_rows(scene, spp, None, None, 0, scene.config.height)
        inputs = tint.rows_inputs(scene, plan)

        def body(seed):
            return tint.develop(scene.config, tint.rows_body(scene, plan, inputs, seed, False)[0])
    frame_graph.bvh_packs(scene)
    for mod, fns in PLAINS:
        for fn in fns:
            monkeypatch.setattr(mod, fn, _outside_the_guard(getattr(mod, fn)))
    guard = _Guard()

    def recorded(what, fn):
        def run(*args, **kwargs):
            if guard in _get_current_dispatch_mode_stack():  # not in a plain version
                guard.found.append(what)
            return fn(*args, **kwargs)

        return run

    for obj, fn in ((torch.Tensor, "tolist"), (torch.Tensor, "item"), (torch.Tensor, "numpy"),
                    (torch, "as_tensor"), (torch, "from_numpy")):
        monkeypatch.setattr(obj, fn, recorded(fn, getattr(obj, fn)))
    seed = torch.zeros((), dtype=torch.int64)
    with torch.no_grad(), guard:
        img = body(seed)
    assert guard.found == [], sorted(set(guard.found))
    assert torch.isfinite(img).all()


def test_the_guard_sees_host_operators():
    """The guard itself: a host read, a tensor made from a Python number and
    a bool-mask index are recorded."""
    x = torch.arange(4.0)
    with _Guard() as guard:
        bool((x > 1).any())
        torch.tensor(5)
        x[x > 1]
    assert "aten._local_scalar_dense.default" in guard.found
    assert "aten.lift_fresh.default" in guard.found
    assert "aten.index.Tensor (bool mask)" in guard.found


def test_a_new_frame_is_planned_on_a_config_change_or_a_replaced_tensor():
    """The frame key: the same call plans nothing new; scene.config.rfilter
    = "gaussian" (the JAX test's mutation) plans a new frame, which renders
    render's gaussian frame; a replaced tensor plans a new one; an in-place
    edit of a tensor's values plans none and is read by the next call."""
    import dataclasses

    scene = mt.load_dict(scenes.flagship_dict(16, 4, 3), "cpu")
    tint.render_jit(scene, 4, 0)
    plans = frame_graph.PLANS
    tint.render_jit(scene, 4, 1)
    assert frame_graph.PLANS == plans
    scene.config.rfilter = "gaussian"
    got = tint.render_jit(scene, 4, 1)
    assert frame_graph.PLANS == plans + 1
    assert torch.equal(got, tint.render(scene, 4, 1))
    scene.geometry = scene.geometry._replace(p0=scene.geometry.p0.clone())
    tint.render_jit(scene, 4, 1)
    assert frame_graph.PLANS == plans + 2
    scene.emitters.radiance.mul_(2.0)
    got = tint.render_jit(scene, 4, 1)
    assert frame_graph.PLANS == plans + 2
    assert torch.equal(got, tint.render(scene, 4, 1))
    # spp, the integrator and the depth are the plan's too
    tint.render_jit(scene, 2, 1, "direct", 2)
    assert frame_graph.PLANS == plans + 3
    # a new Scene object of the same tensors is another scene
    tint.render_jit(dataclasses.replace(scene), 4, 1)
    assert frame_graph.PLANS == plans + 4


def test_a_frame_of_a_changed_scene_replaces_the_one_planned_alike():
    """A frame planned anew for a scene whose tensors were replaced drops
    the frame of the same plan that held the old ones (and its memory);
    the scene's frames of another plan stay."""
    scene = mt.load_dict(scenes.flagship_dict(8, 2, 2), "cpu")
    frame_graph.clear()
    tint.render_jit(scene, 2, 0)
    tint.render_jit(scene, 1, 0)
    old = list(frame_graph._FRAMES.values())
    scene.geometry = scene.geometry._replace(p0=scene.geometry.p0.clone())
    tint.render_jit(scene, 2, 0)
    kept = list(frame_graph._FRAMES.values())
    assert len(kept) == 2 and old[0] not in kept and old[1] in kept
    assert torch.equal(tint.render_jit(scene, 2, 3), tint.render(scene, 2, 3))
    frame_graph.clear()


def test_the_frame_cache_keeps_at_most_cache_size_frames():
    scene = mt.load_dict(scenes.flagship_dict(8, 2, 2), "cpu")
    frame_graph.clear()
    for spp in range(1, frame_graph.CACHE_SIZE + 3):
        tint.render_jit(scene, spp, 0)
    assert len(frame_graph._FRAMES) == frame_graph.CACHE_SIZE
    assert frame_graph.latest().graph is None  # the CPU runs the body as it is
    frame_graph.clear()
    assert frame_graph.latest() is None


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:6])

"""The port's BASELINE configs[0] (sphere + diffuse or MERL, direct
illumination under a constant emitter) against the independent numpy
renderer of tests/reference_renderer.py, with the gates of
tests/test_golden.py: the port's first check that does not go through the
JAX package (no number here comes from it). Then, as slow cases, configs
1-2 with the gates of tests/test_golden_path.py: the matpreview-class
scene (an OBJ blob in a MERL table, a GGX floor, an area light, 3
bounces of NEE + MIS) against the reference's independent multi-bounce
path tracer by a Z-test, on the cluster and on the BVH intersector; and
the floor roughness's AD gradient against a central difference.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import mitsuba_customization_tpu_torch as mt
from mitsuba_customization_tpu_torch.render import params as params_mod
from mitsuba_customization_tpu_torch.scenes import config0_dict
from reference_renderer import (
    PathScene,
    make_blob_mesh,
    render_path_reference,
    render_sphere_furnace,
)
from test_torch_kernels import one_torch_thread  # noqa: F401


def synthetic_table(alpha, diffuse, spec, rgb):
    """tests/fixtures.synthetic_table: a (90, 90, 180, 3) table, a
    Beckmann-like half-angle lobe over a flat diffuse term, slightly
    phi_d-dependent."""
    u = (np.arange(90) + 0.5) / 90
    theta_h = (np.pi / 2) * u**2
    td = (np.arange(90) + 0.5) / 90 * (np.pi / 2)
    pd = (np.arange(180) + 0.5) / 180 * np.pi
    th_g, td_g, pd_g = np.meshgrid(theta_h, td, pd, indexing="ij")
    lobe = np.exp(-((np.tan(np.minimum(th_g, 1.5)) / alpha) ** 2))
    fres = 1.0 + 2.0 * (1.0 - np.cos(td_g)) ** 5
    mono = diffuse / np.pi + spec * lobe * fres * (1.0 + 0.05 * np.cos(2 * pd_g))
    return (mono[..., None] * np.asarray(rgb)).astype(np.float32)


def _interior_mask(res):
    """Pixels well inside the sphere's silhouette (0.355 res in radius for
    this camera), away from the jittered rim (tests/test_golden.py)."""
    yy, xx = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    c = (res - 1) / 2
    return (xx - c) ** 2 + (yy - c) ** 2 < (0.3 * res) ** 2


def test_config0_diffuse_matches_reference():
    res = 32
    albedo = np.array([0.65, 0.35, 0.15])
    scene = mt.load_dict(config0_dict(
        {"type": "diffuse", "reflectance": albedo.tolist()}, res), "cpu")
    ours = mt.render(scene, spp=128).numpy()
    ref = render_sphere_furnace(albedo, res=res, spp=8, brdf="diffuse")
    mask = _interior_mask(res)
    assert np.median(np.abs(ours[mask] - ref[mask])) < 0.01
    assert np.allclose(np.mean(ours[mask], 0), albedo, atol=0.02)


def test_config0_merl_matches_reference():
    """Sphere + a synthetic MERL table, 256 spp against the reference's
    nearest-neighbour 512 spp: median relative error < 5 %, mean < 15 %."""
    res = 24
    table = synthetic_table(alpha=0.35, diffuse=0.25, spec=0.4, rgb=(0.3, 0.4, 0.9))
    scene = mt.load_dict(config0_dict({"type": "merl", "table": table}, res), "cpu")
    ours = mt.render(scene, spp=256).numpy()
    ref = render_sphere_furnace(table, res=res, spp=512, brdf="merl")
    mask = _interior_mask(res)
    rel = np.abs(ours[mask] - ref[mask]) / np.maximum(ref[mask], 0.05)
    assert np.median(rel) < 0.05, np.median(rel)
    assert np.mean(rel) < 0.15, np.mean(rel)


# configs 1-2: tests/test_golden_path.py's scene and settings
ETA = [0.2, 0.92, 1.1]
K = [3.9, 2.45, 2.14]
ALPHA = 0.3
LIGHT_RAD = [12.0, 11.0, 10.0]
CAM = {"origin": [0, 1.0, -3.8], "target": [0, 0, 0], "fov": 40.0}


def _quad(y, half, normal_up):
    """Axis-aligned horizontal quad at height y -> (verts, faces), its
    normal up or down."""
    v = np.asarray([[-half, y, -half], [half, y, -half], [half, y, half], [-half, y, half]],
                   np.float32)
    f = np.asarray([[0, 2, 1], [0, 3, 2]] if normal_up else [[0, 1, 2], [0, 2, 3]], np.int32)
    n = np.cross(v[f[0, 1]] - v[f[0, 0]], v[f[0, 2]] - v[f[0, 0]])
    assert (n[1] > 0) == normal_up, n
    return v, f


def _path_scene_pair(tmp_path):
    """(the port's scene on the CPU, the reference's PathScene) with the
    same geometry and materials: the blob through the OBJ reader, face
    normals everywhere, the moment integrator (mean and second moment),
    depth 3, roulette off."""
    bv, bf = make_blob_mesh(n_sub=2)
    bv = bv * 0.85  # keep the blob above the floor
    fv, ff = _quad(-1.0, 4.0, True)
    lv, lf = _quad(2.5, 1.0, False)
    table = synthetic_table(alpha=0.35, diffuse=0.25, spec=0.4, rgb=(0.3, 0.4, 0.9))
    obj_path = os.path.join(tmp_path, "blob.obj")
    with open(obj_path, "w") as fh:
        for p in bv:
            fh.write(f"v {p[0]} {p[1]} {p[2]}\n")
        for a, b, c in bf + 1:
            fh.write(f"f {a} {b} {c}\n")
    scene = mt.load_dict({
        "type": "scene",
        "integrator": {"type": "moment", "max_depth": 3, "rr_depth": 99},
        "sensor": {"type": "perspective", "fov": CAM["fov"],
                   "to_world": {"look_at": {"origin": CAM["origin"], "target": CAM["target"],
                                            "up": [0, 1, 0]}},
                   "film": {"width": 24, "height": 24},
                   "sampler": {"type": "independent", "sample_count": 256}},
        "blob": {"type": "obj", "filename": obj_path, "face_normals": True,
                 "bsdf": {"type": "merl", "table": table}},
        "floor": {"type": "mesh", "vertices": fv.tolist(), "faces": ff.tolist(),
                  "face_normals": True,
                  "bsdf": {"type": "roughconductor", "alpha": ALPHA, "eta": ETA, "k": K}},
        "panel": {"type": "mesh", "vertices": lv.tolist(), "faces": lf.tolist(),
                  "face_normals": True, "bsdf": {"type": "diffuse", "reflectance": [0, 0, 0]},
                  "emitter": {"type": "area", "radiance": LIGHT_RAD}},
    }, "cpu")

    def soup(v, f):
        p0 = v[f[:, 0]].astype(np.float64)
        return p0, v[f[:, 1]].astype(np.float64) - p0, v[f[:, 2]].astype(np.float64) - p0

    parts = [soup(bv, bf), soup(fv, ff), soup(lv, lf)]
    ref_scene = PathScene(
        *(np.concatenate([p[i] for p in parts]) for i in range(3)),
        np.concatenate([np.zeros(len(bf), np.int32), np.ones(len(ff), np.int32),
                        np.full(len(lf), 2, np.int32)]),
        np.concatenate([np.zeros(len(bf) + len(ff), bool), np.ones(len(lf), bool)]),
        LIGHT_RAD,
        materials=[{"type": "merl", "table": np.asarray(table)},
                   {"type": "ggx", "alpha": ALPHA, "eta": ETA, "k": K},
                   {"type": "diffuse", "albedo": [0, 0, 0]}])
    return scene, ref_scene


@pytest.mark.slow
@pytest.mark.parametrize("intersector", ["cluster", "bvh"])
def test_matpreview_class_ztest(tmp_path, intersector):
    """tests/test_golden_path.py's gate: 256 spp against the reference's
    384, the per-pixel Z-test over both standard errors plus a 1.5 % floor
    for the interpolation bias (nearest-neighbour against trilinear MERL
    lookups) on > 98 % of pixels, and the image means within 5 %."""
    scene, ref_scene = _path_scene_pair(str(tmp_path))
    assert scene.config.intersector == "cluster" and scene.config.use_bvh
    scene = dataclasses.replace(scene, config=dataclasses.replace(scene.config,
                                                                  intersector=intersector))
    spp = 256
    img = mt.render(scene, spp=spp, seed=11).numpy()
    ours = img[..., :3]
    ours_var = np.maximum(img[..., 3:] - ours * ours, 0.0)
    ref_spp = 384
    ref, ref_var = render_path_reference(ref_scene, CAM, res=24, spp=ref_spp, max_depth=3,
                                         seed=5)
    se = np.sqrt(ours_var / spp + ref_var / ref_spp) + 0.015 * (ref + 0.05)
    z = np.abs(ours - ref) / se
    frac_ok = float(np.mean(z < 4.0))
    assert frac_ok > 0.98, (frac_ok, float(z.max()))
    assert abs(ours.mean() - ref.mean()) / ref.mean() < 0.05, (ours.mean(), ref.mean())


@pytest.mark.slow
def test_config2_gradient_fd_vs_ad(tmp_path):
    """tests/test_golden_path.py's gradient anchor: the mean image's
    derivative in the floor's roughness (alpha_u and alpha_v together) by
    AD (the path tracer in ad_mode, detached path replay) against a
    central difference (step 0.02) of the primal render on the same
    seeds, averaged over seeds 3-5 at 96 spp: within 35 % (or 0.007)."""
    scene, _ = _path_scene_pair(str(tmp_path))
    key, key_v = "bsdf.roughconductor.alpha_u", "bsdf.roughconductor.alpha_v"
    spp, eps, seeds = 96, 0.02, (3, 4, 5)

    def mean_img(alpha, seed):
        sc = params_mod.update(scene, {key: alpha, key_v: alpha})
        return mt.render(sc, spp, seed, "path", None, True).mean()

    a0 = params_mod.traverse(scene)[key].detach()
    g_ad = fd = 0.0
    for s in seeds:
        a = a0.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(mean_img(a, s), a)
        g_ad += float(g.sum())
        with torch.no_grad():
            fd += float(mean_img(a0 + eps, s) - mean_img(a0 - eps, s)) / (2 * eps)
    g_ad /= len(seeds)
    fd /= len(seeds)
    assert np.isfinite(g_ad) and np.isfinite(fd)
    assert abs(g_ad - fd) < 0.35 * max(abs(fd), 0.02), (g_ad, fd)

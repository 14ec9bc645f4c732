"""The port's BASELINE configs[0] (sphere + diffuse or MERL, direct
illumination under a constant emitter) against the independent numpy
renderer of tests/reference_renderer.py, with the gates of
tests/test_golden.py: the port's first check that does not go through the
JAX package (no number here comes from it).
"""

import numpy as np

import mitsuba_customization_tpu_torch as mt
from mitsuba_customization_tpu_torch.scenes import config0_dict
from reference_renderer import render_sphere_furnace
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

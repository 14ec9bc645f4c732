"""The port's scene loader and whole frame against the JAX package.

The flagship scene at a small size (res 16, spp 4, depth 3, seed 0). The
sampler is bit-identical, so the frames differ only where a lane branches
differently on an ulp-level gap (Russian roulette, CDF inversion, edge
hits): per-channel means within 1 %, >= 95 % of pixels within
atol 1e-3 + rtol 1e-3.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import mitsuba_customization_tpu as mct
import mitsuba_customization_tpu_torch as mt
from mitsuba_customization_tpu.render.integrator import render as jax_render
from mitsuba_customization_tpu_torch.models import bsdf as tbsdf
from mitsuba_customization_tpu_torch.render.params import scene_from_numpy
from mitsuba_customization_tpu_torch.scenes import flagship_dict
from test_torch_kernels import one_torch_thread  # noqa: F401

RES, SPP, DEPTH = 16, 4, 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_scene():
    return mct.load_dict(flagship_dict(RES, SPP, DEPTH))


@pytest.fixture(scope="module")
def jax_frame(jax_scene):
    """(image, rays traced) of the JAX package's render, one compile."""
    img, stats = jax.jit(
        lambda s: jax_render(s, SPP, 0, return_stats=True)
    )(jax_scene)
    return np.asarray(img), float(stats["rays_traced"])


def _arrays(scene):
    leaves, _ = jax.tree_util.tree_flatten_with_path(scene)
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in leaves}


def _assert_frames_agree(got, want):
    assert got.shape == want.shape == (RES, RES, 3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)), rtol=0.01)
    close = (np.abs(got - want) <= 1e-3 + 1e-3 * np.abs(want)).all(-1)
    assert close.mean() >= 0.95, close.mean()


def test_scene_from_numpy_matches_load_dict(jax_scene):
    """The port's own loader builds what the JAX package built."""
    ref = scene_from_numpy(_arrays(jax_scene), jax_scene.config)
    own = mt.load_dict(flagship_dict(RES, SPP, DEPTH), "cpu")
    assert own.config == ref.config
    for a, b in zip(own.geometry, ref.geometry):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(own.bsdfs.mat_type, ref.bsdfs.mat_type)
    torch.testing.assert_close(own.bsdfs.mat_slot, ref.bsdfs.mat_slot)
    assert own.bsdfs.present_kernels == ref.bsdfs.present_kernels
    for kid in (tbsdf.DIFFUSE, tbsdf.ROUGHCONDUCTOR):
        for a, b in zip(own.bsdfs.stacks[kid], ref.bsdfs.stacks[kid]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    tab, tab_ref = own.bsdfs.stacks[tbsdf.TABULATED], ref.bsdfs.stacks[tbsdf.TABULATED]
    torch.testing.assert_close(tab.table, tab_ref.table, rtol=0, atol=0)
    for a, b in zip(tab.sampling, tab_ref.sampling):  # the MERL sampling CDFs
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    em, em_ref = own.emitters, ref.emitters
    torch.testing.assert_close(em.em_type, em_ref.em_type)
    torch.testing.assert_close(em.radiance, em_ref.radiance, rtol=0, atol=0)
    for a, b in zip(em.select, em_ref.select):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert em.background_index == em_ref.background_index
    for a, b in zip(own.sensor, ref.sensor):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_frame_matches_jax(jax_scene, jax_frame):
    """Whole frame on identical scene arrays: port against JAX."""
    scene = scene_from_numpy(_arrays(jax_scene), jax_scene.config)
    img, stats = mt.render(scene, spp=SPP, seed=0, return_stats=True)
    _assert_frames_agree(img.numpy(), jax_frame[0])
    assert stats["rays_traced"] == jax_frame[1]


def test_frame_own_loader_matches_jax(jax_frame):
    """Whole frame through the port's own load_dict -> render."""
    img = mt.render(mt.load_dict(flagship_dict(RES, SPP, DEPTH), "cpu"),
                    spp=SPP, seed=0)
    _assert_frames_agree(img.numpy(), jax_frame[0])


def test_port_imports_no_jax():
    """Importing every module of the port pulls in neither JAX nor the JAX
    package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mitsuba_customization_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.split('.')[0] == 'mitsuba_customization_tpu']\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr

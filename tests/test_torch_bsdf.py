"""The port's BSDFs against the JAX package on the same numpy inputs.

Tabulated `bounce_shade` runs the JAX side through its production TPU
kernels in Pallas interpret mode (as tests/test_ops.py does); the port
runs its kernels' plain versions. Diffuse and GGX roughconductor eval /
pdf / sample, and the dispatch table's fused bounce over all three
kernels, are compared as well.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_customization_tpu.models import bsdf as jbsdf
from mitsuba_customization_tpu.models import diffuse as jdiff
from mitsuba_customization_tpu.models import roughconductor as jrough
from mitsuba_customization_tpu.models import tabulated as jtab
from mitsuba_customization_tpu.render.scene import load_dict as jload_dict
from mitsuba_customization_tpu_torch.core.distr import Marginal2D
from mitsuba_customization_tpu_torch.models import bsdf as tbsdf
from mitsuba_customization_tpu_torch.models import diffuse as tdiff
from mitsuba_customization_tpu_torch.models import roughconductor as trough
from mitsuba_customization_tpu_torch.models import tabulated as ttab
from mitsuba_customization_tpu_torch.render.params import scene_from_numpy
from mitsuba_customization_tpu_torch.scenes import flagship_dict
from test_torch_kernels import one_torch_thread, smooth_table  # noqa: F401

NAMES = ("f_nee", "pdf_nee", "wo", "pdf_s", "weight", "is_delta")


@pytest.fixture
def sorted_paths():
    """Force the JAX package's production TPU kernels, in interpret mode."""
    ep, sp, ip = jtab.EVAL_PATH, jtab.SAMPLE_PATH, jtab.INTERPRET
    jtab.EVAL_PATH, jtab.SAMPLE_PATH, jtab.INTERPRET = "sorted", "sorted", True
    yield
    jtab.EVAL_PATH, jtab.SAMPLE_PATH, jtab.INTERPRET = ep, sp, ip


def _unit(rng, n, hemi=True):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    if hemi:
        v[:, 2] = np.abs(v[:, 2]) + 1e-3
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _t(x):
    return torch.as_tensor(np.array(x))


def _compare(got, want, lanes, names=NAMES, atol=1e-7):
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g)[lanes], np.asarray(w)[lanes]
        if name == "wo":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=name)
        elif name == "is_delta":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol, err_msg=name)


def _shade_inputs(rng, n):
    wi = _unit(rng, n)
    wi[:40, 2] *= -1  # below the horizon
    return dict(
        wi=wi, wo_nee=_unit(rng, n, hemi=False),
        sample2=rng.random((n, 2)).astype(np.float32),
        sample1=rng.random(n).astype(np.float32),
    )


def test_tabulated_build_matches_jax():
    rng = np.random.default_rng(0)
    tables = np.stack([smooth_table(rng) for _ in range(2)])
    got = ttab.TabulatedBRDF.build_stack(_t(tables)).sampling
    want = jax.jit(jtab.TabulatedBRDF.build_stack)(jnp.asarray(tables)).sampling
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_tabulated_bounce_shade_matches_jax(sorted_paths):
    rng = np.random.default_rng(0)
    tables = np.stack([smooth_table(rng) for _ in range(2)])
    jparams = jtab.TabulatedBRDF.build_stack(jnp.asarray(tables))
    # identical sampling CDFs on both sides
    tparams = ttab.TabulatedBRDF(
        table=_t(tables),
        sampling=Marginal2D(*(_t(f) for f in jparams.sampling)),
    )
    n = 1500
    d = _shade_inputs(rng, n)
    slot = rng.integers(0, 2, n).astype(np.int32)
    mask = rng.random(n) > 0.3
    mask_nee = mask & (rng.random(n) > 0.2)
    want = jtab.bounce_shade(
        jparams, *(jnp.asarray(d[k]) for k in d), slot=jnp.asarray(slot),
        mask=jnp.asarray(mask), mask_nee=jnp.asarray(mask_nee),
    )
    got = ttab.bounce_shade(
        tparams, *(_t(d[k]) for k in d), slot=_t(slot), mask=_t(mask),
        mask_nee=_t(mask_nee),
    )
    assert got[0].shape == (n, 3) and got[2].shape == (n, 3)
    _compare(got, want, mask)  # dispatch discards masked-out lanes


def _lane_params(rng, n):
    alpha = rng.uniform(0.05, 0.6, n).astype(np.float32)
    return dict(
        diffuse=dict(reflectance=rng.random((n, 3)).astype(np.float32)),
        roughconductor=dict(
            alpha_u=alpha, alpha_v=(alpha * rng.uniform(0.5, 1.5, n)).astype(np.float32),
            eta=rng.uniform(0.2, 1.5, (n, 3)).astype(np.float32),
            k=rng.uniform(1.0, 4.0, (n, 3)).astype(np.float32),
            specular_reflectance=rng.random((n, 3)).astype(np.float32),
        ),
    )


@pytest.mark.parametrize("kind", ["diffuse", "roughconductor"])
@pytest.mark.parametrize("fn", ["eval", "pdf", "sample"])
def test_analytic_bsdf_matches_jax(kind, fn):
    rng = np.random.default_rng(5)
    n = 4000
    p = _lane_params(rng, n)[kind]
    jmod, tmod = {"diffuse": (jdiff, tdiff), "roughconductor": (jrough, trough)}[kind]
    jp = (jdiff.DiffuseParams if kind == "diffuse" else jrough.RoughConductorParams)(
        **{k: jnp.asarray(v) for k, v in p.items()})
    tp = (tdiff.DiffuseParams if kind == "diffuse" else trough.RoughConductorParams)(
        **{k: _t(v) for k, v in p.items()})
    wi = _unit(rng, n)
    wi[:40, 2] *= -1
    if fn == "sample":
        u2, u1 = rng.random((n, 2)).astype(np.float32), rng.random(n).astype(np.float32)
        want = jmod.sample(jp, jnp.asarray(wi), jnp.asarray(u2), jnp.asarray(u1))
        got = tmod.sample(tp, _t(wi), _t(u2), _t(u1))
        _compare(got, want, slice(None), names=("wo", "pdf", "weight", "is_delta"),
                 atol=1e-6)
    else:
        wo = _unit(rng, n, hemi=False)
        want = getattr(jmod, fn)(jp, jnp.asarray(wi), jnp.asarray(wo))
        got = getattr(tmod, fn)(tp, _t(wi), _t(wo))
        # atol: GGX's 1/(4 |wo.h|) magnifies ulps where wo grazes h
        _compare([got], [want], slice(None), names=(fn,), atol=1e-6)


@pytest.mark.parametrize("fn", ["eval", "pdf", "sample"])
def test_dispatch_analytic_matches_jax(fn):
    """eval / pdf / sample through the dispatch table: two diffuse and two
    roughconductor materials, per-lane material ids."""
    rng = np.random.default_rng(11)
    p = _lane_params(rng, 2)
    mat_type = np.asarray([tbsdf.DIFFUSE, tbsdf.ROUGHCONDUCTOR,
                           tbsdf.ROUGHCONDUCTOR, tbsdf.DIFFUSE], np.int32)
    mat_slot = np.asarray([0, 0, 1, 1], np.int32)
    jtable = jbsdf.BSDFTable(
        mat_type=jnp.asarray(mat_type), mat_slot=jnp.asarray(mat_slot),
        stacks={
            jbsdf.DIFFUSE: jdiff.DiffuseParams(
                **{k: jnp.asarray(v) for k, v in p["diffuse"].items()}),
            jbsdf.ROUGHCONDUCTOR: jrough.RoughConductorParams(
                **{k: jnp.asarray(v) for k, v in p["roughconductor"].items()}),
        },
    )
    ttable = tbsdf.BSDFTable(
        mat_type=_t(mat_type.astype(np.int64)), mat_slot=_t(mat_slot.astype(np.int64)),
        stacks={
            tbsdf.DIFFUSE: tdiff.DiffuseParams(
                **{k: _t(v) for k, v in p["diffuse"].items()}),
            tbsdf.ROUGHCONDUCTOR: trough.RoughConductorParams(
                **{k: _t(v) for k, v in p["roughconductor"].items()}),
        },
    )
    n = 3000
    mat_id = rng.integers(0, 4, n)
    wi = _unit(rng, n)
    wi[:40, 2] *= -1
    second = (rng.random((n, 2)).astype(np.float32) if fn == "sample"
              else _unit(rng, n, hemi=False))
    want = getattr(jbsdf, fn)(jtable, jnp.asarray(mat_id, jnp.int32),
                              jnp.asarray(wi), jnp.asarray(second))
    got = getattr(tbsdf, fn)(ttable, _t(mat_id), _t(wi), _t(second))
    if fn == "sample":
        _compare(got, want, slice(None), names=("wo", "pdf", "weight", "is_delta"),
                 atol=1e-6)
    else:
        _compare([got], [want], slice(None), names=(fn,), atol=1e-6)


def test_dispatch_bounce_shade_matches_jax(sorted_paths):
    """The dispatch table's fused bounce over the flagship's three kernels
    (diffuse, GGX roughconductor, MERL table), per-lane material ids."""
    jscene = jload_dict(flagship_dict(8, 1, 2))
    leaves, _ = jax.tree_util.tree_flatten_with_path(jscene)
    arrays = {jax.tree_util.keystr(p): np.asarray(x) for p, x in leaves}
    tscene = scene_from_numpy(arrays, jscene.config)
    rng = np.random.default_rng(7)
    n = 1200
    d = _shade_inputs(rng, n)
    mat_id = rng.integers(0, 3, n).astype(np.int32)
    active = rng.random(n) > 0.2
    nee_mask = active & (rng.random(n) > 0.3)
    want = jbsdf.bounce_shade(
        jscene.bsdfs, jnp.asarray(mat_id), *(jnp.asarray(d[k]) for k in d),
        active=jnp.asarray(active), nee_mask=jnp.asarray(nee_mask),
    )[:6]
    got = tbsdf.bounce_shade(
        tscene.bsdfs, _t(mat_id.astype(np.int64)), *(_t(d[k]) for k in d),
        active=_t(active), nee_mask=_t(nee_mask),
    )
    # f_nee / pdf_nee are compared where the NEE sample is live; the
    # analytic kernels evaluate every lane, the tabulated one only those
    nee = nee_mask
    _compare(got[:2], want[:2], nee, names=NAMES[:2])
    _compare(got[2:], want[2:], active, names=NAMES[2:])

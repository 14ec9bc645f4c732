"""The port's analytic, transmissive and blended BSDFs against the JAX
package on the same numpy inputs.

Every new kernel (and the Beckmann roughconductor) is compared by eval,
pdf and sample on per-lane parameters, with incident directions on both
sides of the horizon for the transmissive kernels. The dispatch layer's
mixture eval / pdf / sample and the blended bounce are compared on a
table with blendbsdf and mask over MERL children, the JAX side running its
production tabulated kernels in Pallas interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_customization_tpu.models import bsdf as jbsdf
from mitsuba_customization_tpu.models import conductor as jcond
from mitsuba_customization_tpu.models import dielectric as jdiel
from mitsuba_customization_tpu.models import passthrough as jpass
from mitsuba_customization_tpu.models import plastic as jplastic
from mitsuba_customization_tpu.models import principled as jprinc
from mitsuba_customization_tpu.models import roughconductor as jrough
from mitsuba_customization_tpu.models import roughdielectric as jrdiel
from mitsuba_customization_tpu.models import roughplastic as jrplastic
from mitsuba_customization_tpu.models import thindielectric as jthin
from mitsuba_customization_tpu.render.scene import load_dict as jload_dict
from mitsuba_customization_tpu_torch.models import bsdf as tbsdf
from mitsuba_customization_tpu_torch.models import conductor as tcond
from mitsuba_customization_tpu_torch.models import dielectric as tdiel
from mitsuba_customization_tpu_torch.models import passthrough as tpass
from mitsuba_customization_tpu_torch.models import plastic as tplastic
from mitsuba_customization_tpu_torch.models import principled as tprinc
from mitsuba_customization_tpu_torch.models import roughconductor as trough
from mitsuba_customization_tpu_torch.models import roughdielectric as trdiel
from mitsuba_customization_tpu_torch.models import roughplastic as trplastic
from mitsuba_customization_tpu_torch.models import thindielectric as tthin
from mitsuba_customization_tpu_torch.ops import merl_sorted
from mitsuba_customization_tpu_torch.render.params import scene_from_numpy
from test_torch_bsdf import sorted_paths  # noqa: F401
from test_torch_kernels import one_torch_thread, smooth_table  # noqa: F401

RTOL, ATOL, WO_ATOL = 1e-5, 1e-6, 1e-5
# lanes within NEAR of grazing or of the critical angle may branch apart
# on an ulp; at most NEAR_SHARE of the lanes may differ there
NEAR, NEAR_SHARE = 1e-4, 1e-3
N = 4000


def _unit(rng, n, hemi):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    if hemi:
        v[:, 2] = np.abs(v[:, 2]) + 1e-3
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _t(x):
    return torch.as_tensor(np.array(x))


def _params(rng, kind, n):
    """Per-lane parameters of `kind` as numpy arrays (field -> array)."""
    u = rng.uniform
    rgb = lambda: rng.random((n, 3)).astype(np.float32)  # noqa: E731
    f32 = lambda lo, hi: u(lo, hi, n).astype(np.float32)  # noqa: E731
    if kind == "conductor":
        return dict(eta=u(0.2, 1.5, (n, 3)).astype(np.float32),
                    k=u(1.0, 4.0, (n, 3)).astype(np.float32), specular_reflectance=rgb())
    if kind == "roughconductor_beckmann":
        alpha = f32(0.05, 0.6)
        return dict(alpha_u=alpha, alpha_v=(alpha * u(0.5, 1.5, n)).astype(np.float32),
                    eta=u(0.2, 1.5, (n, 3)).astype(np.float32),
                    k=u(1.0, 4.0, (n, 3)).astype(np.float32), specular_reflectance=rgb())
    if kind in ("dielectric", "thindielectric"):
        return dict(eta=f32(0.6, 2.2), specular_reflectance=rgb(),
                    specular_transmittance=rgb())
    if kind == "roughdielectric":
        return dict(eta=f32(0.6, 2.2), alpha=f32(0.05, 0.6), specular_reflectance=rgb(),
                    specular_transmittance=rgb())
    if kind == "plastic":
        return dict(diffuse_reflectance=rgb(), specular_reflectance=rgb(),
                    eta=f32(1.1, 2.0))
    if kind == "roughplastic":
        return dict(diffuse_reflectance=rgb(), specular_reflectance=rgb(),
                    eta=f32(1.1, 2.0), alpha=f32(0.05, 0.6))
    if kind == "principled":
        scalars = ("anisotropic", "metallic", "spec_tint", "specular", "sheen",
                   "sheen_tint", "clearcoat", "clearcoat_gloss", "flatness")
        return dict(base_color=rgb(), roughness=f32(0.05, 1.0),
                    **{k: f32(0.0, 1.0) for k in scalars})
    assert kind == "passthrough"
    return dict(transmittance=rgb())


# kind -> (JAX module, port module, JAX params type, port params type)
KINDS = {
    "conductor": (jcond, tcond, jcond.ConductorParams, tcond.ConductorParams),
    "roughconductor_beckmann": (jbsdf._BeckmannKernel, tbsdf._BeckmannKernel,
                                jrough.RoughConductorParams, trough.RoughConductorParams),
    "dielectric": (jdiel, tdiel, jdiel.DielectricParams, tdiel.DielectricParams),
    "thindielectric": (jthin, tthin, jthin.ThinDielectricParams,
                       tthin.ThinDielectricParams),
    "roughdielectric": (jrdiel, trdiel, jrdiel.RoughDielectricParams,
                        trdiel.RoughDielectricParams),
    "plastic": (jplastic, tplastic, jplastic.PlasticParams, tplastic.PlasticParams),
    "roughplastic": (jrplastic, trplastic, jrplastic.RoughPlasticParams,
                     trplastic.RoughPlasticParams),
    "principled": (jprinc, tprinc, jprinc.PrincipledParams, tprinc.PrincipledParams),
    "passthrough": (jpass, tpass, jpass.PassthroughParams, tpass.PassthroughParams),
}
TRANSMISSIVE = ("dielectric", "thindielectric", "roughdielectric", "passthrough")


def _near_threshold(kind, p, wi, wo):
    """Lanes within NEAR of grazing (wi or wo) or, for the dielectrics, of
    the critical angle at wi (or at the micronormal of (wi, wo))."""
    near = (np.abs(wi[:, 2]) < NEAR) | (np.abs(wo[:, 2]) < NEAR)
    if kind in ("dielectric", "thindielectric", "roughdielectric"):
        eta = p["eta"].astype(np.float64)
        cosines = [wi[:, 2]]
        if kind == "roughdielectric":
            refl = wi[:, 2] * wo[:, 2] > 0
            eta_it = np.where(wi[:, 2] >= 0, eta, 1 / eta)
            h = wi + wo * np.where(refl, 1.0, eta_it)[:, None]
            h /= np.maximum(np.linalg.norm(h, axis=-1, keepdims=True), 1e-30)
            cosines.append((wi * h).sum(-1))
        for c in cosines:
            eta_ti = np.where(c >= 0, 1 / eta, eta)
            near |= np.abs(eta_ti ** 2 * (1 - c.astype(np.float64) ** 2) - 1) < NEAR
    return near


def _differ(name, g, w):
    """Per lane: does the port's value differ from the reference's beyond
    the tolerance?"""
    g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
    if name == "is_delta":
        return g != w
    if name == "wo":
        bad = np.abs(g - w) > WO_ATOL
    else:
        bad = ~np.isclose(g, w, rtol=RTOL, atol=ATOL)
    return bad.reshape(bad.shape[0], -1).any(-1)


@pytest.mark.parametrize("kind", list(KINDS))
def test_kernel_matches_jax(kind):
    """eval, pdf and sample of one kernel against the JAX module: f, pdf and
    weight within rtol 1e-5 / atol 1e-6, wo within atol 1e-5, is_delta
    equal; lanes near grazing or the critical angle may differ on at most
    0.1 % of the lanes (the count is printed).

    A smooth sample's pdf and weight are the kernel's pdf and eval / pdf at
    the sampled direction: they are held to the JAX module's at the
    port's direction, since a sharp lobe magnifies the ulps in which the
    two directions differ (torch's and XLA's log, sin and cos); delta
    samples are held to the JAX sample's values."""
    rng = np.random.default_rng(100 + list(KINDS).index(kind))
    jmod, tmod, jtype, ttype = KINDS[kind]
    p = _params(rng, kind, N)
    jp = jtype(**{k: jnp.asarray(v) for k, v in p.items()})
    tp = ttype(**{k: _t(v) for k, v in p.items()})
    wi = _unit(rng, N, hemi=kind not in TRANSMISSIVE)
    if kind not in TRANSMISSIVE:
        wi[:40, 2] *= -1
    wo = _unit(rng, N, hemi=False)
    u2 = rng.random((N, 2)).astype(np.float32)
    u1 = rng.random(N).astype(np.float32)

    def jax_at(wo_):
        """The JAX module's (pdf, eval / pdf) at wo_."""
        f = np.asarray(jmod.eval(jp, jnp.asarray(wi), jnp.asarray(wo_)), np.float64)
        pdf = np.asarray(jmod.pdf(jp, jnp.asarray(wi), jnp.asarray(wo_)), np.float64)
        return pdf, np.where(pdf[:, None] > 0, f / np.where(pdf > 0, pdf, 1)[:, None], 0)

    checks = []
    for fn in ("eval", "pdf"):
        want = getattr(jmod, fn)(jp, jnp.asarray(wi), jnp.asarray(wo))
        got = getattr(tmod, fn)(tp, _t(wi), _t(wo))
        checks.append((fn, got, want, wo))
    for first in (u1, None):  # the lobe choice given, and drawn from sample2
        args = (jnp.asarray(u2),) + (() if first is None else (jnp.asarray(first),))
        want = [np.asarray(x) for x in jmod.sample(jp, jnp.asarray(wi), *args)]
        got = [x.numpy() for x in tmod.sample(tp, _t(wi), _t(u2),
                                              None if first is None else _t(first))]
        smooth = ~got[3] & (got[1] > 0)
        at_port = jax_at(got[0])
        for i, name in enumerate(("wo", "pdf", "weight", "is_delta")):
            w = want[i]
            if name in ("pdf", "weight"):
                w = np.where(smooth.reshape((-1,) + (1,) * (w.ndim - 1)),
                             at_port[i - 1], w)
            checks.append((name, got[i], w, want[0]))
    bad = np.zeros(N, bool)
    near = np.zeros(N, bool)
    for name, g, w, wo_c in checks:
        d = _differ(name, g, w)
        bad |= d
        near |= d & _near_threshold(kind, p, wi, wo_c)
    far = bad & ~near
    print(f"{kind}: {int(bad.sum())} of {N} lanes differ, {int(near.sum())} of them "
          f"near grazing or the critical angle")
    assert not far.any(), f"{int(far.sum())} lanes differ away from the thresholds"
    assert near.sum() <= NEAR_SHARE * N


# ---- the dispatch layer with blends over MERL children -------------------


def _blend_scene(tables):
    """Spheres of: merl, blendbsdf(merl, roughplastic), mask(merl), diffuse,
    and plastic (a per-lane delta lobe)."""
    merl = [{"type": "merl", "table": t} for t in tables]
    bsdfs = [
        merl[0],
        {"type": "blendbsdf", "weight": 0.3, "a": merl[1],
         "b": {"type": "roughplastic", "alpha": 0.2}},
        {"type": "mask", "opacity": 0.6, "bsdf": merl[2]},
        {"type": "diffuse", "reflectance": [0.3, 0.5, 0.7]},
        {"type": "plastic"},
    ]
    d = {"type": "scene", "light": {"type": "constant"}}
    for i, b in enumerate(bsdfs):
        d[f"s{i}"] = {"type": "sphere", "center": [3.0 * i, 0, 5], "bsdf": b}
    return d


@pytest.fixture(scope="module")
def blend_tables():
    rng = np.random.default_rng(3)
    tables = [smooth_table(rng) for _ in range(3)]
    jscene = jload_dict(_blend_scene(tables))
    leaves, _ = jax.tree_util.tree_flatten_with_path(jscene)
    arrays = {jax.tree_util.keystr(p): np.asarray(x) for p, x in leaves}
    return jscene, scene_from_numpy(arrays, jscene.config, "cpu")


def _lanes(rng, n, n_mat):
    wi = _unit(rng, n, hemi=True)
    wi[:30, 2] *= -1
    return dict(mat_id=rng.integers(0, n_mat, n), wi=wi,
                wo=_unit(rng, n, hemi=False), u2=rng.random((n, 2)).astype(np.float32),
                u1=rng.random(n).astype(np.float32))


def _close(name, got, want, lanes=slice(None)):
    g, w = np.asarray(got)[lanes], np.asarray(want)[lanes]
    if name == "wo":
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=name)
    elif g.dtype == bool:
        np.testing.assert_array_equal(g, w, err_msg=name)
    else:
        # the tabulated pdf inverts 16-bit-free float CDFs on both sides;
        # K1's plain version against the JAX packed eval: rtol 1e-4
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("fn", ["eval", "pdf", "sample", "bounce_shade"])
def test_blend_dispatch_matches_jax(blend_tables, sorted_paths, monkeypatch, fn):
    """The mixture eval / pdf / sample and the blended bounce_shade on a
    table with blendbsdf and mask over MERL children (plus diffuse and
    plastic), against the JAX package; the K1 launches of a blended bounce
    follow the JAX composition (one per tabulated eval)."""
    jscene, tscene = blend_tables
    jt, tt = jscene.bsdfs, tscene.bsdfs
    assert tt.blend_a is not None
    n_mat = int(tt.mat_type.shape[0])
    d = _lanes(np.random.default_rng(17), 1500, n_mat)
    mid = d["mat_id"]
    ja = {k: jnp.asarray(v) for k, v in d.items()}
    ta = {k: _t(v) for k, v in d.items()}
    if fn in ("eval", "pdf"):
        want = getattr(jbsdf, fn)(jt, ja["mat_id"], ja["wi"], ja["wo"])
        got = getattr(tbsdf, fn)(tt, ta["mat_id"], ta["wi"], ta["wo"])
        _close(fn, got, want)
    elif fn == "sample":
        want = jbsdf.sample(jt, ja["mat_id"], ja["wi"], ja["u2"], ja["u1"])
        got = tbsdf.sample(tt, ta["mat_id"], ta["wi"], ta["u2"], ta["u1"])
        for name, g, w in zip(("wo", "pdf", "weight", "is_delta"), got, want):
            _close(name, g, w)
    else:
        rng = np.random.default_rng(5)
        active = rng.random(len(mid)) > 0.2
        nee = active & (rng.random(len(mid)) > 0.3)
        want = jbsdf.bounce_shade(jt, ja["mat_id"], ja["wi"], ja["wo"], ja["u2"],
                                  ja["u1"], active=jnp.asarray(active),
                                  nee_mask=jnp.asarray(nee))[:6]
        calls = []
        k1 = merl_sorted.eval_trilinear

        def counted(*args, **kwargs):
            calls.append(args[5])  # wo_b: None for a call with one half
            return k1(*args, **kwargs)

        monkeypatch.setattr(merl_sorted, "eval_trilinear", counted)
        got = tbsdf.bounce_shade(tt, ta["mat_id"], ta["wi"], ta["wo"], ta["u2"],
                                 ta["u1"], active=_t(active), nee_mask=_t(nee))
        # sample: the child's tabulated sample (1 eval) and the balance
        # weight's mixture eval (2); eval_pdf toward the NEE direction (2);
        # each a K1 call with one half
        assert len(calls) == 5 and all(c is None for c in calls)
        names = ("f_nee", "pdf_nee", "wo", "pdf_s", "weight", "is_delta")
        for i, (name, g, w) in enumerate(zip(names, got, want)):
            _close(name, g, w, nee if i < 2 else active)


def test_blend_table_helpers_match_jax(blend_tables):
    """BSDFTable.is_delta (a blend is delta where both children are) and
    resolve_children against the JAX package's on every material."""
    jscene, tscene = blend_tables
    n_mat = int(tscene.bsdfs.mat_type.shape[0])
    ids = np.arange(n_mat)
    np.testing.assert_array_equal(tscene.bsdfs.is_delta(_t(ids)).numpy(),
                                  np.asarray(jscene.bsdfs.is_delta(jnp.asarray(ids))))
    for g, w in zip(tscene.bsdfs.resolve_children(_t(ids)),
                    jscene.bsdfs.resolve_children(jnp.asarray(ids))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

"""Chi-square tests of the port's own samplers against its own pdfs.

Every ChiSquareTest case of the JAX suite (tests/test_warp.py,
test_bsdf.py, test_bsdf2.py, test_principled.py, test_media.py,
test_distr.py) has a counterpart here on the port's sample / pdf, run on
CPU tensors through the port's copy of the harness
(mitsuba_customization_tpu_torch/utils/chi2.py) at the JAX test's sample
count, resolution, sub-integration resolution, seed and Sidak count. The
parity tests hold the port's samplers to the JAX ones lane by lane; a bias
the two share would pass those, but not these. Beside them: the isotropic
phase function (the JAX suite tests HG and Rayleigh only), the envmap's
sampling against its miss pdf, one case that holds the harness itself to
the JAX one on the same numpy functions, and the SGGX phase sampler, which
the JAX package gets wrong (its directions fail against its own pdf) and
the port takes from the paper's listing.
"""

import numpy as np
import pytest
import torch

from fixtures import synthetic_table
from mitsuba_customization_tpu_torch.core import warp
from mitsuba_customization_tpu_torch.core.distr import Marginal2D
from mitsuba_customization_tpu_torch.models import (
    diffuse,
    microfacet as mf,
    phase,
    plastic,
    principled,
    roughconductor,
    roughdielectric as rd,
    roughplastic,
    tabulated,
)
from mitsuba_customization_tpu_torch.utils.chi2 import (
    ChiSquareTest,
    PlanarDomain,
    SphericalDomain,
)
from test_torch_kernels import one_torch_thread  # noqa: F401


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _unit(v):
    v = np.asarray(v, np.float32)
    return v / np.linalg.norm(v)


# ------------------------------------------------------------- warps (test_warp.py)

N_WARP = 200_000


def _spherical_chi2(sample_fn, pdf_fn):
    test = ChiSquareTest(SphericalDomain(), lambda u: sample_fn(_t(u)).numpy(),
                         lambda d: pdf_fn(_t(d)).numpy(), sample_count=N_WARP, res=31)
    assert test.run(test_count=8), test.messages


@pytest.mark.parametrize("name", ["cosine_hemisphere", "uniform_hemisphere", "uniform_sphere"])
def test_warp_chi2(name):
    _spherical_chi2(getattr(warp, f"square_to_{name}"), getattr(warp, f"square_to_{name}_pdf"))


@pytest.mark.parametrize("cutoff", [-1 + 2 * 24 / 31, -1 + 2 * 30 / 31])
def test_uniform_cone_chi2(cutoff):
    _spherical_chi2(lambda u: warp.square_to_uniform_cone(u, cutoff),
                    lambda d: warp.square_to_uniform_cone_pdf(d, cutoff))


def test_concentric_disk_chi2():
    def pdf(p):
        inside = np.sum(p ** 2, -1) <= 1.0
        return np.where(inside, warp.square_to_uniform_disk_concentric_pdf(_t(p)).numpy(), 0.0)

    test = ChiSquareTest(PlanarDomain(np.array([[-1, 1], [-1, 1]])),
                         lambda u: warp.square_to_uniform_disk_concentric(_t(u)).numpy(), pdf,
                         sample_count=N_WARP, res=31)
    assert test.run(), test.messages


# ------------------------------------------------------------- BSDFs (test_bsdf.py)

WI = _unit([0.35, 0.2, 0.916])


def _chi2_bsdf(sample_fn, pdf_fn, wi=WI, n=150_000, seed=0, test_count=8, u1_seed=None):
    """The JAX suite's BSDFAdapter pattern: wo sampled at a fixed wi,
    samples with pdf 0 dropped, against pdf at that wi. u1_seed: a third
    random number per sample from numpy's generator (test_bsdf2.py)."""
    rng = None if u1_seed is None else np.random.default_rng(u1_seed)

    def s(u):
        wi_t = _t(wi).expand(len(u), 3)
        u1 = None if rng is None else _t(rng.uniform(size=len(u)))
        wo, p = sample_fn(wi_t, _t(u), u1)[:2]
        return wo.numpy(), (p.numpy() > 0).astype(np.float64)

    def pf(d):
        return pdf_fn(_t(wi).expand(len(d), 3), _t(d)).numpy()

    test = ChiSquareTest(SphericalDomain(), s, pf, sample_count=n, res=25, ires=16, seed=seed)
    assert test.run(test_count=test_count), test.messages


def _rc_params(alpha):
    return roughconductor.RoughConductorParams(
        alpha_u=_t(alpha), alpha_v=_t(alpha), eta=_t([0.2, 0.9, 1.4]), k=_t([3.9, 2.5, 2.1]),
        specular_reflectance=torch.ones(3))


def test_diffuse_chi2():
    p = diffuse.DiffuseParams(reflectance=_t([0.8, 0.8, 0.8]))
    _chi2_bsdf(lambda wi, u, u1: diffuse.sample(p, wi, u), lambda wi, wo: diffuse.pdf(p, wi, wo))


def test_roughconductor_beckmann_chi2():
    p = _rc_params(0.3)
    _chi2_bsdf(lambda wi, u, u1: roughconductor.sample(p, wi, u, dist_type=mf.BECKMANN),
               lambda wi, wo: roughconductor.pdf(p, wi, wo, dist_type=mf.BECKMANN))


@pytest.mark.parametrize("alpha", [0.1, 0.4])
def test_roughconductor_chi2(alpha):
    p = _rc_params(alpha)
    _chi2_bsdf(lambda wi, u, u1: roughconductor.sample(p, wi, u),
               lambda wi, wo: roughconductor.pdf(p, wi, wo))


def test_plastic_chi2():
    """The smooth (diffuse) lobe; delta samples are dropped."""
    p = plastic.PlasticParams(diffuse_reflectance=_t([0.5, 0.3, 0.2]),
                              specular_reflectance=torch.ones(3), eta=_t(1.49))

    def smooth_only(wi, u, u1):
        wo, pdf, _, is_d = plastic.sample(p, wi, u)
        return wo, torch.where(is_d, 0.0, pdf)

    _chi2_bsdf(smooth_only, lambda wi, wo: plastic.pdf(p, wi, wo))


def test_roughplastic_chi2():
    p = roughplastic.RoughPlasticParams(diffuse_reflectance=_t([0.5, 0.3, 0.2]),
                                        specular_reflectance=torch.ones(3), eta=_t(1.49),
                                        alpha=_t(0.3))
    _chi2_bsdf(lambda wi, u, u1: roughplastic.sample(p, wi, u),
               lambda wi, wo: roughplastic.pdf(p, wi, wo))


def test_merl_chi2():
    """The tabulated sampler (K2's plain version on CPU tensors) against
    the tabulated pdf, on the JAX test's synthetic table."""
    brdf = tabulated.TabulatedBRDF.build(torch.as_tensor(synthetic_table()))
    _chi2_bsdf(lambda wi, u, u1: tabulated.sample(brdf, wi, u),
               lambda wi, wo: tabulated.pdf(brdf, wi, wo), n=200_000)


# ------------------------------------------------------ roughdielectric (test_bsdf2.py)

WI_RD = _unit([0.4, -0.15, 0.904])
RD = rd.RoughDielectricParams(eta=_t(1.5), alpha=_t(0.35), specular_reflectance=torch.ones(3),
                              specular_transmittance=torch.ones(3))


@pytest.mark.parametrize("side", ["outside", "inside"])
def test_roughdielectric_chi2(side):
    wi, seed = (WI_RD, 0) if side == "outside" else (WI_RD * np.float32([1, 1, -1]), 1)
    _chi2_bsdf(lambda wi_, u, u1: rd.sample(RD, wi_, u, u1),
               lambda wi_, wo: rd.pdf(RD, wi_, wo), wi=wi, n=200_000, seed=seed,
               test_count=4, u1_seed=seed + 17)


# ------------------------------------------------------ principled (test_principled.py)

WI_P = _unit([0.3, -0.2, 0.933])


@pytest.mark.parametrize("kw", [
    {},
    {"metallic": 0.9, "roughness": 0.25},
    {"clearcoat": 1.0, "clearcoat_gloss": 0.7, "roughness": 0.4},
    {"anisotropic": 0.8, "roughness": 0.3, "metallic": 0.5},
    {"sheen": 1.0, "sheen_tint": 0.5, "roughness": 0.7, "flatness": 0.6},
])
def test_principled_chi2(kw):
    d = dict(base_color=[0.7, 0.4, 0.2], roughness=0.5, anisotropic=0.0, metallic=0.0,
             spec_tint=0.0, specular=0.5, sheen=0.0, sheen_tint=0.0, clearcoat=0.0,
             clearcoat_gloss=0.0, flatness=0.0)
    d.update(kw)
    p = principled.PrincipledParams(**{k: _t(v) for k, v in d.items()})
    _chi2_bsdf(lambda wi, u, u1: principled.sample(p, wi, u),
               lambda wi, wo: principled.pdf(p, wi, wo), wi=WI_P)


# ------------------------------------------------------------ phases (test_media.py)

SGGX_S = [1.0, 0.09, 0.25, 0.0, 0.0, 0.1]


@pytest.mark.parametrize("kind, n, seed", [
    ("hg_forward", 120_000, 3), ("hg_backward", 120_000, 3), ("rayleigh", 100_000, 5),
    ("isotropic", 100_000, 5), ("sggx", 120_000, 3),
])
def test_phase_chi2(kind, n, seed):
    """HG at g = 0.6 and -0.4 and Rayleigh at the JAX tests' settings, the
    isotropic phase at Rayleigh's and SGGX (an anisotropic S) at HG's."""
    ptype, g = {"hg_forward": (phase.HG, 0.6), "hg_backward": (phase.HG, -0.4),
                "rayleigh": (phase.RAYLEIGH, 0.0), "isotropic": (phase.ISOTROPIC, 0.0),
                "sggx": (phase.SGGX, 0.0)}[kind]

    def args(k):
        s = _t(SGGX_S).expand(k, 6) if ptype == phase.SGGX else None
        return (torch.full((k,), ptype, dtype=torch.int64), _t(g).expand(k),
                _t(WI_P).expand(k, 3)), s

    def s(u):
        (pt, gv, wi), sg = args(len(u))
        return phase.sample(pt, gv, wi, _t(u), sg)[0].numpy(), np.ones(len(u))

    def pf(d):
        (pt, gv, wi), sg = args(len(d))
        return phase.eval(pt, gv, wi, _t(d), sg).numpy()

    test = ChiSquareTest(SphericalDomain(), s, pf, sample_count=n, res=25, ires=16, seed=seed)
    assert test.run(test_count=4), test.messages


def test_sggx_sampler_matches_its_pdf_where_the_reference_does_not():
    """Reference fault (ROADMAP): the JAX sggx_sample builds the
    visible-normal basis with S_kk / S_kj where Heitz et al.'s listing has
    S_ii / S_ji, so its directions fail the chi-square test against
    sggx_eval, the density it reports (p < 1e-12 at test_media.py's HG
    settings); the port's, which follows the listing, passes
    (test_phase_chi2[sggx]), and so does the listing written in JAX
    (test_torch_phase.jax_sggx_sample_paper)."""
    from mitsuba_customization_tpu.models import phase as jphase
    from test_torch_phase import jax_sggx_sample_paper

    S = _t(SGGX_S)

    def run(sample):
        def s(u):
            k = len(u)
            wo = sample(np.broadcast_to(SGGX_S, (k, 6)).astype(np.float32),
                        np.broadcast_to(WI_P, (k, 3)), u)[0]
            return np.asarray(wo), np.ones(k)

        def pf(d):
            k = len(d)
            return phase.sggx_eval(S.expand(k, 6), _t(WI_P).expand(k, 3), _t(d)).numpy()

        test = ChiSquareTest(SphericalDomain(), s, pf, sample_count=120_000, res=25, ires=16,
                             seed=3)
        return test.run(test_count=4), test

    ok_jax, t_jax = run(jphase.sggx_sample)
    ok_fixed, t_fixed = run(jax_sggx_sample_paper)
    assert not ok_jax and t_jax.p_value < 1e-12, t_jax.messages
    assert ok_fixed, t_fixed.messages


# ------------------------------------------------------- distributions (test_distr.py)

def test_marginal2d_chi2():
    h, w = 16, 24
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    weights = (np.sin(xx / w * np.pi) + 0.1) * (yy / h + 0.2) ** 2
    dist = Marginal2D.build(_t(weights))

    def sample_fn(u):
        pos, _ = dist.sample(_t(u))
        return pos.numpy()[..., ::-1]  # the chi2 domain is (x, y)

    def pdf_fn(p):
        return dist.eval_pdf(_t(np.ascontiguousarray(p[..., ::-1]))).numpy()

    test = ChiSquareTest(PlanarDomain(np.array([[0, 1], [0, 1]])), sample_fn, pdf_fn,
                         sample_count=300_000, res=16)
    assert test.run(), test.messages


def test_envmap_chi2():
    """The envmap's NEE directions (emitters.sample_direction, the only
    emitter, so selection reuses its number unchanged) against its miss
    pdf (emitters.pdf_miss_direction), on a seeded 32x64 sky with a sun,
    rotated by to_world."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render import emitters

    rng = np.random.default_rng(4)
    yy, xx = np.meshgrid(np.arange(32) + 0.5, np.arange(64) + 0.5, indexing="ij")
    sky = 0.2 + 0.1 * np.sin(xx / 64 * 2 * np.pi + rng.random()) + 0.05 * yy / 32
    sky = sky + 4.0 * np.exp(-((yy - 9) ** 2 + (xx - 40) ** 2) / 8.0)
    img = np.stack([sky, 0.9 * sky, 0.8 * sky], -1).astype(np.float32)
    scene = mt.load_dict({
        "type": "scene",
        "sensor": {"type": "perspective", "film": {"width": 4, "height": 4}},
        "ball": {"type": "sphere", "radius": 0.1},
        "env": {"type": "envmap", "bitmap": img,
                "to_world": {"rotate": {"axis": [1, 0.5, 0], "angle": 30}}},
    }, "cpu")
    table = scene.emitters

    def s(u):
        k = len(u)
        u3 = torch.cat([_t(u), torch.full((k, 1), 0.5)], -1)
        ds = emitters.sample_direction(table, scene.geometry, torch.zeros(k, 3), u3)
        return ds.d.numpy(), (ds.pdf.numpy() > 0).astype(np.float64)

    test = ChiSquareTest(SphericalDomain(), s,
                         lambda d: emitters.pdf_miss_direction(table, _t(d)).numpy(),
                         sample_count=200_000, res=25, ires=16)
    assert test.run(), test.messages


# ------------------------------------------------------------------ the harness

def test_harness_matches_jax():
    """The port's ChiSquareTest and the JAX package's, given the same numpy
    sample and pdf functions (a skewed lobe, so pooling and the cells
    matter), tabulate the same histogram and pdf and return the same
    verdict, statistic and p-value."""
    from mitsuba_customization_tpu.utils import chi2 as jchi2

    def sample(u):
        z = u[:, 0].astype(np.float64) ** 0.3
        r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
        phi = 2 * np.pi * u[:, 1]
        return np.stack([r * np.cos(phi), r * np.sin(phi), z], -1)

    def pdf(d):
        z = d[:, 2].astype(np.float64)
        # z = u^0.3 on [0, 1]: density of z is (1/0.3) z^(1/0.3 - 1), over 2 pi
        return np.where(z > 0, np.maximum(z, 0.0) ** (1 / 0.3 - 1) / 0.3 / (2 * np.pi), 0.0)

    runs = []
    for mod in (jchi2, __import__("mitsuba_customization_tpu_torch.utils.chi2",
                                  fromlist=["ChiSquareTest"])):
        test = mod.ChiSquareTest(mod.SphericalDomain(), sample, pdf, sample_count=50_000,
                                 res=21, ires=6, seed=7)
        ok = test.run(test_count=2)
        runs.append((ok, test))
    (ok_j, tj), (ok_t, tt) = runs
    assert ok_j == ok_t
    np.testing.assert_array_equal(tt.histogram, tj.histogram)
    np.testing.assert_array_equal(tt.pdf, tj.pdf)
    assert tt.p_value == tj.p_value and tt.messages == tj.messages

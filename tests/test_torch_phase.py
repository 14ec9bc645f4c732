"""The port's phase functions (models/phase.py) against the JAX package's.

Each type's eval, sample and pdf through the per-lane dispatchers on 4,096
seeded direction pairs and samples (g drawn in [-0.9, 0.9], an
anisotropic SGGX matrix): eval and pdf within rtol 1e-5, sampled
directions within 1e-5 (SGGX's against the JAX sampler with the
paper's basis, which the port takes: the JAX package's own is biased);
HG's sampled pdf within rtol 1e-4 (PDF_RTOL):
near the lobe's peak d ln f / d cos = 3|g| / (1 + g^2 - 2|g| cos) is ~150
at |g| = 0.87, so one ulp of the sampled cosine (6e-8) moves the pdf by
~1e-5, and the two packages' sampled directions part by that ulp. Then
the JAX package's own checks on the port's functions: HG normalisation
(tests/test_media.py::test_hg_normalization) and the SGGX isotropic
limit and normalisation
(test_sggx_phase_isotropic_limit_and_normalization).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_customization_tpu.models import phase as jph
from mitsuba_customization_tpu_torch.models import phase as tph
from test_torch_kernels import one_torch_thread  # noqa: F401

N = 4096
PDF_RTOL = {tph.ISOTROPIC: 1e-5, tph.HG: 1e-4, tph.RAYLEIGH: 1e-5, tph.SGGX: 1e-5}
S_ANISO = [1.0, 0.09, 0.25, 0.0, 0.0, 0.1]


def jax_sggx_sample_paper(S, wi, sample2):
    """The JAX package's sggx_sample with the visible-normal basis of Heitz
    et al.'s listing (tmp = sqrt(S_jj S_ii - S_ji^2), M_j[0] = -(S_ki S_ji
    - S_kj S_ii) / (sqrt(S_ii) tmp)), as the port samples; the package's
    own uses S_kk / S_kj there, which biases it (ROADMAP's reference
    faults). Tests swap it in for the JAX side of SGGX parity checks."""
    from mitsuba_customization_tpu.core import math as jm

    wk, wj = jm.coordinate_system(wi)
    xx, yy, zz, xy, xz, yz = (S[..., i] for i in range(6))

    def quad(a, b):
        return (a[..., 0] * b[..., 0] * xx + a[..., 1] * b[..., 1] * yy
                + a[..., 2] * b[..., 2] * zz + (a[..., 0] * b[..., 1] + a[..., 1] * b[..., 0]) * xy
                + (a[..., 0] * b[..., 2] + a[..., 2] * b[..., 0]) * xz
                + (a[..., 1] * b[..., 2] + a[..., 2] * b[..., 1]) * yz)

    s_ii = jnp.maximum(quad(wi, wi), 1e-12)
    s_kj, s_ki, s_ji = quad(wk, wj), quad(wk, wi), quad(wj, wi)
    det = jnp.maximum(jph._sggx_det(S), 1e-20)
    tmp = jm.safe_sqrt(jnp.maximum(jnp.maximum(quad(wj, wj), 1e-12) * s_ii - s_ji * s_ji,
                                   1e-20))
    inv_sqrt_sii = 1.0 / jnp.sqrt(s_ii)
    zero = jnp.zeros_like(tmp)
    mk = jnp.stack([jnp.sqrt(det) / tmp, zero, zero], -1)
    mj = jnp.stack([-inv_sqrt_sii * (s_ki * s_ji - s_kj * s_ii) / tmp, inv_sqrt_sii * tmp,
                    zero], -1)
    mi = jnp.stack([inv_sqrt_sii * s_ki, inv_sqrt_sii * s_ji, inv_sqrt_sii * s_ii], -1)
    r = jm.safe_sqrt(sample2[..., 0])
    phi = 2.0 * jnp.pi * sample2[..., 1]
    pu, pv = (r * jnp.cos(phi))[..., None], (r * jnp.sin(phi))[..., None]
    pw = jm.safe_sqrt(1.0 - pu[..., 0] ** 2 - pv[..., 0] ** 2)[..., None]
    m_local = jm.normalize(pu * mk + pv * mj + pw * mi)
    normal = jm.normalize(m_local[..., 0:1] * wk + m_local[..., 1:2] * wj
                          + m_local[..., 2:3] * wi)
    wo = jm.normalize(2.0 * jm.dot(normal, wi)[..., None] * normal - wi)
    return wo, jph.sggx_eval(S, wi, wo)


def _units(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def lanes():
    rng = np.random.default_rng(11)
    return dict(wi=_units(rng, N), wo=_units(rng, N),
                u=rng.random((N, 2)).astype(np.float32),
                g=rng.uniform(-0.9, 0.9, N).astype(np.float32),
                S=np.tile(np.asarray(S_ANISO, np.float32), (N, 1)))


@pytest.mark.parametrize("ptype", [tph.ISOTROPIC, tph.HG, tph.RAYLEIGH, tph.SGGX],
                         ids=["isotropic", "hg", "rayleigh", "sggx"])
def test_phase_matches_jax(lanes, ptype, monkeypatch):
    """SGGX's sampled directions against the JAX package's sampler with
    the listing's basis (jax_sggx_sample_paper); its own sampler draws
    other directions (the gap is recorded here and in test_torch_chi2)."""
    t = np.full(N, ptype)
    j = {k: jnp.asarray(v) for k, v in lanes.items()}
    p = {k: torch.as_tensor(v) for k, v in lanes.items()}
    if ptype == tph.SGGX:
        biased, _ = jph.sample(jnp.asarray(t), j["g"], j["wi"], j["u"], S=j["S"])
        fixed = tph.sample(torch.as_tensor(t), p["g"], p["wi"], p["u"], p["S"])[0].numpy()
        assert np.abs(fixed - np.asarray(biased)).max() > 0.1
        monkeypatch.setattr(jph, "sggx_sample", jax_sggx_sample_paper)
    want = np.asarray(jph.eval(jnp.asarray(t), j["g"], j["wi"], j["wo"], S=j["S"]))
    got = tph.eval(torch.as_tensor(t), p["g"], p["wi"], p["wo"], p["S"]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jwo, jpdf = jph.sample(jnp.asarray(t), j["g"], j["wi"], j["u"], S=j["S"])
    two, tpdf = tph.sample(torch.as_tensor(t), p["g"], p["wi"], p["u"], p["S"])
    np.testing.assert_allclose(two.numpy(), np.asarray(jwo), atol=1e-5)
    np.testing.assert_allclose(tpdf.numpy(), np.asarray(jpdf), rtol=PDF_RTOL[ptype])
    # pdf == eval at the sampled direction
    np.testing.assert_allclose(tph.eval(torch.as_tensor(t), p["g"], p["wi"], two,
                                        p["S"]).numpy(), tpdf.numpy(), rtol=1e-4)


def test_dispatch_without_sggx_matches_jax(lanes):
    """S = None (a scene without an SGGX phase): the other three types by
    lane, as the JAX dispatch computes them."""
    t = np.arange(N) % 3
    j = {k: jnp.asarray(v) for k, v in lanes.items()}
    p = {k: torch.as_tensor(v) for k, v in lanes.items()}
    want = np.asarray(jph.eval(jnp.asarray(t), j["g"], j["wi"], j["wo"]))
    got = tph.eval(torch.as_tensor(t), p["g"], p["wi"], p["wo"]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jwo, _ = jph.sample(jnp.asarray(t), j["g"], j["wi"], j["u"])
    two, _ = tph.sample(torch.as_tensor(t), p["g"], p["wi"], p["u"])
    np.testing.assert_allclose(two.numpy(), np.asarray(jwo), atol=1e-5)


def test_hg_normalization():
    """HG integrates to 1 over the sphere (a cos-theta quadrature)."""
    mu = np.linspace(-1 + 1e-5, 1 - 1e-5, 20_001).astype(np.float32)
    sin_t = np.sqrt(np.maximum(0.0, 1.0 - mu * mu))
    wi = torch.tensor([0.0, 0.0, 1.0]).expand(len(mu), 3)
    wo = torch.as_tensor(np.stack([sin_t, np.zeros_like(mu), -mu], -1))
    val = tph.hg_eval(torch.full((len(mu),), 0.7), wi, wo).numpy()
    integral = 2 * np.pi * np.trapezoid(val.astype(np.float64), mu)
    assert abs(integral - 1.0) < 1e-3


def test_sggx_isotropic_limit_and_normalization():
    """S = I is the isotropic phase exactly (rtol 1e-4); an anisotropic S
    integrates to 1 within 5 % (Monte Carlo over 32,768 uniform
    directions); sample's pdf is eval's (rtol 1e-3)."""
    rng = np.random.default_rng(3)
    n = 1 << 15
    wi = torch.as_tensor(_units(rng, n))
    wo = torch.as_tensor(_units(rng, n))
    S_iso = torch.tensor([1.0, 1, 1, 0, 0, 0]).expand(n, 6)
    np.testing.assert_allclose(tph.sggx_eval(S_iso, wi, wo).numpy(), 1.0 / (4 * np.pi),
                               rtol=1e-4)
    S = torch.tensor(S_ANISO).expand(n, 6)
    wi1 = torch.as_tensor(_units(rng, 1)).expand(n, 3)
    integ = float(tph.sggx_eval(S, wi1, wo).mean()) * 4 * np.pi
    assert abs(integ - 1.0) < 0.05, integ
    wo_s, pdf_s = tph.sggx_sample(S, wi1, torch.as_tensor(rng.random((n, 2)).astype(np.float32)))
    np.testing.assert_allclose(pdf_s.numpy(), tph.sggx_eval(S, wi1, wo_s).numpy(),
                               rtol=1e-3, atol=1e-6)

"""Parity of the PyTorch port's core numerics with the JAX package.

Same numpy inputs through both packages: the sampler and its hashes must
be bit-exact; angles, warps and CDF inversion agree within 1e-6.

The two math libraries round some lanes 1 ulp apart (as XLA's eager and
jitted code do). acos, atan2 and sqrt magnify such a difference in their
argument near their branch points (theta -> 0, radius -> 0), so there an
angle is compared through the well-conditioned quantity it came from.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_customization_tpu.core import distr as jdistr
from mitsuba_customization_tpu.core import qmc as jqmc
from mitsuba_customization_tpu.core import rusinkiewicz as jrus
from mitsuba_customization_tpu.core import sampler as jsampler
from mitsuba_customization_tpu.core import warp as jwarp
from mitsuba_customization_tpu_torch.core import distr as tdistr
from mitsuba_customization_tpu_torch.core import qmc as tqmc
from mitsuba_customization_tpu_torch.core import rusinkiewicz as trus
from mitsuba_customization_tpu_torch.core import sampler as tsampler
from mitsuba_customization_tpu_torch.core import warp as twarp
from test_torch_kernels import one_torch_thread  # noqa: F401

ATOL = 1e-6


def _unit(rng, n, hemi=False):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    if hemi:
        v[:, 2] = np.abs(v[:, 2]) + 1e-3
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return v


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=0, atol=atol
    )


def test_hashes_bit_exact(rng):
    a = rng.integers(0, 2**32, 50_000, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, 50_000, dtype=np.uint64).astype(np.uint32)
    a[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    ta, tb = torch.as_tensor(a.astype(np.int64)), torch.as_tensor(b.astype(np.int64))
    np.testing.assert_array_equal(
        tqmc.hash_u32(ta).numpy(), np.asarray(jqmc.hash_u32(jnp.asarray(a)))
    )
    np.testing.assert_array_equal(
        tqmc.hash_combine(ta, tb).numpy(),
        np.asarray(jqmc.hash_combine(jnp.asarray(a), jnp.asarray(b))),
    )


@pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF])
def test_sampler_uniforms_equal(seed):
    """100k lanes x 16 dims: the port draws the JAX package's uniforms."""
    n, spp = 100_000, 8
    pixel = np.arange(n, dtype=np.uint32) // spp
    sidx = np.arange(n, dtype=np.uint32) % spp
    js = jsampler.make_sampler(
        "independent", seed, jnp.asarray(pixel), jnp.asarray(sidx), spp
    ).with_dim(12)
    ts = tsampler.make_sampler(
        "independent", seed, torch.as_tensor(pixel.astype(np.int64)),
        torch.as_tensor(sidx.astype(np.int64)), spp,
    ).with_dim(12)
    for _ in range(4):  # 4 x (2-D + 1-D + 1-D) = 16 dims
        np.testing.assert_array_equal(ts.next_2d().numpy(), np.asarray(js.next_2d()))
        for _ in range(2):
            u = ts.next_1d()
            np.testing.assert_array_equal(u.numpy(), np.asarray(js.next_1d()))
    assert u.dtype == torch.float32


def _close_half_diff(got, want, theta_h, theta_d):
    """Angles at ATOL away from the poles (sin theta_h, sin theta_d >= 0.5:
    the argument's few-ulp rounding magnified at most 2x); the cosines of
    theta_h and theta_d, the computed arguments, at ATOL on every lane."""
    theta_h, theta_d = np.asarray(theta_h), np.asarray(theta_d)
    ok = (np.sin(theta_h) >= 0.5) & (np.sin(theta_d) >= 0.5)
    assert ok.mean() > 0.3, ok.mean()  # thousands of lanes compared directly
    for g, w in zip(got, want):
        _close(np.asarray(g)[ok], np.asarray(w)[ok])
    for i in (0, len(got) - 2):  # theta_h, theta_d
        _close(np.cos(np.asarray(got[i])), np.cos(np.asarray(want[i])))


def test_dirs_to_half_diff(rng):
    wi, wo = _unit(rng, 20_000, True), _unit(rng, 20_000, True)
    got = trus.dirs_to_half_diff(torch.as_tensor(wi), torch.as_tensor(wo))
    want = jrus.dirs_to_half_diff(jnp.asarray(wi), jnp.asarray(wo))
    _close_half_diff(got, want, want[0], want[2])


def test_dirs_to_half_diff_fast(rng):
    wi, wo = _unit(rng, 20_000, True), _unit(rng, 20_000, True)
    got = trus.dirs_to_half_diff_fast(torch.as_tensor(wi), torch.as_tensor(wo))
    want = jrus.dirs_to_half_diff_fast(jnp.asarray(wi), jnp.asarray(wo))
    _close_half_diff(got, want, want[0], want[1])


@pytest.mark.parametrize("name", [
    "square_to_uniform_disk_concentric",
    "square_to_cosine_hemisphere",
    "square_to_uniform_sphere",
])
def test_warps(rng, name):
    u = rng.random((20_000, 2)).astype(np.float32)
    u[:3] = [[0.5, 0.5], [0.0, 0.0], [1.0 - 1e-7, 0.25]]
    got = getattr(twarp, name)(torch.as_tensor(u)).numpy()
    want = np.asarray(getattr(jwarp, name)(jnp.asarray(u)))
    if name == "square_to_cosine_hemisphere":
        # z = sqrt(1 - x^2 - y^2): compare z^2 at the disk's rim
        rim = want[:, 2] < 0.1
        _close(got[rim, 2] ** 2, want[rim, 2] ** 2)
        got, want = got[~rim], want[~rim]
    _close(got, want)
    if name == "square_to_cosine_hemisphere":
        d = _unit(rng, 1000)
        _close(twarp.square_to_cosine_hemisphere_pdf(torch.as_tensor(d)),
               jwarp.square_to_cosine_hemisphere_pdf(jnp.asarray(d)))


def test_invert_cdf(rng):
    w = rng.random((4000, 64)).astype(np.float32)
    w[::7, :10] = 0.0  # flat stretches: equal CDF values
    cdf = np.cumsum(w, -1) / w.sum(-1, keepdims=True)
    cdf = cdf.astype(np.float32)
    u = rng.random(4000).astype(np.float32)
    u[:3] = [0.0, 1.0 - 1e-7, 1.0]
    u[3:10] = cdf[3:10, 20]  # u exactly on a CDF value
    idx, lo, mass = tdistr._invert_cdf(torch.as_tensor(cdf), torch.as_tensor(u))
    jidx, jlo, jmass = jdistr._invert_cdf(jnp.asarray(cdf), jnp.asarray(u))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(lo, jlo)
    _close(mass, jmass)


def test_distributions_build_and_sample(rng):
    weights = rng.random((3, 8, 16)).astype(np.float32)
    weights[0, 2] = 0.0
    got = tdistr.Marginal2D.build(torch.as_tensor(weights))
    want = jdistr.Marginal2D.build(jnp.asarray(weights))
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6, atol=ATOL)

    pw = np.asarray([0.5, 0.0, 2.0, 1.0], np.float32)
    td = tdistr.DiscreteDistribution.build(torch.as_tensor(pw))
    jd = jdistr.DiscreteDistribution.build(jnp.asarray(pw))
    u = rng.random(5000).astype(np.float32)
    ti, tu = td.sample_reuse(torch.as_tensor(u))
    ji, ju = jd.sample_reuse(jnp.asarray(u))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tu, ju)
    _close(td.eval_pmf(ti), jd.eval_pmf(ji))


def test_continuous_distribution(rng):
    w = rng.random(40).astype(np.float32) ** 3
    u = rng.random(3000).astype(np.float32)
    jd = jdistr.ContinuousDistribution.build(jnp.asarray(w))
    td = tdistr.ContinuousDistribution.build(torch.as_tensor(w))
    for a, b in zip(td, jd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    x = td.sample(torch.as_tensor(u))
    np.testing.assert_allclose(x.numpy(), np.asarray(jd.sample(jnp.asarray(u))), atol=ATOL)
    np.testing.assert_allclose(td.eval_pdf(x).numpy(), np.asarray(jd.eval_pdf(jnp.asarray(x))),
                               rtol=1e-6)


@pytest.mark.parametrize("stacked", [False, True])
def test_marginal2d_sample_and_pdf(rng, stacked):
    """Marginal2D.sample / eval_pdf, on one table and through a lane's
    slice of a (3, 4) stack (the tabulated sampler's form), and
    gather_slice, on the same CDFs (torch's and XLA's cumsum round
    apart; the build is compared in test_distributions_build_and_sample)."""
    lead = (3, 4) if stacked else ()
    w = (rng.random(lead + (8, 16)).astype(np.float32) ** 4)
    n = 2000
    u = rng.random((n, 2)).astype(np.float32)
    jm = jdistr.Marginal2D.build(jnp.asarray(w))
    tm = tdistr.Marginal2D(*(torch.as_tensor(np.asarray(f)) for f in jm))
    js = ts = None
    if stacked:
        idx = (rng.integers(0, 3, n), rng.integers(0, 4, n))
        js = tuple(jnp.asarray(i) for i in idx)
        ts = tuple(torch.as_tensor(i) for i in idx)
    pos, pdf = tm.sample(torch.as_tensor(u), slice_=ts)
    jpos, jpdf = jm.sample(jnp.asarray(u), slice_=js)
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), atol=ATOL)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=1e-5)
    np.testing.assert_allclose(tm.eval_pdf(pos, slice_=ts).numpy(),
                               np.asarray(jm.eval_pdf(jnp.asarray(pos.numpy()), slice_=js)),
                               rtol=1e-5)
    if stacked:
        sub = tm.gather_slice(ts)
        for a, b in zip(sub, jm.gather_slice(js)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)


def test_srgb_and_fresnel(rng):
    from mitsuba_customization_tpu.core import spectrum as jspec
    from mitsuba_customization_tpu.models import fresnel as jfres
    from mitsuba_customization_tpu_torch.core import spectrum as tspec
    from mitsuba_customization_tpu_torch.models import fresnel as tfres

    c = rng.uniform(-0.1, 1.2, 4000).astype(np.float32)
    for fn in ("srgb_to_linear", "linear_to_srgb"):
        np.testing.assert_allclose(getattr(tspec, fn)(torch.as_tensor(c)).numpy(),
                                   np.asarray(getattr(jspec, fn)(jnp.asarray(c))),
                                   rtol=1e-6, atol=1e-7)
    cos = rng.uniform(-1, 1, 4000).astype(np.float32)
    eta = rng.uniform(0.6, 2.2, 4000).astype(np.float32)
    for a, b in zip(tfres.fresnel_dielectric(torch.as_tensor(cos), torch.as_tensor(eta)),
                    jfres.fresnel_dielectric(jnp.asarray(cos), jnp.asarray(eta))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    f0 = rng.random((4000, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tfres.fresnel_schlick(torch.as_tensor(cos), torch.as_tensor(f0)).numpy(),
        np.asarray(jfres.fresnel_schlick(jnp.asarray(cos), jnp.asarray(f0))),
        rtol=1e-6, atol=1e-7)

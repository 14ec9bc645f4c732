"""The port's Owen-scrambled Sobol' functions and its six samplers against
the JAX package's core/qmc.py and core/sampler.py, the JAX sampler tests'
stratification checks run on the port, and wavefront compaction with
samplers other than `independent`.

Inputs are made from a seed with numpy. Tolerances: the qmc functions and
every sampler draw are bit-equal (uint32 values equal, float32 draws equal
with torch.equal semantics); a compacted frame under a schedule whose caps
hold every live lane (harvest only: lanes are re-sorted, none is thinned)
is bit-equal to the uncompacted frame; under a binding schedule (live
lanes thinned) the frame's per-channel means are within 5 %.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_customization_tpu_torch as mt
from mitsuba_customization_tpu.core import qmc as jqmc
from mitsuba_customization_tpu.core import sampler as jsampler
from mitsuba_customization_tpu_torch.core import qmc as tqmc
from mitsuba_customization_tpu_torch.core import sampler as tsampler
from mitsuba_customization_tpu_torch.render.integrator import BOUNCE_DIMS, CAMERA_DIMS
from mitsuba_customization_tpu_torch.render.sensors import look_at
from test_torch_film import assert_frame_matches_jax
from test_torch_kernels import one_torch_thread  # noqa: F401
from test_torch_sensors import CAM, _scene_dict


def _u32(n=65536, seed=0):
    x = np.random.default_rng(seed).integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 2 ** 31, 2 ** 32 - 1]
    return x


def _t(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


QMC = {
    "reverse_bits32": lambda q, x, s: q.reverse_bits32(x),
    "laine_karras": lambda q, x, s: q._laine_karras_permutation(x, s),
    "owen_scramble": lambda q, x, s: q.owen_scramble(x, s),
    "sobol_u32_dim0": lambda q, x, s: q.sobol_u32(x, 0),
    "sobol_u32_dim1": lambda q, x, s: q.sobol_u32(x, 1),
    "u32_to_unit_float": lambda q, x, s: q._u32_to_unit_float(x),
    "sobol_owen_2d": lambda q, x, s: q.sobol_owen_2d(x, s),
}


@pytest.mark.parametrize("name", list(QMC))
def test_qmc_bit_equal(name):
    """65,536 seeded uint32 values (0, 1, 2^31 and 2^32 - 1 among them)
    and as many seeds: the port's values equal the JAX package's."""
    x, s = _u32(), _u32(seed=1)
    got = QMC[name](tqmc, _t(x), _t(s)).numpy()
    want = np.asarray(QMC[name](jqmc, jnp.asarray(x), jnp.asarray(s)))
    if want.dtype == np.uint32:
        got = got.astype(np.uint32)
    np.testing.assert_array_equal(got, want)


SPPS = (1, 4, 8, 9, 16, 25)


@pytest.mark.parametrize("spp", SPPS)
@pytest.mark.parametrize("name", list(tsampler.SAMPLERS))
def test_sampler_draws_bit_equal(name, spp):
    """Every sampler, at dimension bases 0, CAMERA_DIMS and CAMERA_DIMS +
    3 * BOUNCE_DIMS, a sequence of next_2d / next_1d draws (odd offsets
    too): the port's draws equal the JAX package's (seed 7, 97 pixels, a
    large pixel index among them)."""
    pix = np.arange(97, dtype=np.uint32)
    pix[-1] = 2 ** 26 + 3
    pixel = np.repeat(pix, spp)
    sidx = np.tile(np.arange(spp, dtype=np.uint32), len(pix))
    for base in (0, CAMERA_DIMS, CAMERA_DIMS + 3 * BOUNCE_DIMS):
        js = jsampler.make_sampler(name, jnp.uint32(7), jnp.asarray(pixel),
                                   jnp.asarray(sidx), spp).with_dim(base)
        ts = tsampler.make_sampler(name, 7, _t(pixel), _t(sidx), spp).with_dim(base)
        for op in "2121122":
            got = ts.next_2d() if op == "2" else ts.next_1d()
            want = js.next_2d() if op == "2" else js.next_1d()
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"{name} spp {spp} base {base}")


def _lanes(n_pix, spp):
    return (torch.arange(n_pix).repeat_interleave(spp),
            torch.arange(spp).repeat(n_pix))


def _sobol_beats_independent():
    n_pix, spp = 256, 64
    pixel, sidx = _lanes(n_pix, spp)
    sob = tsampler.SobolSampler.from_pixel(1, pixel, sidx, spp)
    ind = tsampler.make_sampler("independent", 1, pixel, sidx, spp)

    def integrand(u):
        return np.sin(np.pi * u[..., 0]) * u[..., 1]

    true = (2 / np.pi) * 0.5
    err_s = np.mean((integrand(sob.next_2d().numpy()).reshape(n_pix, spp).mean(1) - true) ** 2)
    err_i = np.mean((integrand(ind.next_2d().numpy()).reshape(n_pix, spp).mean(1) - true) ** 2)
    assert err_s < err_i / 4, (err_s, err_i)


def _sobol_unit_square():
    pts = tqmc.sobol_owen_2d(torch.arange(4096), torch.tensor(9)).numpy()
    assert pts.min() >= 0 and pts.max() < 1
    hist, *_ = np.histogram2d(pts[:, 0], pts[:, 1], bins=8, range=[[0, 1], [0, 1]])
    assert np.all(hist == 64)  # a (0,2)-sequence: 64 points a cell


def _stratified_strata():
    n_pix, spp = 16, 8
    s = tsampler.StratifiedSampler.from_pixel(3, *_lanes(n_pix, spp), spp)
    strata = np.sort((s.next_1d().numpy().reshape(n_pix, spp) * spp).astype(int), axis=1)
    assert np.all(strata == np.arange(spp)[None, :])


def _multijitter_projections():
    spp = 16
    smp = tsampler.make_sampler("multijitter", 7, torch.zeros(spp, dtype=torch.int64),
                                torch.arange(spp), spp)
    uv = smp.next_2d().numpy()
    assert uv.shape == (spp, 2) and (uv >= 0).all() and (uv < 1).all()
    cx, cy = np.floor(uv[:, 0] * 4).astype(int), np.floor(uv[:, 1] * 4).astype(int)
    assert sorted(cx * 4 + cy) == list(range(16))
    assert sorted(np.floor(uv[:, 0] * 16).astype(int)) == list(range(16))
    assert sorted(np.floor(uv[:, 1] * 16).astype(int)) == list(range(16))


def _orthogonal_pairwise():
    spp, p = 25, 5
    smp = tsampler.make_sampler("orthogonal", 3, torch.zeros(spp, dtype=torch.int64),
                                torch.arange(spp), spp)
    dims = [smp.next_1d().numpy() for _ in range(4)]
    for d in dims:
        assert sorted(np.floor(d * 25).astype(int)) == list(range(25))
    for i in range(4):
        for j in range(i + 1, 4):
            ci, cj = np.floor(dims[i] * p).astype(int), np.floor(dims[j] * p).astype(int)
            assert sorted(ci * p + cj) == list(range(25)), (i, j)


@pytest.mark.parametrize("check", [
    _sobol_beats_independent, _sobol_unit_square, _stratified_strata,
    _multijitter_projections, _orthogonal_pairwise,
], ids=["sobol_beats_independent", "sobol_unit_square", "stratified_strata",
        "multijitter_projections", "orthogonal_pairwise"])
def test_jax_stratification_checks_hold_on_the_port(check):
    """The JAX package's tests/test_sampler.py checks, on the port's
    samplers: Sobol' beats independent sampling on a smooth integrand by
    4x in squared error, its points fill every 1/8 x 1/8 cell equally,
    stratified covers every stratum, multijitter is stratified in its
    4x4 grid and both 1-D projections, and orthogonal (spp 25) in every
    pair of dimensions."""
    check()


def test_unknown_sampler_raises():
    with pytest.raises(ValueError, match="unknown sampler"):
        tsampler.make_sampler("halton", 0, torch.zeros(1, dtype=torch.int64),
                              torch.zeros(1, dtype=torch.int64), 1)


def _sphere_dict(sampler, compact):
    """A diffuse unit sphere under a constant sky at 64x64, 4 spp (16,384
    lanes): about 40 % of the lanes hit the sphere and stay live."""
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 3, "compact": compact},
        "sensor": {"type": "perspective", "fov": 40,
                   "to_world": look_at([0, 0, -4], [0, 0, 0], [0, 1, 0]),
                   "film": {"width": 64, "height": 64},
                   "sampler": {"type": sampler, "sample_count": 4}},
        "sphere": {"type": "sphere", "bsdf": {"type": "diffuse", "reflectance": [0.7, 0.5, 0.3]}},
        "sky": {"type": "constant", "radiance": [1.0, 1.0, 1.0]},
    }


def _compacted_and_plain(sampler, compact):
    comp = mt.load_dict(_sphere_dict(sampler, compact), "cpu")
    plain = dataclasses.replace(comp, config=dataclasses.replace(comp.config, compact=None))
    return mt.render(comp, 4, 5), mt.render(plain, 4, 5)


@pytest.mark.parametrize("sampler", ["stratified", "multijitter", "sobol", "orthogonal"])
def test_harvest_only_compaction_keeps_every_samplers_draws(sampler):
    """Caps of 8,192 lanes from bounce 1 hold the ~6,500 live lanes: the
    runner re-sorts lanes without thinning, and each bounce's sampler is
    the scene's own class on the permuted lanes, so the frame equals the
    uncompacted one bit for bit. (A bounce sampler rebuilt as the
    independent sampler draws other numbers and changes the frame.)"""
    got, want = _compacted_and_plain(sampler, (1.0, 0.5))
    assert torch.isfinite(want).all() and float(want.mean()) > 0.05
    assert torch.equal(got, want)


@pytest.mark.parametrize("sampler", ["stratified", "multijitter"])
def test_binding_compaction_is_unbiased_for_every_sampler(sampler):
    """Caps of 4,096 lanes from bounce 1 thin the ~6,500 live lanes
    (survivors weighted 1 / p): per-channel means within 5 % of the
    uncompacted frame's."""
    got, want = _compacted_and_plain(sampler, (1.0, 0.25))
    assert not torch.equal(got, want)
    np.testing.assert_allclose(got.mean((0, 1)).numpy(), want.mean((0, 1)).numpy(), rtol=0.05)


@pytest.mark.parametrize("name", list(tsampler.SAMPLERS))
def test_sampler_frame_matches_jax(name):
    """Two spheres on a floor (16x16, 16 spp, depth 3) with each sampler,
    through load_dict -> render: means within 1 % and the Z-test."""
    assert_frame_matches_jax(_scene_dict({
        "type": "perspective", "fov": 45, "to_world": CAM,
        "sampler": {"type": name, "sample_count": 16}}))

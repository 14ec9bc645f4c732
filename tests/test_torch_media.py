"""The port's participating media (render/medium.py and the loader's
media) against the JAX package's.

The loader's MediumTable for every dict form the JAX loader reads (each
field equal); the free-flight draws bit-equal; the trilinear density and
sigma_t_at within rtol 1e-6; sample_interaction and transmittance in
homogeneous, heterogeneous and vacuum lanes, primal and ad_mode, on the
same seeded rays: is_medium equal on >= 99.9 % of lanes (a lane whose step
lands within rounding of t_max or of the real-collision probability may
part), t, weight and emitted within rtol 1e-4 where the flags agree, and
the transmittance within rtol 1e-4 and atol 1e-6 (a ratio-tracking factor
1 - sigma / majorant cancels where the density nears its maximum, so a
channel near 0 keeps only its absolute accuracy). The ad_mode lanes
include some that need more than 48 tracking steps, so the JAX package's
48-step cut is held too. Then recompute_majorant.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_customization_tpu as mct
import mitsuba_customization_tpu_torch as mt
from mitsuba_customization_tpu.render import medium as jmed
from mitsuba_customization_tpu_torch.render import medium as tmed
from test_torch_kernels import one_torch_thread  # noqa: F401

N = 4096
GRID = np.random.default_rng(5).random((5, 6, 7)).astype(np.float32)

MEDIUM_FORMS = {
    "defaults": {"type": "homogeneous"},
    "scalar_scale": {"type": "homogeneous", "sigma_t": 0.7, "albedo": 0.4, "scale": 2.5},
    "value_dicts": {"type": "homogeneous", "sigma_t": {"type": "rgb", "value": [1, 2, 3]},
                    "albedo": {"value": [0.2, 0.3, 0.4]}, "phase": {"type": "hg", "g": -0.3}},
    "radiance": {"type": "homogeneous", "radiance": [1.0, 2.0, 3.0],
                 "phase": {"type": "rayleigh"}},
    "emission": {"type": "homogeneous", "emission": 0.5},
    "sggx_S": {"type": "homogeneous", "phase": {"type": "sggx", "S": [1, 0.5, 0.2, 0.1, 0, 0]}},
    "sggx_sigma": {"type": "homogeneous", "phase": {"type": "sggx", "sigma": [1.0, 0.3, 0.5]}},
    "grid_array": {"type": "heterogeneous", "density": GRID, "sigma_t": [2, 3, 4],
                   "to_world": {"scale": 2.0, "translate": [-1, -1, -1]}},
    "gridvolume": {"type": "heterogeneous", "scale": 3.0,
                   "density": {"grid": GRID, "to_world": {"scale": [1.0, 2.0, 3.0]}}},
}


def _scene(media):
    """Spheres with the given interiors, and a named medium referenced by
    name."""
    d = {"type": "scene", "light": {"type": "constant"},
         "named": {"type": "homogeneous", "sigma_t": [0.3, 0.2, 0.1]},
         "ref": {"type": "sphere", "center": [0, 0, -9], "bsdf": {"type": "null"},
                 "interior": "named"},
         "plain": {"type": "sphere", "center": [0, 0, 9]}}
    for i, md in enumerate(media):
        d[f"s{i}"] = {"type": "sphere", "center": [3.0 * i, 0, 5], "bsdf": {"type": "null"},
                      "interior": md}
    return d


def _assert_tables_equal(own, ref):
    for f in jmed.MediumTable._fields:
        a, b = getattr(own, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    assert own.has_het == bool((np.asarray(ref.m_type) == jmed.HETEROGENEOUS).any())


@pytest.mark.parametrize("form", sorted(MEDIUM_FORMS))
def test_loader_media_table_matches_jax(form):
    d = _scene([MEDIUM_FORMS[form], MEDIUM_FORMS["defaults"]])
    own, ref = mt.load_dict(d, "cpu"), mct.load_dict(d)
    _assert_tables_equal(own.media, ref.media)


def test_media_free_scene_has_the_empty_table():
    d = {"type": "scene", "s": {"type": "sphere"}}
    own, ref = mt.load_dict(d, "cpu"), mct.load_dict(d)
    assert own.media.n_media == 0
    _assert_tables_equal(own.media, ref.media)


def _tables(sigma_het=(2.0, 3.0, 4.0), grid=GRID):
    rows = [dict(type="homogeneous", sigma_t=np.asarray([0.5, 1.0, 2.0], np.float32),
                 albedo=np.asarray([0.8, 0.7, 0.6], np.float32), phase_type=0, phase_g=0.0,
                 emission=np.asarray([1.0, 2.0, 3.0], np.float32)),
            dict(type="heterogeneous", sigma_t=np.asarray(sigma_het, np.float32),
                 albedo=np.asarray([0.9, 0.8, 0.7], np.float32), phase_type=1, phase_g=0.5,
                 emission=np.asarray([0.5, 0.5, 0.5], np.float32), density=grid,
                 to_world=np.diag([2.0, 2.0, 2.0, 1.0]))]
    return jmed.build_table(rows, [0, 1], 2), tmed.build_table(rows, [0, 1], 2, device="cpu")


def test_build_table_matches_jax():
    jt, tt = _tables()
    _assert_tables_equal(tt, jt)


def test_draw_bit_equal():
    lane = np.arange(N, dtype=np.uint32) * np.uint32(2654435761)
    for seed, dim in ((0, 0), (123, 77), (0x6D656469, 4096 * 7 + 2048 + 300)):
        want = np.asarray(jmed._draw(jnp.uint32(seed), jnp.asarray(lane), jnp.uint32(dim)))
        got = tmed._draw(seed, torch.as_tensor(lane.astype(np.int64)), dim).numpy()
        np.testing.assert_array_equal(got, want)


def test_density_and_sigma_t_at_match_jax():
    jt, tt = _tables()
    rng = np.random.default_rng(6)
    p = rng.uniform(-0.5, 2.5, (N, 3)).astype(np.float32)
    mid = rng.integers(-1, 2, N)
    want = np.asarray(jmed._density(jt, jnp.asarray(np.maximum(mid, 0), jnp.int32),
                                    jnp.asarray(p)))
    got = tmed._density(tt, torch.as_tensor(np.maximum(mid, 0)), torch.as_tensor(p)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert 0 < (want == 0).mean() < 0.9  # lanes outside the grid box among them
    want = np.asarray(jmed.sigma_t_at(jt, jnp.asarray(mid, jnp.int32), jnp.asarray(p)))
    got = tmed.sigma_t_at(tt, torch.as_tensor(mid), torch.as_tensor(p)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _rays(seed, long=False):
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.0, 2.0, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = rng.uniform(0.1, 8.0 if long else 3.0, N).astype(np.float32)
    t_max[::97] = np.inf
    mid = rng.integers(-1, 2, N)
    lane = np.arange(N, dtype=np.uint32)
    return o, d, t_max, mid, lane


def _both(fn_j, fn_t, jt, tt, rays, ad_mode):
    o, d, t_max, mid, lane = rays
    j = fn_j(jt, jnp.asarray(mid, jnp.int32), jnp.asarray(o), jnp.asarray(d),
             jnp.asarray(t_max), jnp.uint32(5), jnp.asarray(lane), jnp.uint32(8),
             ad_mode=ad_mode)
    t = fn_t(tt, torch.as_tensor(mid), torch.as_tensor(o), torch.as_tensor(d),
             torch.as_tensor(t_max), 5, torch.as_tensor(lane.astype(np.int64)), 8,
             ad_mode=ad_mode)
    return j, t


@pytest.mark.parametrize("ad_mode", [False, True], ids=["primal", "ad_mode"])
@pytest.mark.parametrize("dense", [False, True], ids=["thin", "dense"])
def test_sample_interaction_and_transmittance_match_jax(ad_mode, dense, monkeypatch):
    """`dense`: a heterogeneous medium of majorant 45 over chords up to 8,
    where many lanes take more than 48 tracking steps (the primal loop
    runs past 48 steps; ad_mode cuts it there, as the JAX scan does)."""
    sigma = (40.0, 45.0, 50.0) if dense else (2.0, 3.0, 4.0)
    grid = np.where(GRID > 0.9, GRID, 0.05).astype(np.float32) if dense else GRID
    jt, tt = _tables(sigma, grid)
    rays = _rays(7, long=dense)
    monkeypatch.setattr(tmed, "LOOPS", [])
    js, ts = _both(jmed.sample_interaction, tmed.sample_interaction, jt, tt, rays, ad_mode)
    mid = rays[3]
    agree = np.asarray(js.is_medium) == ts.is_medium.numpy()
    assert agree.mean() >= 0.999, agree.mean()
    assert 0.05 < ts.is_medium.numpy().mean() < 0.95
    for f in ("t", "weight", "emitted"):
        np.testing.assert_allclose(getattr(ts, f).numpy()[agree],
                                   np.asarray(getattr(js, f))[agree], rtol=1e-4, err_msg=f)
    vac = mid < 0
    assert not ts.is_medium.numpy()[vac].any()
    np.testing.assert_array_equal(ts.weight.numpy()[vac], 1.0)
    jtr, ttr = _both(jmed.transmittance, tmed.transmittance, jt, tt, rays, ad_mode)
    np.testing.assert_allclose(ttr.numpy(), np.asarray(jtr), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(ttr.numpy()[vac], 1.0)
    steps = {kind: int(s.max()) for kind, _, s, _ in tmed.LOOPS}
    if ad_mode:
        assert steps == {"delta": tmed.AD_TRACKING_STEPS, "ratio": tmed.AD_TRACKING_STEPS} \
            or not dense
    elif dense:
        assert min(steps.values()) > tmed.AD_TRACKING_STEPS, steps


def test_homogeneous_transmittance_analytic():
    """The JAX package's analytic check on the port: exp(-sigma d)."""
    _, tt = _tables()
    n = 8
    dist = torch.linspace(0.1, 3.0, n)
    tr = tmed.transmittance(tt, torch.zeros(n, dtype=torch.int64), torch.zeros(n, 3),
                            torch.tensor([0.0, 0.0, 1.0]).expand(n, 3), dist, 0,
                            torch.arange(n), 0)
    np.testing.assert_allclose(tr.numpy(), np.exp(-np.asarray([0.5, 1.0, 2.0])
                                                  * dist.numpy()[:, None]), rtol=1e-5)


def test_recompute_majorant_matches_jax():
    jt, tt = _tables()
    rng = np.random.default_rng(8)
    sig = rng.uniform(0.5, 3.0, (2, 3)).astype(np.float32)
    grid = rng.random(np.asarray(jt.grid).shape).astype(np.float32) * 2
    want = np.asarray(jmed.recompute_majorant(jt._replace(sigma_t=jnp.asarray(sig),
                                                          grid=jnp.asarray(grid))))
    got = tmed.recompute_majorant(tt._replace(sigma_t=torch.as_tensor(sig),
                                              grid=torch.as_tensor(grid).requires_grad_()))
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)

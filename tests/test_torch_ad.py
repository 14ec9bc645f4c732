"""The port's differentiable path against the JAX package.

K1's backward (ops/merl_sorted.eval_trilinear_bwd; on CPU tensors its
plain version, index_add_) against torch autograd and against jax.vjp of
the JAX package's eval_trilinear; `traverse` / `update` against the JAX
package's; whole-frame gradients against jax.grad of the JAX render on the
same scene arrays; finite differences against AD in the port alone;
compaction under AD; and a miniature of BASELINE configs[3] (recover GGX
roughness by gradient descent). Every input is made from a seed with
numpy; every tolerance is stated where it is used.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_customization_tpu as mct
import mitsuba_customization_tpu_torch as mt
from fixtures import synthetic_table
from mitsuba_customization_tpu.ops import merl_sorted as jk1
from mitsuba_customization_tpu.render import params as jparams
from mitsuba_customization_tpu.render.integrator import render as jax_render
from mitsuba_customization_tpu_torch.models import bsdf as tbsdf
from mitsuba_customization_tpu_torch.ops import merl_sorted as tk1
from mitsuba_customization_tpu_torch.render import ad
from mitsuba_customization_tpu_torch.render import params as tparams
from mitsuba_customization_tpu_torch.render.params import scene_from_numpy
from mitsuba_customization_tpu_torch.scenes import flagship_dict, matpreview_dict
from test_torch_kernels import k1_lanes, one_torch_thread, smooth_table  # noqa: F401
from test_torch_render import _arrays

TABLE = "bsdf.tabulated.table"
ALPHA = ("bsdf.roughconductor.alpha_u", "bsdf.roughconductor.alpha_v")


def _t(x):
    return None if x is None else torch.as_tensor(x)


# ---------------------------------------------------------------------------
# (a), (b) K1's backward
# ---------------------------------------------------------------------------


def _k1_inputs(stacked, rng, n=600):
    """A table with negative entries (so K1's clamp at 0 matters), two
    halves of lanes sharing wi and the slot, masks and a cotangent."""
    shape = (3, 6, 5, 8, 3) if stacked else (6, 5, 8, 3)
    table = (rng.random(shape) - 0.15).astype(np.float32)
    wi, wo = k1_lanes(rng, n)
    wo_b = k1_lanes(rng, n)[1]
    m = wi.shape[0]
    slot = rng.integers(0, 3, m) if stacked else None
    mask, mask_b = rng.random(m) > 0.25, rng.random(m) > 0.4
    g = rng.normal(size=(2 * m, 3)).astype(np.float32)
    return table, (wi, wo, slot, mask, wo_b, mask_b), g


@pytest.mark.parametrize("stacked", [False, True])
def test_k1_bwd_plain_matches_autograd(stacked):
    """K1's plain backward on both halves equals torch.autograd.grad of the
    plain forward, and the autograd Function of eval_trilinear gives it.
    Both sum the same products in other orders: rtol 1e-5, atol 1e-6."""
    table, lanes, g = _k1_inputs(stacked, np.random.default_rng(21))
    lanes, g = tuple(_t(x) for x in lanes), _t(g)
    joined = tk1.concat_halves(*lanes)
    leaf = _t(table).requires_grad_(True)
    (want,) = torch.autograd.grad(tk1.eval_trilinear_plain(leaf, *joined), leaf, g)
    got = tk1.eval_trilinear_bwd_plain(_t(table), g, *joined)
    assert got.shape == table.shape and bool((want != 0).any())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    before = (tk1.LAUNCHES, tk1.LAUNCHES_BWD)
    out = tk1.eval_trilinear(leaf, *lanes)
    (via_fn,) = torch.autograd.grad(out, leaf, g)
    assert (tk1.LAUNCHES, tk1.LAUNCHES_BWD) == before  # CPU: plain versions
    assert torch.equal(out, tk1.eval_trilinear_plain(_t(table), *joined))
    assert torch.equal(via_fn, tk1.eval_trilinear_bwd(_t(table), g, *lanes))


@pytest.mark.parametrize("stacked", [False, True])
def test_k1_bwd_plain_matches_jax_vjp(stacked):
    """Against jax.vjp of the JAX package's eval_trilinear (its forward in
    interpret mode, its backward XLA's VJP of eval_raw) on k1_lanes: the
    same nonzero cells, relative L2 error below 1e-4, and every entry
    within rtol 1e-4 plus atol 1e-4 x max |gradient|.

    eval_raw takes the exact angles and K1 the `_fast` ones (ROADMAP §3).
    k1_lanes keeps its theta_h = 0 lanes where both agree, but where acos
    is taken near 1 (theta_d ~ 0.05: 1 ulp of the cosine is ~1e-6 rad)
    the two differ by up to ~3e-5 rad. The value hardly moves on a smooth
    table, but the gradient takes the fractions at first order: a
    fraction off by 2.4e-5 moves a corner's entry by 2.4e-5 |g|. Measured:
    8.1e-5 at most, 2.5e-5 of the largest entry, relative L2 7e-6."""
    rng = np.random.default_rng(22)
    if stacked:
        table = np.stack([smooth_table(rng) for _ in range(3)])
    else:
        table = smooth_table(rng)
    wi, wo = k1_lanes(rng)
    n = wi.shape[0]
    slot = rng.integers(0, 3, n).astype(np.int32) if stacked else None
    mask = rng.random(n) > 0.25
    g = rng.normal(size=(n, 3)).astype(np.float32)

    jt = jnp.asarray(table)
    jslot = None if slot is None else jnp.asarray(slot)
    _, vjp = jax.vjp(
        lambda t: jk1.eval_trilinear(t, jk1.pack_perm(jt), jnp.asarray(wi),
                                     jnp.asarray(wo), jslot, jnp.asarray(mask), True),
        jt,
    )
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = tk1.eval_trilinear_bwd_plain(_t(table), _t(g), _t(wi), _t(wo),
                                       _t(None if slot is None else slot.astype(np.int64)),
                                       _t(mask)).numpy()
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_array_equal(got != 0, want != 0)
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


# ---------------------------------------------------------------------------
# (c) traverse / update
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_flagship():
    return mct.load_dict(flagship_dict(16, 2, 2))


@pytest.fixture(scope="module")
def port_flagship(jax_flagship):
    return scene_from_numpy(_arrays(jax_flagship), jax_flagship.config, "cpu")


def test_traverse_and_update_match_jax(jax_flagship, port_flagship):
    """The same keys and values; update with a new table rebuilds the
    sampling CDFs as the JAX package does (rtol 1e-4, atol 1e-5, the
    tolerance of the loader's CDF check), puts the given tensors in
    uncopied, and refuses keys that are not parameters of the scene (the
    medium keys of a scene without media);
    the envmap's image is a key of envmap scenes, as in the JAX package."""
    want = {k: np.asarray(v) for k, v in jparams.traverse(jax_flagship).items()}
    got = tparams.traverse(port_flagship)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)

    rng = np.random.default_rng(23)
    new = {TABLE: want[TABLE] * rng.uniform(0.5, 1.5, (1, 1, 1, 1, 3)).astype(np.float32),
           ALPHA[0]: np.full(1, 0.3, np.float32)}
    jsc = jparams.update(jax_flagship, {k: jnp.asarray(v) for k, v in new.items()})
    p = tparams.params_from_numpy(new, "cpu")
    tsc = tparams.update(port_flagship, p)
    tab = tsc.bsdfs.stacks[tbsdf.TABULATED]
    assert tab.table is p[TABLE]
    assert tsc.bsdfs.stacks[tbsdf.ROUGHCONDUCTOR].alpha_u is p[ALPHA[0]]
    for a, b in zip(tab.sampling, jsc.bsdfs.stacks[tbsdf.TABULATED].sampling):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)
    # the CDFs carry no graph of the table
    leaf = p[TABLE].clone().requires_grad_(True)
    sampling = tparams.update(port_flagship, {TABLE: leaf}).bsdfs.stacks[tbsdf.TABULATED].sampling
    assert not any(f.requires_grad for f in sampling)
    # medium keys: parameters of scenes with media only (KeyError here);
    # params_from_numpy takes them as any other key
    with pytest.raises(KeyError):
        tparams.update(port_flagship, {"medium.sigma_t": torch.zeros(1, 3)})
    assert tparams.params_from_numpy({"medium.sigma_t": np.zeros((1, 3))},
                                     "cpu")["medium.sigma_t"].dtype == torch.float32
    # emitter.env_image: a parameter of envmap scenes only (KeyError here);
    # on the flagship lit by an envmap, the JAX key and shape, and update
    # rebuilds the sampling distribution as the JAX package's does (rtol
    # 1e-5, atol 1e-6), from the image itself (the gradient follows)
    with pytest.raises(KeyError):
        tparams.update(port_flagship, {"emitter.env_image": torch.zeros(4, 8, 3)})
    d = flagship_dict(16, 2, 2)
    d["light"] = {"type": "envmap", "bitmap": rng.random((8, 16, 3)).astype(np.float32),
                  "scale": 0.7}
    jenv = mct.load_dict(d)
    tenv = scene_from_numpy(_arrays(jenv), jenv.config, "cpu")
    key = "emitter.env_image"
    want = {k: np.asarray(v) for k, v in jparams.traverse(jenv).items()}
    got = tparams.traverse(tenv)
    assert sorted(got) == sorted(want) and got[key].shape == (8, 16, 3)
    np.testing.assert_array_equal(got[key].numpy(), want[key])
    img = rng.random((8, 16, 3)).astype(np.float32) * 3
    jdist = jparams.update(jenv, {key: jnp.asarray(img)}).emitters.env_dist
    leaf = tparams.params_from_numpy({key: img}, "cpu")[key].requires_grad_(True)
    tsc = tparams.update(tenv, {key: leaf})
    assert tsc.emitters.env_image is leaf
    for a, b in zip(tsc.emitters.env_dist, jdist):
        assert a.requires_grad
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# (d) whole-frame gradients against the JAX package
# ---------------------------------------------------------------------------


def test_frame_gradients_match_jax():
    """jax.grad of the JAX render (ad_mode, the scene of the JAX package's
    test_grad_sorted_path: the flagship at res 16, spp 2, depth 2) against
    the port's grad_render on the same scene arrays and seed, for the
    MERL table and the GGX sphere's alpha (0.15). The sampler is
    bit-identical, so the paths agree; the table gradient differs only
    where the angle formulas part near theta_h = 0, on the table's
    specular ridge. Loss within rtol 1e-5; table gradient within 2e-3
    relative L2 error, the same nonzero cells; alpha within rtol 1e-3."""
    from __graft_entry__ import _flagship_scene

    js = _flagship_scene(res=16, spp=2, depth=2)
    keys = (TABLE,) + ALPHA
    full = jparams.traverse(js)

    def loss(p):
        img = jax_render(jparams.update(js, p), spp=2, seed=0, ad_mode=True)
        return jnp.mean(img ** 2)

    jl, jg = jax.jit(jax.value_and_grad(loss))({k: full[k] for k in keys})
    ts = scene_from_numpy(_arrays(js), js.config, "cpu")
    p = tparams.params_from_numpy({k: np.asarray(full[k]) for k in keys}, "cpu")
    tl, tg = ad.grad_render(ts, p, torch.zeros((16, 16, 3)), spp=2, seed=0)

    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    got, want = tg[TABLE].numpy(), np.asarray(jg[TABLE])
    assert np.isfinite(got).all() and (want != 0).any()
    assert np.linalg.norm(got - want) <= 2e-3 * np.linalg.norm(want)
    np.testing.assert_array_equal(got != 0, want != 0)
    for k in ALPHA:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), rtol=1e-3)
    # ad_mode does not change the image (the JAX package's
    # test_primal_matches_ad_mode)
    img = mt.render(ts, spp=2, seed=0)
    img_ad = ad.render_ad(ts, p, spp=2, seed=0)
    torch.testing.assert_close(img_ad.detach(), img, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# (e) finite differences against AD (the JAX package's tests/test_ad.py)
# ---------------------------------------------------------------------------


def _sphere_scene(bsdf, res, spp, depth, emitter=None):
    return mt.load_dict({
        "type": "scene",
        "integrator": {"type": "path", "max_depth": depth},
        "sensor": {
            "type": "perspective",
            "fov": 40,
            "to_world": mt.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0]),
            "film": {"width": res, "height": res},
            "sampler": {"type": "independent", "sample_count": spp},
        },
        "sphere": {"type": "sphere", "bsdf": bsdf},
        "light": emitter or {"type": "constant", "radiance": [1.0, 1.0, 1.0]},
    }, "cpu")


def _fd_and_ad(scene, key, make, x0, eps, spp, seed, loss_of_img):
    """dL/dx by autograd and by a central difference, L = loss_of_img of
    render_ad(scene, {key: make(x)})."""
    def loss(x):
        return loss_of_img(ad.render_ad(scene, {key: make(x)}, spp=spp, seed=seed))

    x = torch.tensor(x0, requires_grad=True)
    (g,) = torch.autograd.grad(loss(x), x)
    with torch.no_grad():
        fd = (loss(torch.tensor(x0 + eps)) - loss(torch.tensor(x0 - eps))) / (2 * eps)
    return float(g), float(fd)


def test_fd_vs_ad_diffuse_albedo():
    """The furnace of test_ad.py::test_fd_vs_ad_diffuse_albedo: AD within
    5 % of the central difference."""
    scene = _sphere_scene({"type": "diffuse", "reflectance": [0.5] * 3}, 24, 32, 2)
    g, fd = _fd_and_ad(scene, "bsdf.diffuse.reflectance",
                       lambda a: a.expand(1, 3), 0.5, 1e-2, 32, 5,
                       lambda img: torch.mean(img ** 2))
    assert abs(g - fd) / max(abs(fd), 1e-6) < 0.05, (g, fd)


def test_fd_vs_ad_merl_table_scale():
    """test_ad.py::test_fd_vs_ad_merl_table_scale: the whole MERL table
    scaled by s, dL/ds by AD (K1's backward) within 5 % of the central
    difference."""
    table = torch.as_tensor(synthetic_table(alpha=0.4, diffuse=0.2, spec=0.3))
    scene = _sphere_scene({"type": "merl", "table": table.numpy()}, 12, 16, 2)
    g, fd = _fd_and_ad(scene, TABLE, lambda s: table[None] * s, 1.0, 5e-2, 16, 2,
                       lambda img: torch.mean(img ** 2))
    assert abs(g - fd) / max(abs(fd), 1e-6) < 0.05, (g, fd)


def _area_light():
    """A small bright rectangle light beside the camera: the highlight's
    footprint on a GGX sphere depends on alpha."""
    light = (mt.look_at([2.0, 2.0, -3.0], [0, 0, 0], [0, 1, 0])
             @ np.diag([0.25, 0.25, 1.0, 1.0]).astype(np.float32))
    return {"type": "rectangle", "to_world": light,
            "emitter": {"type": "area", "radiance": [160.0] * 3}}


@pytest.mark.parametrize("seed", [0, 1])
def test_fd_vs_ad_ggx_alpha_under_an_area_light(seed):
    """The detached estimator's GGX alpha gradient (bsdf.bounce_shade's
    weight with need_attached; NEE toward the area light with MIS) against
    a central difference (step 0.02) of the same render at alpha 0.4,
    alpha_u and alpha_v moved together. The loss is mean(img * W), W the
    image at alpha 0.25: linear in the image, so a same-sample gradient
    carries no variance term. Within 2 % (measured 0.16 %)."""
    def scene(alpha):
        return _sphere_scene({"type": "roughconductor", "alpha": alpha}, 12, 64, 3,
                             emitter=_area_light())

    w = mt.render(scene(0.25), spp=64, seed=99)
    sc = scene(0.4)

    def loss(x):
        return (ad.render_ad(sc, {k: x for k in ALPHA}, spp=64, seed=seed) * w).mean()

    x = torch.tensor([0.4], requires_grad=True)
    (g,) = torch.autograd.grad(loss(x), x)
    with torch.no_grad():
        fd = (loss(torch.tensor([0.42])) - loss(torch.tensor([0.38]))) / 0.04
    assert float(fd) < 0.0  # a rougher sphere spreads the highlight W weighs
    assert abs(float(g) - float(fd)) <= 0.02 * abs(float(fd)), (float(g), float(fd))


# ---------------------------------------------------------------------------
# (f) compaction under AD
# ---------------------------------------------------------------------------


def test_harvest_only_compaction_keeps_the_gradient():
    """With caps above the live counts the compacting runner only
    re-sorts lanes: under AD (checkpointed bounces whose inputs the runner
    must not overwrite) the loss and the table and alpha gradients equal
    the uncompacted ones (rtol 1e-5, atol 1e-7: sums in another order)."""
    d = matpreview_dict(16, 2, 3, n_sub=3, n_materials=3, compact=(1.0, 1.0, 1.0))
    comp = mt.load_dict(d, "cpu")
    plain = dataclasses.replace(comp, config=dataclasses.replace(comp.config, compact=None))
    full = tparams.traverse(comp)
    p = {k: full[k] for k in (TABLE,) + ALPHA}
    target = torch.full((16, 16, 3), 0.05)
    got_l, got = ad.grad_render(comp, p, target, spp=2, seed=3)
    want_l, want = ad.grad_render(plain, p, target, spp=2, seed=3)
    torch.testing.assert_close(got_l, want_l, rtol=1e-5, atol=0)
    assert bool((want[TABLE] != 0).any()) and bool((want[ALPHA[0]] != 0).all())
    for k in p:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# (g) BASELINE configs[3] in miniature
# ---------------------------------------------------------------------------


def test_inverse_rendering_recovers_roughness():
    """test_ad.py::test_inverse_rendering_recovers_roughness with the
    rectangle area light in place of its point light (not ported): a
    small bright light makes the highlight's footprint depend on alpha.
    Recover alpha 0.25 from 0.45 in 14 Adam steps: |error| < 0.08 and the
    last loss below 0.8 x the first."""
    def scene(alpha):
        return _sphere_scene({"type": "roughconductor", "alpha": alpha}, 12, 16, 3,
                             emitter=_area_light())

    target = mt.render(scene(0.25), spp=32, seed=0)
    params, losses = ad.optimize(scene(0.45), target, list(ALPHA), n_steps=14,
                                 lr=0.08, spp=16)
    a_rec = float(params[ALPHA[0]][0].detach())
    assert abs(a_rec - 0.25) < 0.08, (a_rec, losses)
    assert losses[-1] < losses[0] * 0.8, losses


_POINT = {"type": "point", "position": [2.0, 2.0, -3.0], "intensity": [40.0, 40.0, 40.0]}


@pytest.mark.parametrize("loop", ["optimize", "Optimizer"])
def test_inverse_rendering_recovers_roughness_point_light(loop):
    """test_ad.py::test_inverse_rendering_recovers_roughness as the JAX
    package writes it, with its point light: recover alpha 0.25 from 0.45
    in 14 steps at lr 0.08, |error| < 0.08 and the last loss below 0.8 x
    the first; once through ad.optimize and once through the same loop
    written with Optimizer(optimizer=a torch.optim.Adam factory), which
    takes the same steps."""
    def scene(alpha):
        return _sphere_scene({"type": "roughconductor", "alpha": alpha}, 12, 16, 3,
                             emitter=_POINT)

    target = mt.render(scene(0.25), spp=32, seed=0)
    init = scene(0.45)
    if loop == "optimize":
        params, losses = ad.optimize(init, target, list(ALPHA), n_steps=14, lr=0.08, spp=16)
    else:
        full = tparams.traverse(init)
        opt = ad.Optimizer({k: full[k] for k in ALPHA}, 0.08,
                           lambda ps: torch.optim.Adam(ps, lr=0.08), list(ALPHA))
        losses = []
        for it in range(14):
            loss, grads = ad.grad_render(init, opt.params, target, spp=16, seed=it + 1)
            params = opt.step(grads)
            losses.append(float(loss))
        want, want_losses = ad.optimize(init, target, list(ALPHA), n_steps=14, lr=0.08,
                                        spp=16)
        assert losses == want_losses
        assert all(torch.equal(params[k], want[k]) for k in ALPHA)
    a_rec = float(params[ALPHA[0]][0].detach())
    assert abs(a_rec - 0.25) < 0.08, (a_rec, losses)
    assert losses[-1] < losses[0] * 0.8, losses

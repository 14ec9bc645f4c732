"""The port's per-lane loops that once checked on the host, against the
JAX package's, on the CPU: T1 / T2's plain versions (render/medium.
delta_track_plain, ratio_track_plain) against the JAX while_loops of
sample_interaction and transmittance, ad_mode's 48-step tracking
against the JAX scan (values and gradients), S1's plain version
(render/sdf.march_plain) against the JAX sphere trace on the same local
rays, the loops' refusal of a gradient, and the light tracers' splat of
every row (render/ptracer.splat_rows, whole and in chunks) against the
splat of the rows that are not zero.

Tolerances: a lane's flags may part where a step lands within rounding
of t_max or of the real-collision probability (>= 99.9 % agree), values
within rtol 1e-4 where they agree, transmittance within rtol 1e-4 and
atol 1e-6 (tests/test_torch_media.py says why). Inputs are made from
seeds with numpy; one torch thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_customization_tpu.render import medium as jmed
from mitsuba_customization_tpu.render import sdf as jsdf
from mitsuba_customization_tpu_torch.core.qmc import hash_combine
from mitsuba_customization_tpu_torch.render import film as tfilm
from mitsuba_customization_tpu_torch.render import medium as tmed
from mitsuba_customization_tpu_torch.render import ptracer as tpt
from mitsuba_customization_tpu_torch.render import sdf as tsdf
from test_torch_kernels import one_torch_thread  # noqa: F401

N = 4096
SEED, DELTA_BASE, RATIO_BASE = 5, 8, 2056


def _tables(dense):
    """A homogeneous and a heterogeneous medium (a seeded 9x10x11 grid;
    `dense`: extinction 40-50 over a grid mostly at 0.05, where many lanes
    take more than 48 steps) for both packages."""
    grid = np.random.default_rng(11).random((9, 10, 11)).astype(np.float32)
    if dense:
        grid = np.where(grid > 0.9, grid, 0.05).astype(np.float32)
    rows = [dict(type="homogeneous", sigma_t=np.asarray([0.5, 1.0, 2.0], np.float32),
                 albedo=np.asarray([0.8, 0.7, 0.6], np.float32), phase_type=0, phase_g=0.0),
            dict(type="heterogeneous",
                 sigma_t=np.asarray((40.0, 45.0, 50.0) if dense else (2.0, 3.0, 4.0),
                                    np.float32),
                 albedo=np.asarray([0.9, 0.8, 0.7], np.float32), phase_type=1, phase_g=0.5,
                 density=grid, to_world=np.diag([2.0, 2.0, 2.0, 1.0]))]
    return jmed.build_table(rows, [0, 1], 2), tmed.build_table(rows, [0, 1], 2, device="cpu")


def _rays(dense, seed=7):
    """Seeded rays (o, d, segment ends up to 3, or 8 when dense, 1e7 on
    every 97th lane, each lane's medium in {-1, 0, 1}) as numpy arrays."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.0, 2.0, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = rng.uniform(0.1, 8.0 if dense else 3.0, N).astype(np.float32)
    t_max[::97] = 1e7
    return o, d, t_max, rng.integers(-1, 2, N)


def _jax(fn, jt, rays, base, ad_mode=False, **leaves):
    o, d, t_max, mid = rays
    table = jt._replace(**{k: jnp.asarray(v) for k, v in leaves.items()})
    return fn(table, jnp.asarray(mid, jnp.int32), jnp.asarray(o), jnp.asarray(d),
              jnp.asarray(t_max), jnp.uint32(SEED), jnp.arange(N, dtype=jnp.uint32),
              jnp.uint32(base), ad_mode=ad_mode)


def _torch(rays):
    o, d, t_max, mid = rays
    return (torch.as_tensor(mid), torch.as_tensor(o), torch.as_tensor(d),
            torch.as_tensor(t_max), hash_combine(SEED, torch.arange(N, dtype=torch.int64)))


@pytest.mark.parametrize("dense", [False, True], ids=["thin", "dense"])
def test_tracking_plain_versions_match_jax_primal(dense):
    """delta_track_plain / ratio_track_plain against the JAX primal
    while_loops on the heterogeneous lanes: the scatter flag (JAX's
    is_medium), t, the weight (JAX's, the albedo applied on a scatter;
    within atol 1e-6 too: a null-collision factor (majorant - sigma) /
    (majorant (1 - p_real)) cancels where the density nears its maximum)
    and the transmittance; the other lanes untouched (t 0, weight 1, 0
    steps); some lanes run all 257 updates."""
    jt, tt = _tables(dense)
    rays = _rays(dense)
    mid, o, d, t_max, key = _torch(rays)
    t, w, scat, steps = tmed.delta_track_plain(tt, mid, o, d, t_max, key, DELTA_BASE)
    tr, tr_steps = tmed.ratio_track_plain(tt, mid, o, d, t_max, key, RATIO_BASE)
    js = _jax(jmed.sample_interaction, jt, rays, DELTA_BASE)
    jtr = np.asarray(_jax(jmed.transmittance, jt, rays, RATIO_BASE))
    het = rays[3] == 1
    agree = np.asarray(js.is_medium)[het] == scat.numpy()[het]
    assert agree.mean() >= 0.999 and 0.05 < scat.numpy()[het].mean() < 0.95
    np.testing.assert_allclose(t.numpy()[het][agree], np.asarray(js.t)[het][agree], rtol=1e-4)
    alb = np.asarray([0.9, 0.8, 0.7], np.float32)
    w_j = np.where(scat.numpy()[:, None], w.numpy() * alb, w.numpy())
    np.testing.assert_allclose(w_j[het][agree], np.asarray(js.weight)[het][agree], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tr.numpy()[het], jtr[het], rtol=1e-4, atol=1e-6)
    for x, fill in ((t, 0.0), (w, 1.0), (scat, False), (steps, 0), (tr, 1.0), (tr_steps, 0)):
        assert bool((x[~torch.as_tensor(het)] == fill).all())
    assert int(steps.max()) == int(tr_steps.max()) == tmed.MAX_TRACKING_STEPS + 1


def test_ad_mode_scan_matches_jax_with_gradients():
    """ad_mode's 48-step tracking over all lanes (render/medium._Track
    through sample_interaction and transmittance: _scan's values, the
    gradients by track_bwd_plain) against the JAX scan in
    ad_mode on the dense medium (lanes cut at 48 steps among them): the
    values as in the primal test, and the gradients of a fixed weighted
    sum of the weights, the emission and the transmittance (over the lanes
    whose flags agree) with respect to sigma_t and the density grid,
    within 1e-4 relative L2 error."""
    jt, tt = _tables(True)
    rays = _rays(True, seed=8)
    mid, o, d, t_max, key = _torch(rays)
    rng = np.random.default_rng(9)
    cw, ct = rng.random((N, 3)).astype(np.float32), rng.random((N, 3)).astype(np.float32)
    js0 = _jax(jmed.sample_interaction, jt, rays, DELTA_BASE, True)
    ts0 = tmed.sample_interaction(tt, mid, o, d, t_max, SEED, torch.arange(N), DELTA_BASE,
                                  ad_mode=True)
    agree = np.asarray(js0.is_medium) == ts0.is_medium.numpy()
    assert agree.mean() >= 0.999
    mask = agree[:, None].astype(np.float32)

    def jloss(sigma_t, grid):
        leaves = dict(sigma_t=sigma_t, grid=grid)
        ms = _jax(jmed.sample_interaction, jt, rays, DELTA_BASE, True, **leaves)
        tr = _jax(jmed.transmittance, jt, rays, RATIO_BASE, True, **leaves)
        return jnp.sum(mask * cw * (ms.weight + ms.emitted)) + jnp.sum(ct * tr)

    jl, (jg_s, jg_g) = jax.value_and_grad(jloss, (0, 1))(jt.sigma_t, jt.grid)
    sig = tt.sigma_t.clone().requires_grad_(True)
    grid = tt.grid.clone().requires_grad_(True)
    table = tt._replace(sigma_t=sig, grid=grid)
    ms = tmed.sample_interaction(table, mid, o, d, t_max, SEED, torch.arange(N), DELTA_BASE,
                                 ad_mode=True)
    tr = tmed.transmittance(table, mid, o, d, t_max, SEED, torch.arange(N), RATIO_BASE,
                            ad_mode=True)
    loss = ((torch.as_tensor(mask * cw) * (ms.weight + ms.emitted)).sum()
            + (torch.as_tensor(ct) * tr).sum())
    g_s, g_g = torch.autograd.grad(loss, (sig, grid))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    for got, want in ((g_s, jg_s), (g_g, jg_g)):
        want = np.asarray(want)
        assert np.isfinite(got.numpy()).all() and (want != 0).any()
        assert np.linalg.norm(got.numpy() - want) <= 1e-4 * np.linalg.norm(want)


def test_tracking_has_no_gradient_outside_ad_mode():
    """Outside ad_mode the loops (T1 / T2 or their plain versions) raise
    where an input requires grad under grad mode, as jax.grad through the
    JAX while_loop does; under no_grad and in ad_mode they run."""
    _, tt = _tables(False)
    mid, o, d, t_max, _ = _torch(_rays(False))
    lane = torch.arange(N)
    table = tt._replace(sigma_t=tt.sigma_t.clone().requires_grad_(True))
    with pytest.raises(RuntimeError, match="ad_mode"):
        tmed.sample_interaction(table, mid, o, d, t_max, SEED, lane, 0)
    with pytest.raises(RuntimeError, match="ad_mode"):
        tmed.transmittance(table, mid, o, d, t_max, SEED, lane, 0)
    with torch.no_grad():
        tmed.sample_interaction(table, mid, o, d, t_max, SEED, lane, 0)
    assert tmed.transmittance(table, mid, o, d, t_max, SEED, lane, 0, ad_mode=True).requires_grad


def test_tracking_records_only_when_asked(monkeypatch):
    """medium.LOOPS and sdf.MARCHES stay None (nothing kept) unless set to
    a list; then each loop appends its kind, lanes, each lane's steps and
    the plain version's host checks."""
    _, tt = _tables(False)
    mid, o, d, t_max, key = _torch(_rays(False))
    assert tmed.LOOPS is None and tsdf.MARCHES is None
    tmed.delta_track(tt, mid, o, d, t_max, key, 0)
    monkeypatch.setattr(tmed, "LOOPS", [])
    _, _, _, steps = tmed.delta_track(tt, mid, o, d, t_max, key, 0)
    tmed.ratio_track(tt, mid, o, d, t_max, key, 0)
    (k1, n1, s1, c1), (k2, n2, s2, c2) = tmed.LOOPS
    assert (k1, n1, k2, n2) == ("delta", N, "ratio", N) and s1 is steps
    assert s1.dtype == s2.dtype == torch.int32 and c1 > 0 and c2 > 0
    monkeypatch.setattr(tsdf, "MARCHES", [])
    ray = tuple(torch.as_tensor(x) for x in _sdf_rays())
    t, hit, steps = tsdf.march(tsdf.make(tsdf.sphere_sdf(n=24), device="cpu"), *ray)
    assert len(tsdf.MARCHES) == 1 and tsdf.MARCHES[0][0] is steps
    assert int(steps.max()) > 0 and tsdf.MARCHES[0][1] > 0


@pytest.mark.parametrize("shape", [(2, 2, 2), (3, 5, 7), (9, 4, 11)])
def test_corner_layout_holds_every_node(shape):
    """S1's corner layout (sdf.corner_layout) read as the kernel reads it
    (sdf.cell_corners: the float4 at node (x0 Ny + y0) Nz + z0 and the one
    Ny Nz further) gives values[x0 + dx, y0 + dy, z0 + dz] for every corner
    of every cell of small odd grids, which reads every node."""
    rng = np.random.default_rng(sum(shape))
    values = torch.as_tensor(rng.normal(size=shape).astype(np.float32))
    corners = tsdf.corner_layout(values)
    assert corners.shape == shape + (4,) and corners.is_contiguous()
    x0, y0, z0 = torch.meshgrid(*(torch.arange(n - 1) for n in shape), indexing="ij")
    got = tsdf.cell_corners(corners, x0, y0, z0)
    seen = torch.zeros(shape, dtype=torch.bool)
    for c in range(8):
        dx, dy, dz = c >> 2, (c >> 1) & 1, c & 1
        assert torch.equal(got[..., c], values[x0 + dx, y0 + dy, z0 + dz]), c
        seen[x0 + dx, y0 + dy, z0 + dz] = True
    assert bool(seen.all())
    # the grid a scene holds carries its layout
    g = tsdf.make(values.numpy(), device="cpu")
    assert torch.equal(g.corners, corners)


def test_march_has_no_gradient():
    """sdf.march (S1 or its plain version) raises where the grid or a ray
    input requires grad under grad mode, as the tracking loops and
    jax.grad through the JAX while_loop do; under no_grad it runs."""
    ray = [torch.as_tensor(x) for x in _sdf_rays()]
    grid = tsdf.make(tsdf.sphere_sdf(n=24), device="cpu")
    for i in (0, 1, 2, 4):
        moved = list(ray)
        moved[i] = moved[i].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="no gradient"):
            tsdf.march(grid, *moved)
        with torch.no_grad():
            t, _, _ = tsdf.march(grid, *moved)
        assert torch.equal(t, tsdf.march(grid, *ray)[0])
    values = grid.values.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no gradient"):
        tsdf.march(grid._replace(values=values), *ray)


def _sdf_rays(n=N, seed=3):
    """Local-frame rays at the unit cube (o, d not normalised, t_start,
    t_end, d_norm, active) as the intersect prologue makes them, in
    numpy."""
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 0.1 + [0.5, 0.5, -1.0]).astype(np.float32)
    d = (rng.normal(size=(n, 3)) * 0.25 + [0.5, 0.5, 0.5] - o).astype(np.float32) * 0.7
    inv = 1.0 / np.where(np.abs(d) < 1e-12, 1e-12, d)
    t0, t1 = (0.0 - o) * inv, (1.0 - o) * inv
    near, far = np.minimum(t0, t1).max(-1), np.maximum(t0, t1).min(-1)
    t_start = (np.maximum(near, 0.0) + 1e-5).astype(np.float32)
    maxt = np.where(rng.random(n) < 0.1, 2.0, np.inf).astype(np.float32)
    t_end = np.minimum(far, maxt).astype(np.float32)
    d_norm = np.maximum(np.linalg.norm(d, axis=-1), 1e-12).astype(np.float32)
    active = (near <= far) & (far > 0.0) & (t_start < maxt)
    return o, d, t_start, t_end, d_norm, active


@pytest.mark.parametrize("grid", ["sphere", "noise"])
def test_march_plain_matches_jax(grid):
    """march_plain against the JAX sphere trace (intersect's body under
    _bounded_trace) on the same local rays through a 40^3 sphere or a
    seeded 24x27x21 grid of small distances: hit flags equal on >= 99.9 %
    of lanes; where both hit, t within rtol 1e-5 on >= 99.5 % of lanes
    and within a few steps of HIT_EPS / |d| on all (a distance that lands
    within rounding of HIT_EPS stops one package a step later: XLA and
    torch round the trilinear apart); some lanes march every step."""
    rng = np.random.default_rng(4)
    values = (tsdf.sphere_sdf(n=40) if grid == "sphere"
              else rng.normal(size=(24, 27, 21)).astype(np.float32) * 0.05 + 0.03)
    o, d, t_start, t_end, d_norm, active = _sdf_rays()
    jg = jsdf.make(values)

    def body(state):
        t, act, hit = state
        dist = jsdf.sample(jg, jnp.asarray(o) + t[..., None] * jnp.asarray(d))
        is_hit = act & (dist < jsdf.HIT_EPS)
        t_new = jnp.where(act & ~is_hit, t + jnp.maximum(dist, jsdf.HIT_EPS) / d_norm, t)
        return t_new, act & ~is_hit & (t_new <= t_end), hit | is_hit

    jt, _, jhit = jsdf._bounded_trace(lambda s: jnp.any(s[1]), body, (
        jnp.asarray(t_start), jnp.asarray(active), jnp.zeros(N, bool)))
    t, hit, steps = tsdf.march_plain(tsdf.make(values, device="cpu"),
                                     *(torch.as_tensor(x) for x in (o, d, t_start, t_end,
                                                                    d_norm, active)))
    jhit = np.asarray(jhit)
    assert (hit.numpy() == jhit).mean() >= 0.999 and 0.1 < jhit.mean() < 0.99
    both = hit.numpy() & jhit
    dt = np.abs(t.numpy() - np.asarray(jt))[both]
    assert (dt <= 1e-5 * np.asarray(jt)[both]).mean() >= 0.995
    assert (dt <= 4 * tsdf.HIT_EPS / d_norm[both]).all()
    assert int(steps.max()) == tsdf.MAX_STEPS or grid == "noise"
    assert bool((steps[~torch.as_tensor(active)] == 0).all())


def test_splat_rows_equals_the_splat_of_the_rows_that_are_not_zero():
    """splat_rows (every row, a zero row moved to a pixel of its own)
    equals film.splat of the nonzero rows bit for bit on the CPU, under
    the box and the gaussian filter, where the zero rows' film positions
    are garbage (NaN, inf, far outside the film)."""
    rng = np.random.default_rng(12)
    n, h, w = 6000, 12, 10
    values = rng.random((n, 3)).astype(np.float32)
    values[rng.random(n) < 0.8] = 0.0
    xy = (rng.random((n, 2)) * [w, h]).astype(np.float32)
    zero = ~(values != 0).any(-1)
    bad = np.flatnonzero(zero)
    xy[bad[::3]] = np.nan
    xy[bad[1::3]] = np.inf
    xy[bad[2::3]] = -1e9
    v, p = torch.as_tensor(values), torch.as_tensor(xy)
    keep = torch.as_tensor(~zero)
    for ft in (tfilm.BOX, tfilm.GAUSSIAN):
        got = tpt.splat_rows(v, p, h, w, ft)
        want = tfilm.splat(v[keep], p[keep], h, w, ft)[0]
        assert bool(torch.isfinite(got).all()) and torch.equal(got, want)


def test_splat_rows_in_chunks_equals_one_splat(monkeypatch):
    """splat_rows over rows SPLAT_CHUNK at a time (here 700 of 6000: a
    last chunk shorter) equals the splat of all the nonzero rows at once
    within float32 rounding of the changed sum order (rtol 1e-5, atol
    1e-6), under the box and the gaussian filter."""
    rng = np.random.default_rng(13)
    n, h, w = 6000, 12, 10
    values = rng.random((n, 3)).astype(np.float32)
    values[rng.random(n) < 0.8] = 0.0
    xy = (rng.random((n, 2)) * [w, h]).astype(np.float32)
    xy[~(values != 0).any(-1)] = np.nan
    v, p = torch.as_tensor(values), torch.as_tensor(xy)
    keep = (v != 0).any(-1)
    monkeypatch.setattr(tpt, "SPLAT_CHUNK", 700)
    for ft in (tfilm.BOX, tfilm.GAUSSIAN):
        got = tpt.splat_rows(v, p, h, w, ft)
        want = tfilm.splat(v[keep], p[keep], h, w, ft)[0]
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)

"""ad_mode's tracking on the CPU (render/medium._Track: _scan's values
forward, track_bwd_plain backward; on the card T1 / T2 at 48 steps and
T1-bwd / T2-bwd), against autograd through medium._scan and jax.vjp of
the JAX package's sample_interaction / transmittance in ad_mode:

- track_bwd_plain's gradients in sigma_t, the grid, ray_o, ray_d and
  t_max against torch.autograd through _scan, and the port's
  sample_interaction / transmittance (through _Track) against jax.vjp of
  the JAX ones, on the thin and dense media of tests/test_torch_tracking.py
  (lanes cut at 48 steps among them), within 1e-4 relative L2 error (the
  tolerance of test_ad_mode_scan_matches_jax_with_gradients);
- lanes whose factor is exactly 0 (a ratio factor at or past its clamp,
  a delta null weight of 0, zero denominators beside them) get finite
  gradients equal to autograd's;
- several tracking calls sharing one grid sink make one grid-sized
  gradient buffer, equal to the sum of their own gradients;
- a small volpath AD step keeps its loss and gradients against the
  torch scan it replaced, and hands the tracking ray and t_max gradients.

Inputs are made from seeds with numpy; one torch thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_customization_tpu_torch as mt
from mitsuba_customization_tpu.render import medium as jmed
from mitsuba_customization_tpu_torch import scenes
from mitsuba_customization_tpu_torch.core.qmc import hash_combine
from mitsuba_customization_tpu_torch.ops import merl_sorted
from mitsuba_customization_tpu_torch.render import ad
from mitsuba_customization_tpu_torch.render import medium as tmed
from mitsuba_customization_tpu_torch.render import params as tparams
from test_torch_kernels import one_torch_thread  # noqa: F401
from test_torch_tracking import DELTA_BASE, N, RATIO_BASE, SEED, _rays, _tables, _torch

BASES = {"delta": DELTA_BASE, "ratio": RATIO_BASE}
NAMES = ("sigma_t", "grid", "ray_o", "ray_d", "t_max")


def _rel(got, want):
    """Relative L2 error (where `want` is 0: the norm of `got`)."""
    norm = float(want.double().norm())
    diff = float((got - want).double().norm())
    return diff / norm if norm > 0 else diff


def _cotangents(seed=9):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.random((N, 3)).astype(np.float32)),
            torch.as_tensor(rng.random(N).astype(np.float32)))


def _autograd(kind, table, mid, o, d, t_max, key, g_w, g_t):
    """The gradients [sigma_t, grid, ray_o, ray_d, t_max] of <g_w, w> (+
    <g_t, t> for delta) by autograd through _scan."""
    leaves = [x.clone().requires_grad_(True) for x in (table.sigma_t, table.grid, o, d, t_max)]
    out = tmed._scan(kind, table._replace(sigma_t=leaves[0], grid=leaves[1]), mid, *leaves[2:],
                     key, BASES[kind])
    loss = (g_w * out[1]).sum() + ((g_t * out[0]).sum() if kind == "delta" else 0.0)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]


def _plain(kind, table, mid, o, d, t_max, key, g_w, g_t):
    """track_bwd_plain's gradients, in _autograd's order."""
    grid = torch.zeros_like(table.grid)
    g_s, g_o, g_d, g_tm = tmed.track_bwd_plain(
        kind, table, mid, o, d, t_max, key, BASES[kind], g_w, g_t if kind == "delta" else None,
        grid_out=grid, need_rays=True, need_t_max=True)
    return [g_s, grid, g_o, g_d, g_tm]


@pytest.mark.parametrize("kind", ["delta", "ratio"])
@pytest.mark.parametrize("dense", [False, True], ids=["thin", "dense"])
def test_track_bwd_plain_matches_autograd_and_jax(kind, dense):
    """track_bwd_plain against autograd through _scan (every gradient
    within 1e-4 relative L2); then the port's sample_interaction (delta)
    or transmittance (ratio) in ad_mode, which runs _Track, against jax.vjp
    of the JAX function on the same inputs: the weight and emission (over
    the lanes whose scatter flags agree) and t, or the transmittance, with
    seeded cotangents, differentiated in sigma_t, the grid, ray_o, ray_d
    and t_max, within 1e-4 relative L2 error. In the dense medium some
    lanes are cut at 48 steps."""
    jt, tt = _tables(dense)
    rays = _rays(dense, seed=8)
    mid, o, d, t_max, key = _torch(rays)
    g_w, g_t = _cotangents()
    got = _plain(kind, tt, mid, o, d, t_max, key, g_w, g_t)
    want = _autograd(kind, tt, mid, o, d, t_max, key, g_w, g_t)
    for name, a, b in zip(NAMES, got, want):
        assert bool(torch.isfinite(a).all()), name
        assert _rel(a, b) <= 1e-4, (name, _rel(a, b))
    assert float(want[1].norm()) > 0 and float(want[3].norm()) > 0
    if kind == "delta":
        assert float(want[4].norm()) > 0

    lane = torch.arange(N)
    leaves = [x.clone().requires_grad_(True) for x in (tt.sigma_t, tt.grid, o, d, t_max)]
    table = tt._replace(sigma_t=leaves[0], grid=leaves[1])
    jfn = jmed.sample_interaction if kind == "delta" else jmed.transmittance
    tfn = tmed.sample_interaction if kind == "delta" else tmed.transmittance
    out = tfn(table, mid, *leaves[2:], SEED, lane, BASES[kind], ad_mode=True)

    def jax_fn(sigma_t, grid, ray_o, ray_d, tmax):
        return jfn(jt._replace(sigma_t=sigma_t, grid=grid), jnp.asarray(rays[3], jnp.int32),
                   ray_o, ray_d, tmax, jnp.uint32(SEED), jnp.arange(N, dtype=jnp.uint32),
                   jnp.uint32(BASES[kind]), ad_mode=True)

    primal = [jnp.asarray(x.detach().numpy()) for x in leaves]
    jout, vjp = jax.vjp(jax_fn, *primal)
    if kind == "delta":
        agree = (np.asarray(jout.is_medium) == out.is_medium.numpy()).astype(np.float32)
        assert agree.mean() >= 0.999
        cw = g_w.numpy() * agree[:, None]
        ct = g_t.numpy() * agree
        loss = ((torch.as_tensor(cw) * (out.weight + out.emitted)).sum()
                + (torch.as_tensor(ct) * out.t).sum())
        jg = vjp(jmed.MediumSample(is_medium=np.zeros(N, jax.dtypes.float0),
                                   t=jnp.asarray(ct), weight=jnp.asarray(cw),
                                   emitted=jnp.asarray(cw)))
    else:
        loss = (g_w * out).sum()
        jg = vjp(jnp.asarray(g_w.numpy()))
    tg = torch.autograd.grad(loss, leaves, allow_unused=True)
    for name, a, b in zip(NAMES, tg, jg):
        b = torch.as_tensor(np.array(b))
        a = torch.zeros_like(b) if a is None else a
        assert bool(torch.isfinite(a).all()), name
        assert _rel(a, b) <= 1e-4, (name, _rel(a, b))


def _zero_factor_table():
    """A heterogeneous medium with extinction (1, 1, 4) (mean 2) over a
    grid at 0.5 with a 2x2x2 block at 1.0 (majorant 2): where the density
    is 0.5, channel 2's null weight (2 - 2) / (2 (1 - 0.5)) and ratio
    factor 1 - 2 / 2 are exactly 0; where it exceeds 0.5 the ratio factor
    clamps to 0; where it is 1, p_real is 1 and the null weight's
    denominator 0."""
    grid = np.full((8, 8, 8), 0.5, np.float32)
    grid[2:4, 2:4, 2:4] = 1.0
    rows = [dict(type="heterogeneous", sigma_t=np.asarray([1.0, 1.0, 4.0], np.float32),
                 albedo=np.asarray([0.9, 0.8, 0.7], np.float32), phase_type=0, phase_g=0.0,
                 density=grid, to_world=np.diag([2.0, 2.0, 2.0, 1.0]))]
    return tmed.build_table(rows, [0], 1, device="cpu")


@pytest.mark.parametrize("kind", ["delta", "ratio"])
def test_zero_factors_have_finite_gradients_equal_to_autograds(kind):
    """Lanes whose product of factors is exactly 0 in channel 2 (a ratio
    factor at or past its clamp, a delta null weight of 0): track_bwd_plain's
    gradients finite and within 1e-4 relative L2 of autograd's through
    _scan, over all lanes and over those lanes' ray gradients alone (no
    division by a suffix product); zero denominators (p_real 1 on the
    dense block) give no NaN."""
    table = _zero_factor_table()
    rng = np.random.default_rng(12)
    o = torch.as_tensor(rng.uniform(0.2, 1.8, (N, 3)).astype(np.float32))
    d = torch.as_tensor(rng.normal(size=(N, 3)).astype(np.float32))
    d = d / d.norm(dim=-1, keepdim=True)
    t_max = torch.as_tensor(rng.uniform(0.5, 3.0, N).astype(np.float32))
    mid = torch.zeros(N, dtype=torch.int64)
    key = hash_combine(SEED, torch.arange(N, dtype=torch.int64))
    g_w, g_t = _cotangents(13)
    w = tmed._scan(kind, table, mid, o, d, t_max, key, BASES[kind])[1]
    zero = (w[:, 2] == 0) & (w[:, 0] != 0)
    assert int(zero.sum()) > 10
    got = _plain(kind, table, mid, o, d, t_max, key, g_w, g_t)
    want = _autograd(kind, table, mid, o, d, t_max, key, g_w, g_t)
    for name, a, b in zip(NAMES, got, want):
        assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all()), name
        assert _rel(a, b) <= 1e-4, (name, _rel(a, b))
    for a, b in zip(got[2:4], want[2:4]):
        assert _rel(a[zero], b[zero]) <= 1e-4
    assert float(got[0][0, 2].abs()) > 0


def test_one_grid_buffer_for_calls_sharing_a_sink():
    """Three sample_interaction and three transmittance calls in ad_mode on
    a table whose grid enters autograd through one sink
    (merl_sorted.grad_sink, as params.update makes it): the backward makes
    one grid-sized buffer (medium.GRID_BUFFERS), the grid's gradient equals
    (relative L2 1e-5: the order of the sums) that of the same calls
    without a sink, each making a buffer of its own."""
    _, tt = _tables(True)
    mid, o, d, t_max, _ = _torch(_rays(True, seed=8))
    lane = torch.arange(N)
    g_w, g_t = _cotangents()

    def grad(sink):
        grid = tt.grid.clone().requires_grad_(True)
        table = tt._replace(grid=grid, grid_sink=merl_sorted.grad_sink(grid) if sink else None)
        loss = 0.0
        for i in range(3):
            ms = tmed.sample_interaction(table, mid, o, d, t_max, SEED, lane, 100 * i,
                                         ad_mode=True)
            tr = tmed.transmittance(table, mid, o, d, t_max, SEED, lane, 5000 + 100 * i,
                                    ad_mode=True)
            loss = loss + (g_w * ms.weight).sum() + (g_t * ms.t).sum() + (g_w * tr).sum()
        tmed.GRID_BUFFERS = 0
        (g,) = torch.autograd.grad(loss, grid)
        return g, tmed.GRID_BUFFERS

    shared, n_shared = grad(True)
    own, n_own = grad(False)
    assert (n_shared, n_own) == (1, 6)
    assert float(own.norm()) > 0 and _rel(shared, own) <= 1e-5


def test_volpath_step_keeps_the_scans_loss_and_gradients(monkeypatch):
    """A volpath AD step (scenes.volpath_dict at 16x16, 2 spp, depth 3, a
    16^3 grid; the table stack and the four medium keys; the eager step)
    through _Track against the same step through the torch scan it
    replaced (medium._track swapped for autograd through _scan): the loss
    bit for bit, each gradient within 1e-4 relative L2 error; one grid-sized
    buffer against one a tracking step of the backward; the step hands
    _Track ray and t_max gradients (the scattered lanes' origins, the
    phase-sampled directions), which the kernels then give."""
    keys = ("bsdf.tabulated.table", "medium.sigma_t", "medium.albedo", "medium.phase_g",
            "medium.density")
    scene = mt.load_dict(scenes.volpath_dict(16, 2, 3, 16, 10, n_sub=2), "cpu")
    full = tparams.traverse(scene)
    target = torch.zeros((16, 16, 3))
    needs = set()
    backward = tmed._Track.backward

    def recorded(ctx, *grads):
        needs.add(tuple(ctx.needs_input_grad[2:5]))
        return backward(ctx, *grads)

    monkeypatch.setattr(tmed._Track, "backward", staticmethod(recorded))
    tmed.GRID_BUFFERS = 0
    loss, grads = ad._eager_loss_and_grad(scene, {k: full[k] for k in keys}, target, 2, 1)
    buffers = tmed.GRID_BUFFERS

    def scan(kind, table, mid, o, d, t_max, key, dim_base):
        out = tmed._scan(kind, table, mid, o, d, t_max, key, dim_base)
        return out[:3] if kind == "delta" else out[1:2]

    monkeypatch.setattr(tmed, "_track", scan)
    tmed.GRID_BUFFERS = 0
    loss_s, grads_s = ad._eager_loss_and_grad(scene, {k: full[k] for k in keys}, target, 2, 1)
    assert buffers == 1 and tmed.GRID_BUFFERS > 1
    assert float(loss) == float(loss_s)
    for k in keys:
        assert bool(torch.isfinite(grads[k]).all()) and float(grads_s[k].norm()) > 0, k
        assert _rel(grads[k], grads_s[k]) <= 1e-4, (k, _rel(grads[k], grads_s[k]))
    assert any(any(n) for n in needs)

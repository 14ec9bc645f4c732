"""The port's CUDA kernels (K1-K4, K1's backward, B1 / B2, T1 / T2 and S1)
against their plain PyTorch versions, and the captured frames and steps
against the eager ones, on a GPU.

Needs an NVIDIA Hopper GPU and nvcc; skips without one. This file imports
no JAX, so on a machine without it run it past tests/conftest.py:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from mitsuba_customization_tpu_torch.ops import clusters as cl
from mitsuba_customization_tpu_torch.ops import marginal_sorted as k2
from mitsuba_customization_tpu_torch.ops import merl_sorted as k1
from mitsuba_customization_tpu_torch.render import geometry as geo
from mitsuba_customization_tpu_torch.render.records import Ray
from mitsuba_customization_tpu_torch.utils.meshgen import icosphere_blob, vertex_normals

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _table(dev, shape=(16, 16, 32, 3)):
    """Smooth along all axes; the phi_d term vanishes at the poles, where
    phi_d is undefined (see tests/test_torch_kernels.smooth_table)."""
    n_th, n_td, n_pd, _ = shape
    th = ((torch.arange(n_th, device=dev) + 0.5) / n_th) ** 2 * (torch.pi / 2)
    td = (torch.arange(n_td, device=dev) + 0.5) / n_td * (torch.pi / 2)
    pd = (torch.arange(n_pd, device=dev) + 0.5) / n_pd * torch.pi
    return (0.3 + 0.1 * torch.cos(3 * th)[:, None, None, None]
            * torch.cos(2 * td)[None, :, None, None]
            + 0.1 * torch.sin(th)[:, None, None, None] ** 2
            * torch.sin(td)[None, :, None, None]
            * torch.cos(2 * pd)[None, None, :, None]).expand(shape).contiguous()


def _unit(gen, n, dev):
    v = torch.randn((n, 3), generator=gen, device=dev)
    v[:, 2] = v[:, 2].abs() + 1e-3
    return v / v.norm(dim=-1, keepdim=True)


def test_k1_kernel_matches_plain(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    n = 100_000
    wi, wo = _unit(gen, n, dev), _unit(gen, n, dev)
    wo[:100, 2] *= -1
    stack = torch.stack([_table(dev), 0.5 * _table(dev).flip(0)])
    slot = torch.randint(0, 2, (n,), generator=gen, device=dev)
    mask = torch.rand(n, generator=gen, device=dev) < 0.8
    before = k1.LAUNCHES
    got = k1.eval_trilinear(stack, wi, wo, slot, mask)
    assert k1.LAUNCHES == before + 1
    want = k1.eval_trilinear_plain(stack, wi, wo, slot, mask)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert bool((got[~mask] == 0).all()) and bool((got[:100] == 0).all())


def test_k2_kernel_matches_plain(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    n, n_sl, h, w = 100_000, 5, 32, 64
    weights = torch.rand((n_sl, h, w), generator=gen, device=dev) ** 2 + 1e-4
    cdf = torch.cumsum(weights / weights.sum(-1, keepdim=True), -1)

    def ints(hi):
        return torch.randint(0, hi, (n,), generator=gen, device=dev)

    u = torch.rand(n, generator=gen, device=dev)
    u[:1000] = 0.0
    u[1000:2000] = 1.0 - 1e-7
    args = (ints(n_sl), u, ints(h), ints(h), ints(w), ints(h), ints(w))
    valid = torch.rand(n, generator=gen, device=dev) < 0.9
    before = k2.LAUNCHES
    got = k2.cond_sample_pdf(cdf, *args, valid)
    assert k2.LAUNCHES == before + 1
    want = k2.cond_sample_pdf_plain(cdf, *args, valid)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-7)


def test_wrappers_reject_mixed_devices(dev):
    wi = torch.zeros((8, 3), device=dev)
    with pytest.raises(ValueError):
        k1.eval_trilinear(_table("cpu"), wi, wi)
    cs_cpu = cl.build(geo.Geometry(
        prim_type=np.zeros(1, np.int32), p0=np.zeros((1, 3), np.float32),
        e1=np.eye(3, dtype=np.float32)[:1], e2=np.eye(3, dtype=np.float32)[1:2],
        vn0=np.zeros((1, 3)), vn1=np.zeros((1, 3)), vn2=np.zeros((1, 3)),
        uv0=np.zeros((1, 2)), uv1=np.zeros((1, 2)), uv2=np.zeros((1, 2)),
        mat_id=np.zeros(1), emitter_id=np.zeros(1), shape_id=np.zeros(1)), "cpu")
    for fn in (cl.intersect, cl.occluded):
        with pytest.raises(ValueError):
            fn(cs_cpu, Ray.make(wi, wi))
    cdf = torch.ones((1, 2, 4))
    z = torch.zeros(8, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):
        k2.cond_sample_pdf(cdf, z, z.float(), z, z, z, z, z, z.bool())


def _kernels_launched(fn):
    """fn()'s result and the number of CUDA kernels it launched."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())


def _k2_cells(x, w):
    return torch.clamp((x * w).floor(), max=w - 1)


@pytest.mark.parametrize("index_dtype", [torch.int64, torch.int32])
def test_k2_search_edges(dev, index_dtype):
    """The binary search on the rows Marginal2D.build makes: flat runs
    (weights of exactly 0, so values repeat), u equal to a row value, u =
    0, u above a row's last value below 1; int64 or int32 indices, u a
    strided column and a bool mask. The sampled cell equals the plain
    version's on every lane, the values within K2's tolerance."""
    from mitsuba_customization_tpu_torch.core.distr import Marginal2D

    gen = torch.Generator(device=dev).manual_seed(5)
    n, n_sl, h, w = 200_000, 6, 32, 64
    weights = torch.rand((n_sl, h, w), generator=gen, device=dev) ** 2
    weights[0, :, 5:20] = 0.0
    weights[1] *= torch.rand((h, w), generator=gen, device=dev) < 0.15  # zero-heavy
    weights[2, 3] = 0.0  # a row of weight 1e-20 per cell
    cdf = Marginal2D.build(weights).cdf_cond.contiguous()
    cdf[3, 7] *= 0.999  # a row whose last value is below 1
    assert bool((cdf[..., 1:] >= cdf[..., :-1]).all())
    assert bool((cdf[0, :, 5:20] == cdf[0, :, 4:19]).any())  # flat runs

    def ints(hi):
        return torch.randint(0, hi, (n,), generator=gen, device=dev)

    key, r_own = ints(n_sl), ints(h)
    sample = torch.rand((n, 2), generator=gen, device=dev)
    u = sample[:, 1]
    u[:20_000] = 0.0
    on = slice(20_000, 60_000)  # u exactly on a value of the lane's row
    u[on] = cdf[key[on], r_own[on], ints(w)[on]]
    key[60_000:70_000], r_own[60_000:70_000] = 3, 7
    u[60_000:70_000] = 0.9995  # above the last value 0.999 * ~1
    key[70_000:80_000] = torch.randint(0, 3, (10_000,), generator=gen, device=dev)
    args = [key, u, r_own, ints(h), ints(w), ints(h), ints(w)]
    args = [a if a.dtype != torch.int64 else a.to(index_dtype) for a in args]
    valid = torch.rand(n, generator=gen, device=dev) < 0.9
    assert u.stride(0) == 2 and valid.dtype == torch.bool
    before = k2.LAUNCHES
    got, kernels = _kernels_launched(lambda: k2.cond_sample_pdf(cdf, *args, valid))
    assert k2.LAUNCHES == before + 1
    if index_dtype == torch.int64:
        assert kernels == 1  # the caller's tensors are read in place
    want = k2.cond_sample_pdf_plain(cdf, *args, valid)
    assert torch.equal(_k2_cells(got[0], w), _k2_cells(want[0], w))
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-7)
    last = valid[60_000:70_000]
    assert bool((_k2_cells(got[0][60_000:70_000], w)[last] == w - 1).all())
    assert bool((got[1][60_000:70_000][last] == 0).all())  # no mass above the last
    assert bool((got[0][~valid] == 0).all())


def _rgb_table(dev, shape, phase=1.0):
    """Like _table, with the channels apart and a phi_d term whose bins
    n_pd - 1 and 0 differ, so a wrong wrap neighbour shows."""
    n_th, n_td, n_pd, _ = shape
    th = ((torch.arange(n_th, device=dev) + 0.5) / n_th) ** 2 * (torch.pi / 2)
    td = (torch.arange(n_td, device=dev) + 0.5) / n_td * (torch.pi / 2)
    pd = (torch.arange(n_pd, device=dev) + 0.5) / n_pd * torch.pi
    rgb = torch.tensor([1.0, 0.7, 0.4], device=dev)
    return ((0.3 + 0.1 * torch.cos(3 * th)[:, None, None, None]
             * torch.cos(2 * td)[None, :, None, None]
             + 0.1 * torch.sin(th)[:, None, None, None] ** 2
             * torch.sin(td)[None, :, None, None]
             * torch.cos(2 * pd + phase)[None, None, :, None]) * rgb).contiguous()


def _k1_check(table, wi, wo, slot=None, mask=None):
    """The kernel against the plain version."""
    got = k1.eval_trilinear(table, wi, wo, slot, mask)
    want = k1.eval_trilinear_plain(table, wi, wo, slot, mask)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    return got


@pytest.mark.parametrize("shape", [(90, 90, 180, 3), (6, 5, 4, 3), (5, 3, 3, 3)])
def test_k1_phi_d_wrap(dev, shape):
    """Lanes in the last phi_d bin (k0 = n_pd - 1, also reached from
    u_pd < 0), whose second bin is bin 0, at MERL size and on small
    tables where a quarter or a third of all lanes wrap; on the
    (5, 3, 3, 3) table, whose float count is odd, the last bin starts at
    an even offset and is read by scalars."""
    from mitsuba_customization_tpu_torch.core.rusinkiewicz import dirs_to_half_diff_fast

    gen = torch.Generator(device=dev).manual_seed(6)
    n = 200_000
    wi, wo = _unit(gen, n, dev), _unit(gen, n, dev)
    table = _rgb_table(dev, shape)
    u_pd = k1.grid_coords(*shape[:3], *dirs_to_half_diff_fast(wi, wo))[2]
    wraps = torch.floor(u_pd) % shape[2] == shape[2] - 1
    assert int(wraps.sum()) > n // (2 * shape[2])
    _k1_check(table, wi, wo)
    _k1_check(table, wi[wraps], wo[wraps])


def test_k1_slot_clamping_and_masks(dev):
    gen = torch.Generator(device=dev).manual_seed(7)
    n = 100_000
    wi, wo = _unit(gen, n, dev), _unit(gen, n, dev)
    stack = torch.stack([_rgb_table(dev, (16, 16, 32, 3), phase) for phase in (0.0, 1.0, 2.0)])
    slot = torch.randint(-3, 6, (n,), generator=gen, device=dev)  # 3 materials
    mask = torch.rand(n, generator=gen, device=dev) < 0.7
    got = _k1_check(stack, wi, wo, slot, mask)
    assert bool((got[~mask] == 0).all()) and bool((got[mask] > 0).all())
    clamped = _k1_check(stack, wi, wo, slot.clamp(0, 2), mask)
    assert torch.equal(got, clamped)


def test_k1_table_view_at_an_odd_float(dev):
    """A material of a stack whose tables hold an odd number of floats
    starts 4 bytes past an 8-byte boundary; the wrapper evaluates such a
    view (through an aligned copy) as the plain version does."""
    gen = torch.Generator(device=dev).manual_seed(10)
    n = 100_000
    stack = torch.stack([_rgb_table(dev, (5, 3, 3, 3), p) for p in (0.0, 1.0, 2.0)])
    view = stack[1]
    assert view.data_ptr() % 8 == 4 and view.is_contiguous()
    wi, wo = _unit(gen, n, dev), _unit(gen, n, dev)
    mask = torch.rand(n, generator=gen, device=dev) < 0.8
    got = _k1_check(view, wi, wo, mask=mask)
    assert torch.equal(got, k1.eval_trilinear(view.clone(), wi, wo, mask=mask))


def test_k1_stack_past_l2(dev):
    """Ten MERL-size materials: 175 MB of table, past the 50 MB L2."""
    gen = torch.Generator(device=dev).manual_seed(8)
    n = 1 << 20
    stack = torch.stack([_rgb_table(dev, (90, 90, 180, 3), 0.3 * m) * (1 + 0.1 * m)
                         for m in range(10)])
    assert stack.numel() * 4 > 50e6 * 3
    wi, wo = _unit(gen, n, dev), _unit(gen, n, dev)
    slot = torch.randint(0, 10, (n,), generator=gen, device=dev)
    _k1_check(stack, wi, wo, slot, torch.rand(n, generator=gen, device=dev) < 0.8)


def test_k1_halves_equal_the_joined_call(dev):
    """[wi ; wi] x [wo ; wo_b] through two pointers equals one call on the
    joined lanes, bit for bit, and is one launch."""
    gen = torch.Generator(device=dev).manual_seed(9)
    n = 100_003
    wi, wo, wo_b = (_unit(gen, n, dev) for _ in range(3))
    stack = torch.stack([_rgb_table(dev, (16, 16, 32, 3), p) for p in (0.0, 1.0)])
    slot = torch.randint(0, 2, (n,), generator=gen, device=dev)
    mask, mask_b = (torch.rand(n, generator=gen, device=dev) < 0.8 for _ in range(2))
    for lanes in ((wi, wo, slot, mask, wo_b, mask_b), (wi, wo, None, None, wo_b, mask_b),
                  (wi, wo, slot, None, wo_b, None)):
        before = k1.LAUNCHES
        got, kernels = _kernels_launched(lambda: k1.eval_trilinear(stack, *lanes))
        assert k1.LAUNCHES == before + 1 and kernels == 1 and got.shape == (2 * n, 3)
        joined = k1.concat_halves(*lanes)
        assert torch.equal(got, k1.eval_trilinear(stack, *joined))
        torch.testing.assert_close(got, k1.eval_trilinear_plain(stack, *joined),
                                   rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# K1's backward (csrc/merl_eval_bwd.cu), held as chip_smoke.check_k1_bwd
# holds it: to K1 by the linearity identity (within chip_smoke's
# K1_BWD_ID_RTOL) and to its plain version in norm (K1_BWD_L2_RTOL); see
# there for why. Where phi_d is undefined (theta_d = 0; h rounding onto the
# normal), the kernel and the plain version pick different phi_d bins for
# the same lane, so there the gradient is compared summed over the phi_d
# axis, where the lane's weights add up to its theta weights alike; a
# channel whose value the two then clamp at 0 differently (the bins they
# picked differ in sign) is left out of that comparison. Two
# kernel gradients on the same lanes differ only by atomic order: two
# orders of n float32 terms differ by ~sqrt(n) 2^-24 times the sum of their
# magnitudes (n 2^-24 at worst), more than any tolerance relative to the
# result where signed terms cancel, so each bin is held within rtol 1e-4
# of the other plus 1e-5 times the sum of its terms' magnitudes (the plain
# version on |g|).
# ---------------------------------------------------------------------------

K1_BWD_RTOL, K1_BWD_ATOL = 1e-4, 1e-5


def _assert_grad_close(got, want, absum):
    bad = (got - want).abs() > K1_BWD_RTOL * want.abs() + K1_BWD_ATOL * absum
    assert not bool(bad.any()), (
        f"{int(bad.sum())} of {bad.numel()} bins; max abs err "
        f"{float((got - want).abs().max()):.3e}, max |grad| {float(want.abs().max()):.3e}")


def _k1_bwd_check(table, g, *lanes, over_phi_d=False, value=None):
    """The kernel against K1 (the linearity identity) and against the plain
    version on the joined lanes (in norm; summed over the phi_d axis if
    over_phi_d), both handed K1's output `value` (or None); returns the
    kernel's gradient."""
    import chip_smoke as cs

    before = k1.LAUNCHES_BWD
    got = k1.eval_trilinear_bwd(table, g, *lanes, value=value)
    assert k1.LAUNCHES_BWD == before + 1 and got.shape == table.shape
    joined = k1.concat_halves(*lanes)
    want = k1.eval_trilinear_bwd_plain(table, g, *joined, value=value)
    assert bool((want != 0).any())
    if over_phi_d:
        alike = ((k1.eval_trilinear(table, *lanes) > 0)
                 == (k1.eval_trilinear_plain(table, *joined) > 0))
        g_alike = torch.where(alike, g, 0.0)
        l2 = cs.rel_l2(k1.eval_trilinear_bwd(table, g_alike, *lanes).sum(-2),
                       k1.eval_trilinear_bwd_plain(table, g_alike, *joined).sum(-2))
    else:
        l2 = cs.rel_l2(got, want)
    id_err = cs.k1_bwd_identity_err(table, g, *lanes, value=value)
    print(f"K1-bwd {tuple(table.shape)}: identity error {id_err:.3e}, relative L2 "
          f"error against plain {l2:.3e}{' over phi_d' if over_phi_d else ''}")
    assert id_err <= cs.K1_BWD_ID_RTOL and l2 <= cs.K1_BWD_L2_RTOL, (id_err, l2)
    return got


def _cotangent(gen, n, dev):
    return torch.randn((n, 3), generator=gen, device=dev)


@pytest.mark.parametrize("shape", [(90, 90, 180, 3), (6, 5, 4, 3), (5, 3, 3, 3)])
def test_k1_bwd_phi_d_wrap(dev, shape):
    """Lanes whose second phi_d bin is bin 0 scatter there (as in
    test_k1_phi_d_wrap; the (5, 3, 3, 3) table reads its last bin by
    scalars)."""
    from mitsuba_customization_tpu_torch.core.rusinkiewicz import dirs_to_half_diff_fast

    gen = torch.Generator(device=dev).manual_seed(20)
    n = 200_000
    wi, wo = _unit(gen, n, dev), _unit(gen, n, dev)
    table = _rgb_table(dev, shape)
    u_pd = k1.grid_coords(*shape[:3], *dirs_to_half_diff_fast(wi, wo))[2]
    wraps = torch.floor(u_pd) % shape[2] == shape[2] - 1
    _k1_bwd_check(table, _cotangent(gen, n, dev), wi, wo)
    got = _k1_bwd_check(table, _cotangent(gen, int(wraps.sum()), dev), wi[wraps], wo[wraps])
    assert bool((got[:, :, 0] != 0).any()) and bool((got[:, :, -1] != 0).any())


def test_k1_bwd_border_cells(dev):
    """theta_h at 0 and near pi/2, theta_d near 0 and pi/2: the clamped
    cells at both ends of both theta axes, on a table with negative
    entries (the clamp at 0 stops a channel's gradient)."""
    gen = torch.Generator(device=dev).manual_seed(21)
    n = 100_000
    wi = _unit(gen, n, dev)
    wo = wi.clone()                                       # theta_d = 0
    q = n // 4
    wo[q:2 * q] = wi[q:2 * q] * torch.tensor([-1.0, -1.0, 1.0], device=dev)  # theta_h = 0
    wi[2 * q:3 * q, 2] = 1e-3                             # grazing: theta_h, theta_d large
    wo[2 * q:3 * q] = wi[2 * q:3 * q] * torch.tensor([-1.0, 1.0, 1.0], device=dev)
    wi, wo = (v / v.norm(dim=-1, keepdim=True) for v in (wi, wo))
    table = _rgb_table(dev, (16, 16, 32, 3)) - 0.3
    got = _k1_bwd_check(table, _cotangent(gen, n, dev), wi, wo, over_phi_d=True)
    assert bool((got[0] != 0).any()) and bool((got[:, 0] != 0).any())


def test_k1_bwd_slot_clamping(dev):
    """Slots out of range scatter into the first or last material, as K1
    reads them."""
    gen = torch.Generator(device=dev).manual_seed(22)
    n = 100_000
    wi, wo = _unit(gen, n, dev), _unit(gen, n, dev)
    stack = torch.stack([_rgb_table(dev, (16, 16, 32, 3), p) for p in (0.0, 1.0, 2.0)])
    slot = torch.randint(-3, 6, (n,), generator=gen, device=dev)
    mask = torch.rand(n, generator=gen, device=dev) < 0.7
    g = _cotangent(gen, n, dev)
    got = _k1_bwd_check(stack, g, wi, wo, slot, mask)
    clamped = _k1_bwd_check(stack, g, wi, wo, slot.clamp(0, 2), mask)
    absum = k1.eval_trilinear_bwd_plain(stack, g.abs(), wi, wo, slot, mask)
    _assert_grad_close(got, clamped, absum)


def test_k1_bwd_stack_past_l2(dev):
    """Ten MERL-size materials (175 MB of table and of gradient), both
    halves."""
    gen = torch.Generator(device=dev).manual_seed(23)
    n = 1 << 20
    stack = torch.stack([_rgb_table(dev, (90, 90, 180, 3), 0.3 * m) * (1 + 0.1 * m)
                         for m in range(10)])
    wi, wo, wo_b = (_unit(gen, n, dev) for _ in range(3))
    slot = torch.randint(0, 10, (n,), generator=gen, device=dev)
    mask, mask_b = (torch.rand(n, generator=gen, device=dev) < 0.8 for _ in range(2))
    _k1_bwd_check(stack, _cotangent(gen, 2 * n, dev), wi, wo, slot, mask, wo_b, mask_b)


def test_k1_bwd_one_half_fully_masked(dev):
    """Both halves in one launch, one of them masked on every lane: it
    adds nothing, whatever its cotangent."""
    gen = torch.Generator(device=dev).manual_seed(24)
    n = 100_003
    wi, wo, wo_b = (_unit(gen, n, dev) for _ in range(3))
    stack = torch.stack([_rgb_table(dev, (16, 16, 32, 3), p) for p in (0.0, 1.0)])
    slot = torch.randint(0, 2, (n,), generator=gen, device=dev)
    mask = torch.rand(n, generator=gen, device=dev) < 0.8
    none = torch.zeros(n, dtype=torch.bool, device=dev)
    g = _cotangent(gen, 2 * n, dev)
    for lanes in ((wi, wo, slot, mask, wo_b, none), (wi, wo, slot, none, wo_b, mask)):
        got = _k1_bwd_check(stack, g, *lanes)
        live = lanes[3] if lanes[5] is none else lanes[5]
        half = (g[:n], wo) if lanes[5] is none else (g[n:], wo_b)
        alone = k1.eval_trilinear_bwd(stack, half[0], wi, half[1], slot, live)
        absum = k1.eval_trilinear_bwd_plain(stack, half[0].abs(), wi, half[1], slot, live)
        _assert_grad_close(got, alone, absum)


def test_k1_bwd_table_view_at_an_odd_float(dev):
    """A material of a stack of odd float count starts 4 bytes past an
    8-byte boundary: its gradient comes out in the view's shape."""
    gen = torch.Generator(device=dev).manual_seed(25)
    n = 100_000
    stack = torch.stack([_rgb_table(dev, (5, 3, 3, 3), p) for p in (0.0, 1.0, 2.0)])
    view = stack[1]
    assert view.data_ptr() % 8 == 4
    wi, wo = _unit(gen, n, dev), _unit(gen, n, dev)
    mask = torch.rand(n, generator=gen, device=dev) < 0.8
    _k1_bwd_check(view, _cotangent(gen, n, dev), wi, wo, None, mask)


def test_k1_bwd_hot_cell(dev):
    """Every lane in one cell (wi = wo: theta_d = 0 at one theta_h), so
    every lane's atomics land on the same 24 floats; the cotangents are
    positive, so the sums hold no cancellation."""
    gen = torch.Generator(device=dev).manual_seed(26)
    n = 1 << 18
    w = torch.tensor([0.3, 0.2, 0.9], device=dev)
    wi = (w / w.norm()).expand(n, 3).contiguous()
    g = torch.rand((n, 3), generator=gen, device=dev) + 0.5
    table = _rgb_table(dev, (16, 16, 32, 3))
    got = _k1_bwd_check(table, g, wi, wi.clone(), over_phi_d=True)
    assert int((got != 0).any(-1).sum()) <= 8


@pytest.mark.parametrize("n_pd", [8, 7, 6, 5])
def test_k1_bwd_vector_atomics_at_every_alignment(dev, n_pd):
    """A (theta_h, theta_d) corner's 6 floats (phi_d bins k0, k0 + 1) go
    by float4 / float2 / scalar atomics by their address: tables whose
    cell rows (3 n_pd floats) start at every float phase mod 4, every k0
    (so every bin phase), the phi_d wrap (k1 = 0: two 3-float runs), and
    gradient buffers at float offsets 0-3 of a larger tensor (the
    accumulating form), each against the standalone kernel and the plain
    version."""
    gen = torch.Generator(device=dev).manual_seed(40)
    n = 200_000
    wi, wo = _unit(gen, n, dev), _unit(gen, n, dev)
    stack = torch.stack([_rgb_table(dev, (6, 5, n_pd, 3), p) for p in (0.0, 1.0, 2.0)])
    slot = torch.randint(0, 3, (n,), generator=gen, device=dev)
    mask = torch.rand(n, generator=gen, device=dev) < 0.9
    g = _cotangent(gen, n, dev)
    lanes = (wi, wo, slot, mask)
    absum = k1.eval_trilinear_bwd_plain(stack, g.abs(), *lanes)
    alone = _k1_bwd_check(stack, g, *lanes)
    for offset in range(4):
        big = torch.zeros(stack.numel() + 4, device=dev)
        out = big[offset:offset + stack.numel()].view(stack.shape)
        got = k1.eval_trilinear_bwd(stack, g, *lanes, out=out)
        assert got is out
        _assert_grad_close(got, alone, absum)
        assert not bool(big[:offset].any()) and not bool(
            big[offset + stack.numel():].any())


def test_k1_bwd_warp_mixing_shared_and_distinct_cells(dev):
    """Warps that mix groups of lanes in one cell (identical directions
    and slot, 2 to 8 a group, spread over the warp), lanes with the same
    directions in another slot (another cell key), lanes of their own and
    masked lanes: against K1 and the plain version."""
    gen = torch.Generator(device=dev).manual_seed(41)
    n = 1 << 16
    base_wi, base_wo = _unit(gen, n, dev), _unit(gen, n, dev)
    lane = torch.arange(n, device=dev)
    # lane l copies the directions of lane (l // 32) * 32 + (l % 32) % k,
    # k = 4 + (l // 32) % 5: groups of lanes l, l + k, ... in each warp
    k = 4 + (lane // 32) % 5
    src = (lane // 32) * 32 + (lane % 32) % k
    own = lane % 7 == 3  # lanes of their own
    src = torch.where(own, lane, src)
    wi, wo = base_wi[src], base_wo[src]
    slot = torch.where(lane % 11 == 5, 1, 0)  # same directions, another cell
    mask = lane % 13 != 6
    stack = torch.stack([_rgb_table(dev, (16, 16, 32, 3), p) for p in (0.0, 1.0)])
    g = torch.rand((n, 3), generator=gen, device=dev) - 0.3
    _k1_bwd_check(stack, g, wi, wo, slot, mask)


def test_k1_bwd_saved_output_clamp(dev):
    """Handed K1's output (as _EvalTrilinear hands it), the kernel reads
    the bins only on lanes with a channel at 0; on a table with negative
    entries (many outputs at 0) it gives the standalone form's gradient,
    and the plain version's in norm and by the identity."""
    gen = torch.Generator(device=dev).manual_seed(42)
    n = 200_000
    wi, wo, wo_b = (_unit(gen, n, dev) for _ in range(3))
    stack = torch.stack([_rgb_table(dev, (16, 16, 32, 3), p) - 0.3 for p in (0.0, 1.0)])
    slot = torch.randint(0, 2, (n,), generator=gen, device=dev)
    mask, mask_b = (torch.rand(n, generator=gen, device=dev) < 0.8 for _ in range(2))
    lanes = (wi, wo, slot, mask, wo_b, mask_b)
    g = _cotangent(gen, 2 * n, dev)
    value = k1.eval_trilinear(stack, *lanes)
    assert bool((value == 0).any()) and bool((value > 0).any())
    absum = k1.eval_trilinear_bwd_plain(stack, g.abs(), *k1.concat_halves(*lanes))
    got = _k1_bwd_check(stack, g, *lanes, value=value)
    _assert_grad_close(got, k1.eval_trilinear_bwd(stack, g, *lanes), absum)


def test_k1_bwd_accumulates_into_out(dev):
    """Two calls into one `out` (the backward pass's buffer) equal the sum
    of the two standalone gradients, each bin within the atomics' order
    noise; no buffer is allocated."""
    gen = torch.Generator(device=dev).manual_seed(43)
    n = 200_000
    wi, wo, wo_b = (_unit(gen, n, dev) for _ in range(3))
    stack = torch.stack([_rgb_table(dev, (90, 90, 180, 3), 0.3 * m) for m in range(3)])
    slot = torch.randint(0, 3, (n,), generator=gen, device=dev)
    mask, mask_b = (torch.rand(n, generator=gen, device=dev) < 0.8 for _ in range(2))
    lanes = (wi, wo, slot, mask, wo_b, mask_b)
    g1, g2 = _cotangent(gen, 2 * n, dev), _cotangent(gen, 2 * n, dev)
    value = k1.eval_trilinear(stack, *lanes)
    out = torch.zeros_like(stack)
    before = k1.GRAD_BUFFERS
    for g in (g1, g2):
        assert k1.eval_trilinear_bwd(stack, g, *lanes, value=value, out=out) is out
    assert k1.GRAD_BUFFERS == before
    want = k1.eval_trilinear_bwd(stack, g1, *lanes) + k1.eval_trilinear_bwd(stack, g2, *lanes)
    joined = k1.concat_halves(*lanes)
    absum = (k1.eval_trilinear_bwd_plain(stack, g1.abs(), *joined)
             + k1.eval_trilinear_bwd_plain(stack, g2.abs(), *joined))
    _assert_grad_close(out, want, absum)


def test_grad_render_launches_k1_bwd(dev):
    """grad_render's eager step (ad._eager_loss_and_grad, whose kernel calls
    the wrappers count: a captured step's replay calls none) on the card
    goes through K1's backward kernel into one table-gradient buffer, and
    its gradients are finite and nonzero."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render import ad
    from mitsuba_customization_tpu_torch.render.params import traverse
    from mitsuba_customization_tpu_torch.scenes import flagship_dict

    scene = mt.load_dict(flagship_dict(32, 4, 3), dev)
    full = traverse(scene)
    keys = ("bsdf.tabulated.table", "bsdf.roughconductor.alpha_u")
    before = k1.LAUNCHES_BWD, k1.GRAD_BUFFERS
    loss, grads = ad._eager_loss_and_grad(scene, {k: full[k] for k in keys},
                                          torch.zeros((32, 32, 3), device=dev), 4, 0)
    assert k1.LAUNCHES_BWD > before[0] and bool(torch.isfinite(loss))
    assert k1.GRAD_BUFFERS == before[1] + 1  # one table-gradient buffer
    for k in keys:
        assert bool(torch.isfinite(grads[k]).all()) and bool((grads[k] != 0).any())


def test_frame_gpu_matches_cpu(dev):
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.scenes import flagship_dict

    d = flagship_dict(32, 4, 3)
    gpu = mt.render(mt.load_dict(d, dev), spp=4, seed=0).cpu()
    cpu = mt.render(mt.load_dict(d, "cpu"), spp=4, seed=0)
    torch.testing.assert_close(gpu.mean((0, 1)), cpu.mean((0, 1)), rtol=0.01, atol=0)


def _cluster_scene(dev):
    """The n_sub = 3 blob (1,280 triangles, 4 superclusters) plus a sphere
    and a cylinder, and 65,536 rays, half aimed at the blob."""
    v, f = icosphere_blob(n_sub=3)
    vn = vertex_normals(v, f)
    rng = np.random.default_rng(3)
    p = len(f)
    z3 = np.zeros((2, 3), np.float32)
    g = geo.Geometry(
        prim_type=np.r_[np.zeros(p), geo.SPHERE, geo.CYLINDER].astype(np.int32),
        p0=np.r_[v[f[:, 0]], [[2.0, 0.3, 0.1], [-2.0, -1.0, 0.0]]].astype(np.float32),
        e1=np.r_[v[f[:, 1]] - v[f[:, 0]], [[0.7, 0, 0], [0, 2.0, 0]]].astype(np.float32),
        e2=np.r_[v[f[:, 2]] - v[f[:, 0]], [[0, 0, 0], [0.5, 0, 0]]].astype(np.float32),
        vn0=np.r_[vn[f[:, 0]], z3], vn1=np.r_[vn[f[:, 1]], z3], vn2=np.r_[vn[f[:, 2]], z3],
        uv0=rng.random((p + 2, 2), dtype=np.float32),
        uv1=rng.random((p + 2, 2), dtype=np.float32),
        uv2=rng.random((p + 2, 2), dtype=np.float32),
        mat_id=(np.arange(p + 2) % 5).astype(np.int32),
        emitter_id=np.where(np.arange(p + 2) % 17 == 0, 1, -1).astype(np.int32),
        shape_id=(np.arange(p + 2) % 3).astype(np.int32),
    )
    cs = cl.build(g, dev)
    n = 1 << 16
    o = np.array([0, 0, -4.0], np.float32) + rng.normal(size=(n, 3)).astype(np.float32) * 0.4
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[: n // 2] = -o[: n // 2] + rng.normal(size=(n // 2, 3)) * 0.5
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return cs, torch.tensor(o, device=dev), torch.tensor(d, device=dev)


def test_k3_kernel_matches_plain(dev):
    """Hit/miss equal, t within rtol 1e-6 (both sides round every product
    and sum on its own), the prim equal on >= 99.9 % of hits (ties on
    shared edges), the winner rows equal where the prims agree."""
    cs, o, d = _cluster_scene(dev)
    maxt = torch.full((o.shape[0],), float("inf"), device=dev)
    maxt[1::7] = 0.0
    maxt[2::7] = 3.5
    ray = Ray(o, d, maxt)
    before = cl.LAUNCHES["closest"]
    t, prim, u, v, g = cl.intersect(cs, ray)
    torch.cuda.synchronize()
    assert cl.LAUNCHES["closest"] == before + 1
    t_p, u_p, v_p, fld_p = cl.intersect_plain(cs, ray)
    prim_p = fld_p[:, cl.F_PRIM].long()
    assert torch.equal(prim >= 0, prim_p >= 0)
    hit = prim >= 0
    assert 0.3 < hit.float().mean() < 0.9 and not hit[1::7].any()
    torch.testing.assert_close(t[hit], t_p[hit], rtol=1e-6, atol=0)
    assert torch.isinf(t[~hit]).all()
    same = hit & (prim == prim_p)
    assert same.sum() >= 0.999 * hit.sum()
    torch.testing.assert_close(u[same], u_p[same], rtol=0, atol=0)
    torch.testing.assert_close(v[same], v_p[same], rtol=0, atol=0)
    _, prim2, _, _, g_p = cl._unpack(t_p, u_p, v_p, fld_p)
    for a, b in zip(g, g_p):
        assert torch.equal(a[same | ~hit], b[same | ~hit])
    types = set(g.prim_type[hit].unique().tolist())
    assert types == {geo.TRI, geo.SPHERE, geo.CYLINDER}


def test_k4_kernel_matches_plain(dev):
    cs, o, d = _cluster_scene(dev)
    t_hit = cl.intersect_plain(cs, Ray.make(o, d))[0]
    n = o.shape[0]
    lane = torch.arange(n, device=dev)
    maxt = torch.where(torch.isfinite(t_hit) & (lane % 2 == 0), t_hit * 0.5, 1e30)
    maxt = torch.where(lane % 4 == 1, 0.0, maxt)
    ray = Ray(o, d, maxt)
    before = cl.LAUNCHES["shadow"]
    occ = cl.occluded(cs, ray)
    torch.cuda.synchronize()
    assert cl.LAUNCHES["shadow"] == before + 1
    assert torch.equal(occ, cl.occluded_plain(cs, ray))
    assert occ.any() and not occ[lane % 4 == 1].any()


def test_k3_k4_past_8192_clusters(dev):
    """A 300,000-triangle soup (9,375 clusters): the TPU kernels keep their
    box tables in SMEM only up to 8,192 clusters; K3 and K4 read boxes the
    same way at any size."""
    rng = np.random.default_rng(7)
    p = 300_000
    c = rng.uniform(-4.0, 4.0, (p, 3)).astype(np.float32)
    e1 = rng.normal(scale=0.05, size=(p, 3)).astype(np.float32)
    e2 = rng.normal(scale=0.05, size=(p, 3)).astype(np.float32)
    z3, z2, zi = np.zeros((p, 3), np.float32), np.zeros((p, 2), np.float32), np.zeros(p, np.int32)
    g = geo.Geometry(prim_type=zi, p0=c, e1=e1, e2=e2, vn0=z3, vn1=z3, vn2=z3,
                     uv0=z2, uv1=z2, uv2=z2, mat_id=zi, emitter_id=zi - 1,
                     shape_id=zi)
    cs = cl.build(g, dev)
    assert cs.cl_box.shape[0] > 8192
    n = 1 << 15
    o = torch.tensor(rng.uniform(-6.0, 6.0, (n, 3)), dtype=torch.float32, device=dev)
    d = torch.nn.functional.normalize(torch.randn((n, 3), device=dev), dim=-1)
    ray = Ray.make(o, d)
    t, prim, _, _, _ = cl.intersect(cs, ray)
    t_p, _, _, fld_p = cl.intersect_plain(cs, ray)
    prim_p = fld_p[:, cl.F_PRIM].long()
    assert torch.equal(prim >= 0, prim_p >= 0) and (prim >= 0).float().mean() > 0.2
    hit = prim >= 0
    torch.testing.assert_close(t[hit], t_p[hit], rtol=1e-6, atol=0)
    assert (prim == prim_p)[hit].float().mean() >= 0.999
    capped = Ray(o, d, torch.where(hit, t * 0.5, 1e30))
    assert torch.equal(cl.occluded(cs, capped), cl.occluded_plain(cs, capped))


def test_matpreview_frame_gpu_matches_cpu(dev):
    """The small matpreview frame (clusters, area light, compaction) on the
    card and on the CPU: per-channel means within 1 %."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.scenes import matpreview_dict

    d = matpreview_dict(32, 4, 4, n_sub=3, n_materials=3, compact=(1.0, 0.8, 0.5))
    gpu = mt.render(mt.load_dict(d, dev), spp=4, seed=0).cpu()
    cpu = mt.render(mt.load_dict(d, "cpu"), spp=4, seed=0)
    assert torch.isfinite(gpu).all()
    torch.testing.assert_close(gpu.mean((0, 1)), cpu.mean((0, 1)), rtol=0.01, atol=0)


# ---------------------------------------------------------------------------
# The nearest-entry-first walk of K3 and K4: ties, empty near boxes, more
# passing superclusters than a lane's list holds, maxt around the hit, and
# more superclusters than 48 KB of shared memory holds. Each case runs on
# its own rays (a small launch: a group of lanes per ray) and on enough
# copies of them for one lane per ray.
# ---------------------------------------------------------------------------

# csrc/cluster_common.cuh: lanes_per_ray(n) is 1 once 2 n exceeds
# FILL_WAVES times 2,048 threads a SM
FILL_WAVES = 4


@pytest.fixture(params=["group_of_lanes", "one_lane"])
def copies(request, dev):
    """How many copies of n rays a launch runs on: 1, or enough that the
    launch gives each ray one lane."""
    if request.param == "group_of_lanes":
        return lambda n: 1
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return lambda n: FILL_WAVES * sms * 2048 // (2 * n) + 1


def _copied(ray, k):
    o, d, maxt = cl._rays(ray)
    return Ray(o.repeat(k, 1), d.repeat(k, 1), maxt.repeat(k))


def _rep(x, k):
    return x.repeat((k,) + (1,) * (x.dim() - 1))


def _tri_geometry(p0, p1, p2):
    """A triangle soup as a numpy Geometry (material, shape and uv fields
    from the prim index)."""
    p0, p1, p2 = (np.asarray(a, np.float32) for a in (p0, p1, p2))
    p = p0.shape[0]
    z3 = np.zeros((p, 3), np.float32)
    idx = np.arange(p)
    uv = np.stack([idx % 7, idx % 5], -1).astype(np.float32) / 8.0
    return geo.Geometry(
        prim_type=np.zeros(p, np.int32), p0=p0, e1=p1 - p0, e2=p2 - p0,
        vn0=z3, vn1=z3, vn2=z3, uv0=uv, uv1=uv + 0.125, uv2=uv + 0.25,
        mat_id=(idx % 3).astype(np.int32), emitter_id=np.full(p, -1, np.int32),
        shape_id=(idx % 2).astype(np.int32),
    )


def _bent_grid():
    """A 32 x 16 grid of quads over x in [0, 2], y in [0, 1], on 1/16
    steps: flat (z = 0) for x <= 1 and sloping down to z = -1/2 at x = 2.
    The build's first split is along x, so the flat half holds the lower
    cluster and supercluster indices while the bent half's boxes reach
    toward rays coming from below: those enter the bent half first."""
    nx, ny = 32, 16
    xs = np.arange(nx + 1) / 16.0
    ys = np.arange(ny + 1) / 16.0
    zs = np.where(xs > 1.0, -(xs - 1.0) / 2.0, 0.0)
    v = np.stack(np.broadcast_arrays(xs[:, None], ys[None, :], zs[:, None]), -1)
    a, b = v[:-1, :-1].reshape(-1, 3), v[1:, :-1].reshape(-1, 3)
    c, d = v[1:, 1:].reshape(-1, 3), v[:-1, 1:].reshape(-1, 3)
    return _tri_geometry(np.r_[a, a], np.r_[b, c], np.r_[c, d])


def _grid_rays(dev):
    """Rays to every vertex and edge midpoint of the grid's flat half and
    of the fold (x = 1), from below along dyadic directions: t = 1 is
    exact, and up to six triangles of several clusters tie there. Then
    rays from under the bent half, parallel to it and 1/32 below, that
    cross its boxes without a hit before they hit the flat half."""
    xs = np.arange(0, 33) / 32.0
    ys = np.arange(0, 32) / 32.0  # y = 1 only grazes the boxes' faces
    tx, ty = np.meshgrid(xs, ys, indexing="ij")
    target = np.stack([tx.ravel(), ty.ravel(), np.zeros(tx.size)], -1)
    dirs = np.array([[0, 0, 1], [0.125, 0, 1], [-0.25, 0, 1], [0, -0.125, 1],
                     [0.125, 0.25, 1]], np.float64)
    o = (target[:, None, :] - dirs[None, :, :]).reshape(-1, 3)
    d = np.broadcast_to(dirs, (target.shape[0],) + dirs.shape).reshape(-1, 3)
    y = np.arange(1, 16) / 16.0 + 1.0 / 64.0
    x0 = np.array([1.25, 1.5, 1.75])
    px, py = np.meshgrid(x0, y, indexing="ij")
    po = np.stack([px.ravel(), py.ravel(), -(px.ravel() - 1.0) / 2.0 - 1.0 / 32.0], -1)
    pd = np.broadcast_to(np.array([-1.0, 0.0, 0.5]), po.shape)
    o, d = np.r_[o, po], np.r_[d, pd]
    return (torch.tensor(o, dtype=torch.float32, device=dev),
            torch.tensor(d, dtype=torch.float32, device=dev), po.shape[0])


def _rings(dev):
    """256 rings of 32 triangles around the x axis (one cluster each, 16
    superclusters) and a wall behind them; rays near the axis pass
    through every ring's box without a hit: 17 superclusters pass, more
    than a lane's list holds."""
    k = np.arange(32)
    a0, a1 = 2 * np.pi * k / 32, 2 * np.pi * (k + 0.8) / 32
    ring = []
    for i in range(256):
        x = 4.0 * i
        p0 = np.stack([np.full(32, x), np.cos(a0), np.sin(a0)], -1)
        p1 = np.stack([np.full(32, x), np.cos(a1), np.sin(a1)], -1)
        p2 = np.stack([np.full(32, x + 0.5), 0.8 * np.cos(a0), 0.8 * np.sin(a0)], -1)
        ring.append((p0, p1, p2))
    wall = (np.array([[1030.0, -3, -3], [1030.0, -3, -3]]),
            np.array([[1030.0, 3, -3], [1030.0, 3, 3]]),
            np.array([[1030.0, 3, 3], [1030.0, -3, 3]]))
    p0, p1, p2 = (np.concatenate([r[j] for r in ring] + [wall[j]]) for j in range(3))
    rng = np.random.default_rng(11)
    n = 512
    o = np.c_[np.full(n, -2.0), rng.uniform(-0.4, 0.4, (n, 2))]
    d = np.c_[np.ones(n), rng.uniform(-2e-4, 2e-4, (n, 2))]
    return (cl.build(_tri_geometry(p0, p1, p2), dev),
            torch.tensor(o, dtype=torch.float32, device=dev),
            torch.tensor(d, dtype=torch.float32, device=dev))


def _hedgehog(dev):
    """8,192 large random triangles in [-1, 1]^3 (16 superclusters whose
    boxes all hold the centre) and rays from near the centre: every lane
    starts inside every supercluster, so all enter at 0 and the list
    overflows on equal entries."""
    rng = np.random.default_rng(5)
    p = 8192
    c = rng.uniform(-0.6, 0.6, (p, 3))
    p0, p1, p2 = (c + rng.normal(scale=0.4, size=(p, 3)) for _ in range(3))
    n = 4096
    o = rng.uniform(-0.05, 0.05, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (cl.build(_tri_geometry(p0, p1, p2), dev),
            torch.tensor(o, dtype=torch.float32, device=dev),
            torch.tensor(d, dtype=torch.float32, device=dev))


def _assert_k3_equal(cs, ray, k=1):
    """The kernel's (t, prim, u, v, fields) on k copies of the rays equal
    the plain version's on every lane; returns the plain t and the hit
    mask."""
    t_p, u_p, v_p, fld_p = cl.intersect_plain(cs, ray)
    want = cl._unpack(t_p, u_p, v_p, fld_p)
    got = cl.intersect(cs, _copied(ray, k))
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, _rep(b, k))
    for a, b in zip(got[4], want[4]):
        assert torch.equal(a, _rep(b, k))
    return t_p, want[1] >= 0


def _assert_k4_equal(cs, ray, k=1):
    """K4 on k copies of the rays equals the plain version on every lane;
    returns the plain occlusion."""
    occ_p = cl.occluded_plain(cs, ray)
    assert torch.equal(cl.occluded(cs, _copied(ray, k)), _rep(occ_p, k))
    return occ_p


def test_k3_ties_go_to_the_lowest_code(dev, copies):
    cs = cl.build(_bent_grid(), dev)
    o, d, n_par = _grid_rays(dev)
    t, hit = _assert_k3_equal(cs, Ray.make(o, d), copies(o.shape[0]))
    assert bool(hit.all())
    assert bool((t[:-n_par] == 1.0).all())  # exact: several prims tie


def test_k3_nearest_supercluster_without_a_hit(dev, copies):
    """The parallel rays start inside the bent half's boxes, which they
    enter first (at 0), and hit the flat half behind them."""
    cs = cl.build(_bent_grid(), dev)
    o, d, n_par = _grid_rays(dev)
    o, d = o[-n_par:], d[-n_par:]
    ray = Ray.make(o, d)
    t, hit = _assert_k3_equal(cs, ray, copies(n_par))
    p = o + t[:, None] * d
    assert bool(hit.all()) and bool((p[:, 0] < 1.0).all())
    sc = cs.sc_box
    assert cs.n_super == 2 and float(sc[1, 0]) >= 1.0 and float(sc[0, 3]) <= 1.0
    # every ray starts inside the bent half's box: entered at 0, first
    assert bool(((o >= sc[1, 0:3]) & (o <= sc[1, 3:6])).all())


@pytest.mark.parametrize("scene", ["rings", "hedgehog"])
def test_k3_k4_more_passing_boxes_than_the_list_holds(dev, copies, scene):
    cs, o, d = _rings(dev) if scene == "rings" else _hedgehog(dev)
    inv = cl._inv_dir(d)
    n_pass = cl._box_pass(cs.sc_box, o, inv, torch.full((o.shape[0],), 1e30, device=o.device)).sum(1)
    assert int(n_pass.min()) > 8
    k = copies(o.shape[0])
    t, hit = _assert_k3_equal(cs, Ray.make(o, d), k)
    assert float(hit.float().mean()) > 0.9
    for scale in (0.5, 2.0):
        occ = _assert_k4_equal(cs, Ray(o, d, torch.where(hit, t * scale, 1e30)), k)
        assert torch.equal(occ[hit], torch.full_like(occ[hit], scale > 1.0))


def test_k4_maxt_below_at_and_above_the_hit(dev, copies):
    cs, o, d = _cluster_scene(dev)
    k = copies(o.shape[0])
    t, hit = _assert_k3_equal(cs, Ray.make(o, d), k)
    t_h = t[hit]
    o, d = o[hit], d[hit]
    k = copies(o.shape[0])
    inf = torch.full_like(t_h, float("inf"))
    for maxt, want in ((torch.nextafter(t_h, -inf), False), (t_h, False),
                       (torch.nextafter(t_h, inf), True)):
        occ = _assert_k4_equal(cs, Ray(o, d, maxt), k)
        assert bool((occ == want).all())


def _equal_entry_set(dev):
    """A hand-made ClusterSet (boxes need only hold their prims) whose
    superclusters a ray along +x enters at 6, 6, 2, 3, 4, 5, 5.5, 5.75 and
    1.5, in index order: the list of 8 fills with the two equal entries
    last, then the nearer ninth pushes one of them out. Only supercluster
    0 holds a prim: a square at x = 5.2 (t = 6.2)."""
    entries = [6.0, 6.0, 2.0, 3.0, 4.0, 5.0, 5.5, 5.75, 1.5]
    s = len(entries)
    sc_box = np.zeros((s, 8), np.float32)
    sc_box[:, 0] = np.array(entries) - 1.0
    sc_box[:, 3] = sc_box[:, 0] + 0.5
    sc_box[:, 1:3], sc_box[:, 4:6] = 0.0, 1.0
    cl_box = np.repeat(sc_box, cl.GROUP, axis=0)
    slabs = np.zeros((s * cl.GROUP, cl.L, cl.NFIELDS), np.float32)
    slabs[:, :, cl.F_TYPE] = -1.0
    quad = np.array([[[5.2, 0, 0], [0, 1, 0], [0, 0, 1]],
                     [[5.2, 1, 1], [0, -1, 0], [0, 0, -1]]], np.float32)
    for k, (p0, e1, e2) in enumerate(quad):
        slabs[0, k, cl.F_TYPE] = geo.TRI
        slabs[0, k, cl.F_P0:cl.F_P0 + 3] = p0
        slabs[0, k, cl.F_E1:cl.F_E1 + 3] = e1
        slabs[0, k, cl.F_E2:cl.F_E2 + 3] = e2
        slabs[0, k, cl.F_PRIM] = k
    return cl.cluster_set(sc_box, cl_box, np.zeros(s * cl.GROUP, np.int32), slabs, dev)


def test_k3_k4_equal_entries_survive_a_full_list(dev, copies):
    cs = _equal_entry_set(dev)
    rng = np.random.default_rng(2)
    n = 256
    o = np.c_[np.full(n, -1.0), rng.uniform(0.1, 0.9, (n, 2))]
    o[0, 1:] = 0.5
    d = np.tile(np.array([1.0, 0.0, 0.0]), (n, 1))
    o, d = (torch.tensor(a, dtype=torch.float32, device=dev) for a in (o, d))
    t, hit = _assert_k3_equal(cs, Ray.make(o, d), copies(n))
    assert bool(hit.all()) and bool(torch.allclose(t, torch.full_like(t, 6.2)))
    for maxt, want in ((6.0, False), (7.0, True)):
        occ = _assert_k4_equal(cs, Ray(o, d, torch.full_like(t, maxt)), copies(n))
        assert bool((occ == want).all())


def test_k3_k4_supercluster_boxes_past_48_kb(dev, copies):
    """A 640 x 640 quad heightfield (819,200 triangles, 2,048
    superclusters): the staged supercluster boxes take 64 KB of shared
    memory, which a launch must ask for past 48 KB."""
    m = 640
    xs = np.arange(m + 1) / m
    hx, hy = np.meshgrid(xs, xs, indexing="ij")
    hz = 0.05 * np.sin(9.0 * hx) * np.cos(7.0 * hy) + 0.02 * np.sin(41.0 * hx * hy)
    v = np.stack([hx, hy, hz], -1)
    a, b = v[:-1, :-1].reshape(-1, 3), v[1:, :-1].reshape(-1, 3)
    c, e = v[1:, 1:].reshape(-1, 3), v[:-1, 1:].reshape(-1, 3)
    cs = cl.build(_tri_geometry(np.r_[a, a], np.r_[b, c], np.r_[c, e]), dev)
    assert cs.n_super > 1536 and 4 * (8 + 8 * cs.n_super) > 48 * 1024
    rng = np.random.default_rng(13)
    n = 8192
    o = np.c_[rng.uniform(-0.2, 1.2, (n, 2)), np.full(n, 0.5)]
    d = np.c_[rng.normal(scale=0.6, size=(n, 2)), -np.ones(n)]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = (torch.tensor(x, dtype=torch.float32, device=dev) for x in (o, d))
    t, hit = _assert_k3_equal(cs, Ray.make(o, d), copies(n))
    assert 0.3 < float(hit.float().mean()) < 0.95
    occ = _assert_k4_equal(cs, Ray(o, d, torch.where(hit, t * 2.0, 1e30)), copies(n))
    assert bool(occ[hit].all()) and not bool(occ[~hit].any())


def test_k1_one_half_with_slot_and_mask(dev):
    """K1 as the standalone tabulated eval calls it: one half (no wo_b), a
    slot and a mask (the slot of masked lanes clamped to 0 by the caller,
    and out of range on some live lanes), on a 3-table stack whose phi_d
    terms vanish at the poles: equal to its plain version within 1e-4 /
    1e-5, 0 on masked lanes, one launch."""
    gen = torch.Generator(device=dev).manual_seed(12)
    n = 200_003
    wi, wo = _unit(gen, n, dev), _unit(gen, n, dev)
    wo[:500, 2] *= -1
    shape = (16, 16, 32, 3)
    stack = torch.stack([_rgb_table(dev, shape, 0.0), 0.5 * _rgb_table(dev, shape, 1.0),
                         2.0 * _rgb_table(dev, shape, 2.0)])
    mask = torch.rand(n, generator=gen, device=dev) < 0.7
    slot = torch.where(mask, torch.randint(0, 4, (n,), generator=gen, device=dev), 0)
    before = k1.LAUNCHES
    got = k1.eval_trilinear(stack, wi, wo, slot, mask)
    torch.cuda.synchronize()
    assert k1.LAUNCHES == before + 1 and got.shape == (n, 3)
    want = k1.eval_trilinear_plain(stack, wi, wo, slot, mask)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert not got[~mask].any()


def test_tabulated_standalone_eval_sample_pdf(dev):
    """tabulated.eval / pdf / sample on the card against the CPU (plain
    versions) with the same sampling CDFs: K1 with one half in eval and
    in sample (two launches), eval within 1e-4 / 1e-5 on every lane; pdf
    and sample on >= 99.9 % of the lanes (a half vector on a CDF cell's
    edge may land in the next cell: the card's acos and atan2 differ from
    the CPU's by ulps)."""
    from mitsuba_customization_tpu_torch.core.distr import Marginal2D
    from mitsuba_customization_tpu_torch.models import tabulated as tab

    gen = torch.Generator(device=dev).manual_seed(13)
    n = 65_536
    shape = (16, 16, 32, 3)
    stack = torch.stack([_rgb_table(dev, shape, 0.0), 0.5 * _rgb_table(dev, shape, 1.0)])
    params = tab.TabulatedBRDF.build_stack(stack)
    cpu = tab.TabulatedBRDF(stack.cpu(), Marginal2D(*(f.cpu() for f in params.sampling)))
    wi, wo = _unit(gen, n, dev), _unit(gen, n, dev)
    u2 = torch.rand((n, 2), generator=gen, device=dev)
    slot = torch.randint(0, 2, (n,), generator=gen, device=dev)
    mask = torch.rand(n, generator=gen, device=dev) < 0.8
    before = k1.LAUNCHES
    got = [tab.eval(params, wi, wo, slot, mask), tab.pdf(params, wi, wo, slot, mask),
           *tab.sample(params, wi, u2, None, slot, mask)]
    torch.cuda.synchronize()
    assert k1.LAUNCHES == before + 2
    lanes = [x.cpu() for x in (wi, wo, slot, mask)]
    want = [tab.eval(cpu, *lanes), tab.pdf(cpu, *lanes),
            *tab.sample(cpu, lanes[0], u2.cpu(), None, *lanes[2:])]
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-4, atol=1e-5)
    assert torch.equal(got[-1].cpu(), want[-1])
    off = torch.zeros(n, dtype=torch.bool)
    for g, w in zip(got[1:-1], want[1:-1]):
        bad = ~torch.isclose(g.cpu(), w, rtol=1e-4, atol=1e-5)
        off |= bad.reshape(n, -1).any(-1)
    assert int(off.sum()) <= n // 1000, int(off.sum())


def test_k4_on_a_shadow_cluster_set_with_null_prims(dev):
    """K4 on the shadow cluster set of a scene with a null band (its prims
    degenerate) against its plain version on every lane; the rays that
    hit only null prims pass there, and are occluded on the full set."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.scenes import matpreview_dict

    d = matpreview_dict(16, 1, 2, n_sub=3, n_materials=4)
    d["blob_1"]["bsdf"] = {"type": "null"}
    scene = mt.load_dict(d, dev)
    assert scene.shadow_clusters is not None
    gen = torch.Generator(device=dev).manual_seed(14)
    n = 1 << 16
    o = torch.tensor([0.0, 0.3, -4.0], device=dev) + 0.3 * torch.randn(
        (n, 3), generator=gen, device=dev)
    d_ = -o + 0.6 * torch.randn((n, 3), generator=gen, device=dev)
    d_ = d_ / d_.norm(dim=-1, keepdim=True)
    ray = Ray(o, d_, torch.full((n,), 8.0, device=dev))
    before = cl.LAUNCHES["shadow"]
    occ = scene.ray_test(ray)
    torch.cuda.synchronize()
    assert cl.LAUNCHES["shadow"] == before + 1
    assert torch.equal(occ, cl.occluded_plain(scene.shadow_clusters, ray))
    full = cl.occluded(scene.clusters, ray)
    assert bool((full & ~occ).any()) and not bool((occ & ~full).any())


def test_blended_ad_step_has_one_gradient_buffer(dev):
    """grad_render's eager step (ad._eager_loss_and_grad) of a matpreview
    scene with null, mask and blendbsdf bands over MERL tables: K1 runs
    with one half (the blend fallback), K1's
    backward adds every call into one table-gradient buffer; finite,
    nonzero gradients."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render import ad
    from mitsuba_customization_tpu_torch.render.params import traverse
    from mitsuba_customization_tpu_torch.scenes import matpreview_dict

    d = matpreview_dict(32, 2, 4, n_sub=3, n_materials=12)
    d["blob_9"]["bsdf"] = {"type": "null"}
    d["blob_10"]["bsdf"] = {"type": "mask", "opacity": 0.6, "bsdf": d["blob_10"]["bsdf"]}
    d["blob_11"]["bsdf"] = {"type": "blendbsdf", "weight": 0.3, "a": d["blob_11"]["bsdf"],
                            "b": {"type": "roughplastic"}}
    scene = mt.load_dict(d, dev)
    key = "bsdf.tabulated.table"
    before = k1.LAUNCHES, k1.LAUNCHES_BWD, k1.GRAD_BUFFERS
    loss, grads = ad._eager_loss_and_grad(scene, {key: traverse(scene)[key]},
                                          torch.zeros((32, 32, 3), device=dev), 2, 0)
    torch.cuda.synchronize()
    assert k1.LAUNCHES > before[0] and k1.LAUNCHES_BWD > before[1]
    assert k1.GRAD_BUFFERS == before[2] + 1
    assert bool(torch.isfinite(loss)) and bool(torch.isfinite(grads[key]).all())
    assert bool((grads[key] != 0).any())


def test_image_frame_gpu_matches_cpu(dev, tmp_path):
    """chip_smoke's image frame (phase 20: a bitmap, checkerboard, mesh
    attribute and volume textures, normal and bump maps, the envmap and a
    spot beside the area light) at 64x64, 4 spp, depth 4 with a fixed
    compaction schedule, on the card and on the CPU: per-channel means
    within 2 %."""
    import chip_smoke
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.scenes import matpreview_dict

    paths = chip_smoke.image_files(str(tmp_path))
    d = chip_smoke.image_bands(
        matpreview_dict(64, 4, 4, n_materials=12, compact=(1.0, 0.8, 0.5)), paths)
    gpu = mt.render(mt.load_dict(d, dev), spp=4, seed=0).cpu()
    cpu = mt.render(mt.load_dict(d, "cpu"), spp=4, seed=0)
    assert torch.isfinite(gpu).all()
    torch.testing.assert_close(gpu.mean((0, 1)), cpu.mean((0, 1)), rtol=0.02, atol=0)


def test_k4_on_directional_shadow_rays(dev):
    """K4 against its plain version on the shadow rays a directional light
    gives: from camera hits on the matpreview blob and floor toward the
    light, maxt = _SHADOW_INF (the light is at infinity): equal on every
    lane, some occluded and some not."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render import emitters as em
    from mitsuba_customization_tpu_torch.render import geometry as tgeo
    from mitsuba_customization_tpu_torch.render.integrator import _SHADOW_INF
    from mitsuba_customization_tpu_torch.scenes import matpreview_dict

    d = matpreview_dict(64, 4, 2, n_sub=4, n_materials=4)
    d["sun"] = {"type": "directional", "direction": [0.4, -1.0, 0.3]}
    scene = mt.load_dict(d, dev)
    gen = torch.Generator(device=dev).manual_seed(15)
    n = 1 << 17
    o = torch.tensor([0.0, 1.6, -3.6], device=dev).expand(n, 3)
    d_ = torch.tensor([0.0, -0.4, 1.0], device=dev) + 0.5 * torch.randn(
        (n, 3), generator=gen, device=dev)
    si = scene.ray_intersect(Ray.make(o, d_ / d_.norm(dim=-1, keepdim=True)))
    u3 = torch.rand((n, 3), generator=gen, device=dev)
    ds = em.sample_direction(scene.emitters, scene.geometry, si.p, u3)
    sun = ds.delta & torch.isinf(ds.dist) & si.valid
    assert bool(sun.any())
    shadow = tgeo.spawn_ray(si, ds.d)
    ray = Ray(shadow.o, shadow.d, torch.where(sun, _SHADOW_INF, 0.0))
    before = cl.LAUNCHES["shadow"]
    occ = scene.ray_test(ray)
    torch.cuda.synchronize()
    assert cl.LAUNCHES["shadow"] == before + 1
    assert torch.equal(occ, cl.occluded_plain(scene.clusters, ray))
    assert bool(occ[sun].any()) and not bool(occ[sun].all()) and not bool(occ[~sun].any())


# ---------------------------------------------------------------------------
# Sensors, samplers, filters and shapes on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["independent", "stratified", "sobol", "ldsampler",
                                  "multijitter", "orthogonal"])
def test_sampler_draws_gpu_equal_cpu(dev, name):
    """Each sampler's draws on the card equal the CPU's, bit for bit
    (spp 9 and 8: the orthogonal sampler's array and its stratified
    fallback; bases 0 and 28)."""
    from mitsuba_customization_tpu_torch.core.sampler import make_sampler

    for spp in (9, 8):
        pixel = torch.arange(5000).repeat_interleave(spp)
        sidx = torch.arange(spp).repeat(5000)
        for base in (0, 28):
            c = make_sampler(name, 7, pixel, sidx, spp).with_dim(base)
            g = make_sampler(name, 7, pixel.to(dev), sidx.to(dev), spp).with_dim(base)
            for op in "2112":
                a = c.next_2d() if op == "2" else c.next_1d()
                b = g.next_2d() if op == "2" else g.next_1d()
                assert torch.equal(a, b.cpu()), (name, spp, base)


@pytest.mark.parametrize("name", ["gaussian", "tent", "mitchell", "catmullrom", "lanczos"])
def test_splat_gpu_matches_cpu(dev, name):
    """The splat's image and weight sums on the card within 1e-5 of the
    CPU's (the atomic adds of index_add_ sum in another order)."""
    from mitsuba_customization_tpu_torch.render import film

    gen = torch.Generator().manual_seed(0)
    values = torch.rand((1 << 20, 3), generator=gen)
    xy = torch.rand((1 << 20, 2), generator=gen) * torch.tensor([128.0, 96.0])
    ft = film.FILTER_NAMES[name]
    img, w = film.splat(values, xy, 96, 128, ft)
    img_g, w_g = film.splat(values.to(dev), xy.to(dev), 96, 128, ft)
    torch.testing.assert_close(img_g.cpu(), img, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(w_g.cpu(), w, rtol=1e-5, atol=1e-5)


def test_sdf_intersect_gpu_matches_cpu(dev):
    """sdf.intersect of 65,536 rays at a 128^3 SDF sphere: on the card S1
    marches (one launch); hit flags equal to the CPU's on >= 99.9 % of
    lanes, t within atol 1e-5 where both hit on >= 99.9 % of them (a lane
    may stop one HIT_EPS step apart: the two devices rotate the rays into
    the grid with matrix products that round apart)."""
    from mitsuba_customization_tpu_torch.render import sdf

    rng = np.random.default_rng(0)
    n = 1 << 16
    tw = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
    tw[:3, 3] = -1.0
    o = (rng.normal(size=(n, 3)) * 0.2 + [0.0, 0.0, -3.0]).astype(np.float32)
    d = (rng.normal(size=(n, 3)) * 0.5 - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    out = []
    for where in ("cpu", dev):
        g = sdf.make(sdf.sphere_sdf(n=128), tw, device=where)
        before = sdf.LAUNCHES
        out.append([x.cpu() for x in sdf.intersect(g, Ray.make(torch.tensor(o, device=where),
                                                               torch.tensor(d, device=where)))])
        assert sdf.LAUNCHES == before + (where == dev)
    (tc, hc, _), (tg, hg, _) = out
    assert 0.2 < float(hc.float().mean()) < 0.9
    assert float((hc == hg).float().mean()) >= 0.999
    both = hc & hg
    assert float(((tc - tg).abs()[both] <= 1e-5).float().mean()) >= 0.999


def test_k3_k4_on_a_shapes_wavefront(dev, tmp_path):
    """K3 and K4 against their plain versions on the camera wavefront of
    a small shapes scene (scenes.shapes_dict: meshes from files, a cube, a
    disk, three cylinders and a sphere in the cluster set): the cluster
    kernels' sphere and cylinder slots are live (lanes hit them), and the
    results agree as in test_k3_kernel_matches_plain."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render.sensors import sample_ray
    from mitsuba_customization_tpu_torch.scenes import shape_files, shapes_dict

    scene = mt.load_dict(shapes_dict(shape_files(str(tmp_path), 0, n_sub=(5, 4, 3)), 256, 1, 2),
                         dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    uv = torch.rand((1 << 16, 2), generator=gen, device=dev)
    ray = sample_ray(scene.sensor, uv, None, 1.0)
    cs = scene.clusters
    t, prim, u, v, g = cl.intersect(cs, ray)
    t_p, u_p, v_p, fld_p = cl.intersect_plain(cs, ray)
    prim_p = fld_p[:, cl.F_PRIM].long()
    hit = prim >= 0
    assert torch.equal(hit, prim_p >= 0)
    same = hit & (prim == prim_p)
    assert same.sum() >= 0.999 * hit.sum()
    torch.testing.assert_close(t[hit], t_p[hit], rtol=1e-6, atol=0)
    types = g.prim_type[same]
    assert int((types == geo.SPHERE).sum()) > 0 and int((types == geo.CYLINDER).sum()) > 0
    shadow = Ray(o=ray.o + ray.d * torch.where(hit, t, 0.0)[:, None] * 0.999,
                 d=torch.nn.functional.normalize(
                     torch.tensor([1.5, 3.5, -1.0], device=dev) - ray.o, dim=-1),
                 maxt=torch.where(hit, 3.0, 0.0))
    assert torch.equal(cl.occluded(cs, shadow), cl.occluded_plain(cs, shadow))


def test_tracking_draws_and_steps_gpu_equal_cpu(dev):
    """The free-flight draws on the card equal the CPU's bit for bit, and
    delta and ratio tracking through a heterogeneous grid agree: the
    scatter flags equal on >= 99.9 % of lanes, distances, weights and
    transmittances within rtol 1e-4 (atol 1e-6) where they do."""
    import numpy as np

    from mitsuba_customization_tpu_torch.render import medium

    lane = torch.arange(1 << 16, dtype=torch.int64) * 2654435761 % (1 << 32)
    assert torch.equal(medium._draw(0x6D656469, lane, 4096 * 3 + 2050),
                       medium._draw(0x6D656469, lane.to(dev), 4096 * 3 + 2050).cpu())
    rng = np.random.default_rng(3)
    rows = [dict(type="heterogeneous", sigma_t=[3.0, 4.0, 5.0], albedo=[0.8] * 3,
                 phase_type=1, phase_g=0.5, density=rng.random((24, 24, 24)).astype(np.float32),
                 to_world=np.diag([2.0, 2.0, 2.0, 1.0]))]
    n = 1 << 16
    o = torch.as_tensor(rng.uniform(0, 2, (n, 3)).astype(np.float32))
    d = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32))
    d = d / d.norm(dim=-1, keepdim=True)
    t_max = torch.as_tensor(rng.uniform(0.1, 3.0, n).astype(np.float32))
    mid = torch.zeros(n, dtype=torch.int64)
    lanes = torch.arange(n)
    out = {}
    for where in ("cpu", dev):
        table = medium.build_table(rows, [0], 1, device=where)
        args = [x.to(where) for x in (mid, o, d, t_max)]
        ms = medium.sample_interaction(table, *args, 5, lanes.to(where), 8)
        tr = medium.transmittance(table, *args, 5, lanes.to(where), 2056)
        out[str(where)] = [x.cpu() for x in (ms.is_medium, ms.t, ms.weight, tr)]
    (f0, t0, w0, tr0), (f1, t1, w1, tr1) = out["cpu"], out[str(dev)]
    agree = f0 == f1
    assert float(agree.float().mean()) >= 0.999
    torch.testing.assert_close(t1[agree], t0[agree], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(w1[agree], w0[agree], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(tr1, tr0, rtol=1e-4, atol=1e-6)


def _tracking_inputs(dev, dense, n=1 << 17, seed=7):
    """A table of a homogeneous and a heterogeneous medium (a seeded 24^3
    grid; `dense`: extinction 40-50 and most of the grid at 0.05, so many
    lanes take more than 48 steps, some all 257) on the card, and seeded
    rays in either medium or in vacuum, with segment ends up to 3 (8 when
    dense), 1e7 on every 97th lane; keys hash_combine(5, lane)."""
    from mitsuba_customization_tpu_torch.core.qmc import hash_combine
    from mitsuba_customization_tpu_torch.render import medium

    rng = np.random.default_rng(seed)
    grid = rng.random((24, 24, 24)).astype(np.float32)
    if dense:
        grid = np.where(grid > 0.9, grid, 0.05).astype(np.float32)
    rows = [dict(type="homogeneous", sigma_t=[0.5, 1.0, 2.0], albedo=[0.8] * 3, phase_type=0,
                 phase_g=0.0),
            dict(type="heterogeneous", sigma_t=[40.0, 45.0, 50.0] if dense else [2.0, 3.0, 4.0],
                 albedo=[0.9, 0.8, 0.7], phase_type=1, phase_g=0.5, density=grid,
                 to_world=np.diag([2.0, 2.0, 2.0, 1.0]))]
    table = medium.build_table(rows, [0, 1], 2, device=dev)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = rng.uniform(0.1, 8.0 if dense else 3.0, n).astype(np.float32)
    t_max[::97] = 1e7
    args = [torch.as_tensor(x, device=dev) for x in (
        rng.integers(-1, 2, n), rng.uniform(0.0, 2.0, (n, 3)).astype(np.float32), d, t_max)]
    key = hash_combine(5, torch.arange(n, dtype=torch.int64, device=dev))
    return table, args, key


@pytest.mark.parametrize("dense", [False, True], ids=["thin", "dense"])
def test_t1_t2_kernels_match_plain(dev, dense):
    """T1 (delta tracking) and T2 (ratio tracking) against their plain
    versions on the card, on 131,072 lanes: each lane's steps and scatter
    flag equal, t, the weights and the transmittance bit for bit (both
    round every step alike and take log1pf from the CUDA math library);
    one launch each; lanes outside the heterogeneous medium untouched."""
    from mitsuba_customization_tpu_torch.render import medium

    table, (mid, o, d, t_max), key = _tracking_inputs(dev, dense)
    before = dict(medium.LAUNCHES)
    got = medium.delta_track(table, mid, o, d, t_max, key, 8)
    want = medium.delta_track_plain(table, mid, o, d, t_max, key, 8)
    got_r = medium.ratio_track(table, mid, o, d, t_max, key, 2056)
    want_r = medium.ratio_track_plain(table, mid, o, d, t_max, key, 2056)
    torch.cuda.synchronize()
    assert medium.LAUNCHES == {"delta": before["delta"] + 1, "ratio": before["ratio"] + 1}
    for name, a, b in zip(("t", "w", "scat", "steps", "tr", "tr_steps"), got + got_r,
                          want + want_r):
        assert torch.equal(a, b), (name, int((a != b).reshape(a.shape[0], -1).any(-1).sum()))
    tracked = mid == 1
    steps = got[3]
    assert bool((steps[~tracked] == 0).all()) and bool((steps[tracked] > 0).all())
    # a lane whose segment ends at 1e7 makes all 257 updates; of the
    # others, some make more than 48 only in the dense medium
    assert int(steps.max()) == medium.MAX_TRACKING_STEPS + 1
    finite = tracked & (t_max < 1e6)
    assert (int(steps[finite].max()) > medium.AD_TRACKING_STEPS) == dense
    assert 0.05 < float(got[2][tracked].float().mean()) < 0.95


@pytest.mark.parametrize("dense", [False, True], ids=["thin", "dense"])
def test_t1_t2_at_ad_steps_match_the_scan(dev, dense, monkeypatch):
    """T1 / T2 at ad_mode's 48 steps (medium._launch) against
    medium._scan on the card, bit for bit on every lane: a lane not done
    after 48 steps keeps its partial t and weight in both."""
    from mitsuba_customization_tpu_torch.render import medium

    monkeypatch.setattr(medium, "LOOPS", [])
    table, (mid, o, d, t_max), key = _tracking_inputs(dev, dense)
    for kind, base in (("delta", 8), ("ratio", 2056)):
        args = (table, mid, o, d, t_max, key, base)
        got = medium._launch(kind, *args, medium.AD_TRACKING_STEPS)
        want = medium._scan(kind, *args)
        want = want if kind == "delta" else want[1:]
        for a, b in zip(got, want):
            assert torch.equal(a, b), (kind, int((a != b).reshape(a.shape[0], -1).any(-1).sum()))
        assert int(got[-1].max()) == medium.AD_TRACKING_STEPS


@pytest.mark.parametrize("dense", [False, True], ids=["thin", "dense"])
def test_t1_t2_bwd_match_plain_and_autograd(dev, dense):
    """T1-bwd / T2-bwd (medium.track_bwd on CUDA tensors) against
    track_bwd_plain and autograd through medium._scan on the card, with
    seeded cotangents: the gradients in sigma_t, the grid, ray_o, ray_d
    and t_max within 1e-4 relative L2 error (the atomic adds' order); one
    launch each."""
    from mitsuba_customization_tpu_torch.render import medium

    table, (mid, o, d, t_max), key = _tracking_inputs(dev, dense)
    gen = torch.Generator(device=dev).manual_seed(3)
    n = o.shape[0]
    g_w = torch.rand((n, 3), generator=gen, device=dev)
    g_t = torch.rand(n, generator=gen, device=dev)
    for kind, base in (("delta", 8), ("ratio", 2056)):
        gt = g_t if kind == "delta" else None
        args = (table, mid, o, d, t_max, key, base)
        out = []
        for fn in (medium.track_bwd, medium.track_bwd_plain):
            grid = torch.zeros_like(table.grid)
            before = medium.LAUNCHES_BWD[kind]
            g = fn(kind, *args, g_w, gt, grid_out=grid, need_rays=True, need_t_max=True)
            out.append((g[0], grid) + g[1:])
        assert medium.LAUNCHES_BWD[kind] == before  # the plain version launches nothing
        leaves = [x.clone().requires_grad_(True) for x in (table.sigma_t, table.grid, o, d, t_max)]
        st = medium._scan(kind, table._replace(sigma_t=leaves[0], grid=leaves[1]), mid,
                          *leaves[2:], key, base)
        loss = (g_w * st[1]).sum() + ((g_t * st[0]).sum() if kind == "delta" else 0.0)
        auto = torch.autograd.grad(loss, leaves, allow_unused=True)
        auto = [torch.zeros_like(x) if a is None else a for x, a in zip(leaves, auto)]
        for want in (out[1], auto):
            for a, b in zip(out[0], want):
                assert bool(torch.isfinite(a).all())
                if float(b.norm()) == 0:
                    assert float(a.norm()) == 0, kind
                else:
                    assert float((a - b).double().norm() / b.double().norm()) <= 1e-4, kind


def _bwd_against_plain(kind, table, args, g_w, g_t, grid=None, summed=False):
    """medium.track_bwd (one launch) against track_bwd_plain on the card:
    every gradient within 1e-4 relative L2 (zero where the plain one is),
    finite. `grid`: the grid-gradient buffer to add into (zeroed here).
    `summed`: the grid's gradient instead held, entry by entry, to the
    float64 sum of the plain version's addends within 1e-4 of the sum of
    their magnitudes (a float32 sum of many addends of both signs, in any
    order, is that close to the exact one), the kernel's and the plain
    version's alike. Returns the kernel's gradients."""
    from mitsuba_customization_tpu_torch.render import medium

    out, pairs = [], []
    scatter = medium._scatter_grid

    def keep(grid_out, idx, add):
        pairs.append((idx, add))
        return scatter(grid_out, idx, add)

    for fn in (medium.track_bwd, medium.track_bwd_plain):
        buf = torch.zeros_like(table.grid) if grid is None or fn is not medium.track_bwd \
            else grid.zero_()
        before = medium.LAUNCHES_BWD[kind]
        medium._scatter_grid = keep
        try:
            g = fn(kind, table, *args, g_w, g_t, grid_out=buf, need_rays=True, need_t_max=True)
        finally:
            medium._scatter_grid = scatter
        if fn is medium.track_bwd:
            assert medium.LAUNCHES_BWD[kind] == before + 1
        out.append((g[0], buf.clone()) + g[1:])
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(*out)):
        assert bool(torch.isfinite(a).all())
        if i == 1 and summed:
            idx = torch.cat([x for x, _ in pairs])
            add = torch.cat([y for _, y in pairs]).double()
            exact = torch.zeros(b.numel(), dtype=torch.float64, device=b.device)
            scale = torch.zeros_like(exact)
            exact.index_add_(0, idx, add)
            scale.index_add_(0, idx, add.abs())
            for x in (a, b):
                assert bool(((x.reshape(-1).double() - exact).abs() <= 1e-4 * scale).all())
        elif float(b.norm()) == 0:
            assert float(a.norm()) == 0, kind
        else:
            assert float((a - b).double().norm() / b.double().norm()) <= 1e-4, kind
    return out[0]


@pytest.mark.parametrize("where", ["none", "all"])
def test_t1_bwd_no_lane_or_every_lane_tracked(dev, where):
    """T1-bwd / T2-bwd where no lane is tracked (vacuum and the homogeneous
    medium: every gradient zero, the ray and t_max gradients written as
    zeros on every lane) and where every lane is (the heterogeneous
    medium), against track_bwd_plain."""
    table, (mid, o, d, t_max), key = _tracking_inputs(dev, False, n=20_000)
    mid = torch.full_like(mid, 1) if where == "all" else mid.clamp(max=0)
    gen = torch.Generator(device=dev).manual_seed(4)
    g_w = torch.rand((mid.shape[0], 3), generator=gen, device=dev)
    g_t = torch.rand(mid.shape[0], generator=gen, device=dev)
    for kind, base, gt in (("delta", 8, g_t), ("ratio", 2056, None)):
        got = _bwd_against_plain(kind, table, (mid, o, d, t_max, key, base), g_w, gt)
        if where == "none":
            assert all(float(x.abs().sum()) == 0 for x in got)


def test_t1_bwd_lanes_at_48_steps(dev):
    """In the dense medium many lanes replay all 48 of ad_mode's steps
    (a replay longer than any window of kept steps): T1-bwd / T2-bwd
    against track_bwd_plain."""
    from mitsuba_customization_tpu_torch.render import medium

    table, (mid, o, d, t_max), key = _tracking_inputs(dev, True, n=30_000)
    steps = medium._launch("delta", table, mid, o, d, t_max, key, 8,
                           medium.AD_TRACKING_STEPS)[-1]
    assert int((steps == medium.AD_TRACKING_STEPS).sum()) > 100
    gen = torch.Generator(device=dev).manual_seed(5)
    g_w = torch.rand((mid.shape[0], 3), generator=gen, device=dev)
    g_t = torch.rand(mid.shape[0], generator=gen, device=dev)
    _bwd_against_plain("delta", table, (mid, o, d, t_max, key, 8), g_w, g_t)
    _bwd_against_plain("ratio", table, (mid, o, d, t_max, key, 2056), g_w, None)


_BWD_KINDS = [("delta", 8), ("ratio", 2056)]


@pytest.mark.parametrize("kind,base", _BWD_KINDS, ids=["t1", "t2"])
def test_t1_bwd_every_lane_in_one_cell(dev, kind, base):
    """Every lane starts at one point of the dense medium's grid with a
    short segment, so each replayed step's eight corners are nearly all
    the same cells: the atomic adds contend. Each of those grid entries
    sums some 65,536 addends (T1: of both signs, real and null
    collisions), so the grid's gradient is held to the float64 sum of the
    plain version's addends (_bwd_against_plain's `summed`); the other
    gradients to track_bwd_plain. T1-bwd and T2-bwd."""
    table, (mid, o, d, t_max), key = _tracking_inputs(dev, True, n=1 << 16)
    n = mid.shape[0]
    mid = torch.ones_like(mid)
    o = torch.full_like(o, 0.0) + torch.tensor([0.29, 0.375, 0.46], device=dev)
    d = torch.nn.functional.normalize(torch.ones_like(d), dim=-1)
    t_max = torch.full_like(t_max, 0.04)
    gen = torch.Generator(device=dev).manual_seed(6)
    g_w = torch.rand((n, 3), generator=gen, device=dev)
    g_t = torch.rand(n, generator=gen, device=dev) if kind == "delta" else None
    got = _bwd_against_plain(kind, table, (mid, o, d, t_max, key, base), g_w, g_t, summed=True)
    assert int((got[1] != 0).sum()) <= 64


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("kind,base", _BWD_KINDS, ids=["t1", "t2"])
def test_t1_bwd_grid_buffer_at_every_alignment(dev, kind, base, offset):
    """The grid's gradient added into a buffer that starts `offset` floats
    into an allocation (its x pairs at every 4-, 8- and 16-byte
    alignment): T1-bwd and T2-bwd against track_bwd_plain."""
    table, (mid, o, d, t_max), key = _tracking_inputs(dev, False, n=40_000)
    gen = torch.Generator(device=dev).manual_seed(7 + offset)
    n = mid.shape[0]
    g_w = torch.rand((n, 3), generator=gen, device=dev)
    g_t = torch.rand(n, generator=gen, device=dev) if kind == "delta" else None
    numel = table.grid.numel()
    buf = torch.zeros(numel + 4, device=dev)[offset:offset + numel].view(table.grid.shape)
    assert buf.data_ptr() % 16 == 4 * offset
    _bwd_against_plain(kind, table, (mid, o, d, t_max, key, base), g_w, g_t, grid=buf)


def test_t2_bwd_writes_every_lane(dev):
    """T2-bwd's ray and t_max gradients come from torch.empty: the kernel
    writes them on every lane. Blocks of their sizes are filled with NaN
    and freed into the caching allocator first, so the outputs land on
    them; then lanes outside the heterogeneous medium read exactly 0, the
    t_max gradient is 0 on every lane (ratio tracking's passed test
    carries none), and the tracked lanes' ray gradients are finite and
    within 1e-4 relative L2 of track_bwd_plain's."""
    from mitsuba_customization_tpu_torch.render import medium

    table, (mid, o, d, t_max), key = _tracking_inputs(dev, False, n=1 << 18)
    n = mid.shape[0]
    gen = torch.Generator(device=dev).manual_seed(8)
    g_w = torch.rand((n, 3), generator=gen, device=dev)
    args = (table, mid, o, d, t_max, key, 2056)
    want = medium.track_bwd_plain("ratio", *args, g_w, need_rays=True, need_t_max=True)
    torch.cuda.synchronize()
    junk = [torch.full(shape, float("nan"), device=dev) for shape in ((n, 3), (n, 3), (n,))]
    freed = {x.data_ptr() for x in junk}
    del junk
    before = medium.LAUNCHES_BWD["ratio"]
    got = medium.track_bwd("ratio", *args, g_w, need_rays=True, need_t_max=True)
    torch.cuda.synchronize()
    assert medium.LAUNCHES_BWD["ratio"] == before + 1
    assert {x.data_ptr() for x in got[1:]} <= freed
    tracked = mid == 1
    assert 0 < int(tracked.sum()) < n
    assert bool((got[3] == 0).all())
    for a, b in zip(got[1:3], want[1:3]):
        assert bool((a[~tracked] == 0).all())
        assert bool(torch.isfinite(a[tracked]).all())
        assert float((a - b).double().norm() / b.double().norm()) <= 1e-4
    assert float((got[0] - want[0]).double().norm() / want[0].double().norm()) <= 1e-4


def test_tracking_wrappers_reject_what_the_kernels_do_not_take(dev):
    """A table on another device than the rays, or int32 medium ids, raise
    ValueError; an input that requires grad under grad mode raises
    RuntimeError (the loops have no gradient outside ad_mode)."""
    from mitsuba_customization_tpu_torch.render import medium

    table, (mid, o, d, t_max), key = _tracking_inputs(dev, False, n=1024)
    cpu_table = medium.MediumTable(*(x.cpu() if torch.is_tensor(x) else x for x in table))
    with pytest.raises(ValueError):
        medium.delta_track(cpu_table, mid, o, d, t_max, key, 0)
    with pytest.raises(ValueError):
        medium.ratio_track(table, mid.to(torch.int32), o, d, t_max, key, 0)
    with pytest.raises(RuntimeError):
        medium.delta_track(table, mid, o.requires_grad_(True), d, t_max, key, 0)


def test_s1_kernel_matches_plain(dev):
    """S1 against march_plain on the card on 131,072 rays through a seeded
    48x51x43 grid of small distances (most lanes march tens of steps, some
    128) and a 128^3 sphere: t, hit and each lane's steps bit for bit; one
    launch each."""
    from mitsuba_customization_tpu_torch.render import sdf

    rng = np.random.default_rng(3)
    n = 1 << 17
    tw = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
    tw[:3, 3] = -1.0
    o = (rng.normal(size=(n, 3)) * 0.2 + [0.0, 0.0, -3.0]).astype(np.float32)
    d = (rng.normal(size=(n, 3)) * 0.5 - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ray = Ray.make(torch.tensor(o, device=dev), torch.tensor(d, device=dev))
    grids = (rng.normal(size=(48, 51, 43)).astype(np.float32) * 0.05 + 0.02,
             sdf.sphere_sdf(n=128))
    for values in grids:
        g = sdf.make(values, tw, device=dev)
        seen = []
        march = sdf.march

        def keep(*args):
            seen.append(args)
            return march(*args)

        sdf.march = keep
        try:
            sdf.intersect(g, ray)
        finally:
            sdf.march = march
        before = sdf.LAUNCHES
        got = sdf.march(*seen[0])
        want = sdf.march_plain(*seen[0])
        torch.cuda.synchronize()
        assert sdf.LAUNCHES == before + 1
        for name, a, b in zip(("t", "hit", "steps"), got, want):
            assert torch.equal(a, b), (name, int((a != b).sum()))
        assert int(got[2].max()) >= 16 and 0.2 < float(got[1].float().mean())


def _march_inputs(dev, values, n, seed, inside=0.7, grazing=False):
    """march's arguments for n seeded rays in the local frame of an SDF
    grid `values` (numpy): origins outside the unit cube aimed through it
    (or, `grazing`, tangent to the sphere of sphere_sdf's defaults), each
    clipped to the cube as sdf.intersect clips it; a share `inside` of the
    lanes active."""
    from mitsuba_customization_tpu_torch.render import sdf

    rng = np.random.default_rng(seed)
    if grazing:
        # tangent to the 0.35 sphere at 0.5: start on a tangent plane point
        # and run along the plane, so the distance stays near HIT_EPS
        u = rng.normal(size=(n, 3))
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        w = rng.normal(size=(n, 3))
        w -= (w * u).sum(-1, keepdims=True) * u
        w /= np.linalg.norm(w, axis=-1, keepdims=True)
        touch = 0.5 + 0.35 * (1.0 + 2e-4) * u
        o = touch - 0.6 * w
        d = w
    else:
        o = rng.uniform(-0.5, 1.5, (n, 3))
        d = rng.uniform(0.2, 0.8, (n, 3)) - o
    g = sdf.make(values, device=dev)
    o_l = torch.tensor(o, dtype=torch.float32, device=dev)
    d_l = torch.tensor(d, dtype=torch.float32, device=dev)
    inv = 1.0 / torch.where(d_l.abs() < 1e-12, 1e-12, d_l)
    t0, t1 = (0.0 - o_l) * inv, (1.0 - o_l) * inv
    near, far = torch.minimum(t0, t1).amax(-1), torch.maximum(t0, t1).amin(-1)
    active = (near <= far) & (far > 0.0)
    active &= torch.tensor(rng.random(n) < inside, device=dev)
    t = torch.clamp(near, min=0.0) + 1e-5
    d_norm = torch.clamp(d_l.norm(dim=-1), min=1e-12)
    return g, (o_l, d_l, t, far, d_norm, active)


def _march_equal(g, args):
    """S1 against march_plain on the same arguments: hit and steps equal, t
    bit for bit (NaN where the plain version's is); returns S1's output."""
    from mitsuba_customization_tpu_torch.render import sdf

    before = sdf.LAUNCHES
    got = sdf.march(g, *args)
    want = sdf.march_plain(g, *args)
    torch.cuda.synchronize()
    assert sdf.LAUNCHES == before + 1
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    nan = torch.isnan(want[0])
    assert torch.equal(torch.isnan(got[0]), nan)
    assert torch.equal(got[0][~nan].view(torch.int32), want[0][~nan].view(torch.int32))
    return got


@pytest.mark.parametrize("shape", [(37, 50, 64), (2, 2, 2), (5, 3, 9)])
def test_s1_odd_grids_match_plain(dev, shape):
    """S1 bit for bit with march_plain on grids whose sides are odd or
    minimal (every cell at the border of the grid), on 50,001 lanes (not
    a multiple of a block)."""
    rng = np.random.default_rng(sum(shape))
    values = (rng.normal(size=shape) * 0.1 + 0.05).astype(np.float32)
    g, args = _march_inputs(dev, values, 50_001, seed=len(shape))
    got = _march_equal(g, args)
    assert int(got[2].max()) > 1


def test_s1_grazing_rays_reach_the_step_cap(dev):
    """Rays tangent to a 128^3 sphere SDF march to MAX_STEPS, bit for bit
    with march_plain."""
    from mitsuba_customization_tpu_torch.render import sdf

    g, args = _march_inputs(dev, sdf.sphere_sdf(n=128), 4096, seed=5, inside=1.0, grazing=True)
    got = _march_equal(g, args)
    assert int((got[2] == sdf.MAX_STEPS).sum()) > 0


@pytest.mark.parametrize("n", [1, 127, 129, 1 << 15])
def test_s1_inactive_lanes_and_sizes(dev, n):
    """No lane active: t_start back, no hit, 0 steps; and lane counts
    around a block's, every lane active where it enters the cube."""
    from mitsuba_customization_tpu_torch.render import sdf

    g, args = _march_inputs(dev, sdf.sphere_sdf(n=33), n, seed=n, inside=1.0)
    _march_equal(g, args)
    off = args[:5] + (torch.zeros_like(args[5]),)
    got = _march_equal(g, off)
    assert torch.equal(got[0], args[2]) and not bool(got[1].any()) and not bool(got[2].any())


def test_s1_nan_passes_the_clamps(dev):
    """NaN in the grid and in the rays passes S1's clamps as it passes
    torch's: a NaN distance or t ends the lane with t NaN, as in
    march_plain."""
    from mitsuba_customization_tpu_torch.render import sdf

    values = sdf.sphere_sdf(n=24)
    values[10:14, 10:14, :] = np.nan
    g, args = _march_inputs(dev, values, 20_000, seed=9, inside=1.0)
    o, d = args[0].clone(), args[1].clone()
    o[::7, 0] = float("nan")
    d[3::11, 1] = float("nan")
    got = _march_equal(g, (o, d) + args[2:])
    assert bool(torch.isnan(got[0]).any())


def _kernel_counts():
    return (k1.LAUNCHES, k2.LAUNCHES, cl.LAUNCHES["closest"], cl.LAUNCHES["shadow"])


@pytest.mark.parametrize("integrator", ["volpath", "ptracer", "bdpt"])
def test_media_and_light_tracer_frames_gpu_match_cpu(dev, integrator):
    """chip_smoke's volpath scene (scenes.volpath_dict: the fog ball and
    the smoke cube beside the blob, a 32^3 grid here) and the matpreview
    scene under ptracer (without its sky) and bdpt, 32x32, 4 spp, depth 4
    at n_sub 3: K1, K3 and K4 launched on the card (K2 too but for
    ptracer), per-channel means within 2 % of the CPU's."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.scenes import matpreview_dict, volpath_dict

    if integrator == "volpath":
        d = volpath_dict(32, 4, 4, grid_res=32, n_sub=3)
    else:
        d = matpreview_dict(32, 4, 4, n_sub=3)
        d["integrator"] = {"type": integrator, "max_depth": 4}
        if integrator == "ptracer":
            del d["sky"]
    scene = mt.load_dict(d, dev)
    before = _kernel_counts()
    gpu = mt.render(scene, spp=4, seed=0).cpu()
    launched = [a - b for a, b in zip(_kernel_counts(), before)]
    assert launched[0] > 0 and launched[2] > 0 and launched[3] > 0
    assert (launched[1] > 0) == (integrator != "ptracer")
    cpu = mt.render(mt.load_dict(d, "cpu"), spp=4, seed=0)
    assert torch.isfinite(gpu).all()
    torch.testing.assert_close(gpu.mean((0, 1)), cpu.mean((0, 1)), rtol=0.02, atol=0)


def test_volpath_ad_step_gpu_matches_cpu(dev):
    """The volpath scene's gradient (16x16, 4 spp, depth 3, a 16^3 grid) on
    the table and the four medium keys, on the card and on the CPU:
    losses within 2 %, gradient cosines >= 0.98; K1's backward launched,
    one grid-sized gradient buffer a backward pass (T1-bwd / T2-bwd add
    into it)."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render import ad, medium
    from mitsuba_customization_tpu_torch.render.params import traverse
    from mitsuba_customization_tpu_torch.scenes import volpath_dict

    keys = ("bsdf.tabulated.table", "medium.sigma_t", "medium.albedo", "medium.phase_g",
            "medium.density")
    d = volpath_dict(16, 4, 3, grid_res=16, n_sub=3)
    out = {}
    for where in (dev, "cpu"):
        scene = mt.load_dict(d, where)
        full = traverse(scene)
        bwd, medium.GRID_BUFFERS = k1.LAUNCHES_BWD, 0
        loss, grads = ad.grad_render(scene, {k: full[k] for k in keys},
                                     torch.zeros((16, 16, 3), device=where), spp=4)
        if where == dev:  # the captured step's warm-up and capture: a backward pass each
            assert k1.LAUNCHES_BWD > bwd and medium.GRID_BUFFERS == 2
        out[str(where)] = (float(loss), {k: g.cpu().flatten().double() for k, g in grads.items()})
    (lg, gg), (lc, gc) = out[str(dev)], out["cpu"]
    assert abs(lg - lc) <= 0.02 * abs(lc)
    for k in keys:
        assert float(gg[k] @ gc[k] / (gg[k].norm() * gc[k].norm())) >= 0.98, k


def _blob_geometry(dev, n_sub):
    """A Geometry on the card: the n_sub icosphere blob's triangles, a
    sphere and a cylinder."""
    from mitsuba_customization_tpu_torch.render.scene import geometry_from_numpy

    v, f = icosphere_blob(n_sub=n_sub)
    p = len(f)
    arrays = dict(
        prim_type=np.r_[np.zeros(p), geo.SPHERE, geo.CYLINDER].astype(np.int32),
        p0=np.r_[v[f[:, 0]], [[2.0, 0.3, 0.1], [-2.0, -1.0, 0.0]]].astype(np.float32),
        e1=np.r_[v[f[:, 1]] - v[f[:, 0]], [[0.7, 0, 0], [0, 2.0, 0]]].astype(np.float32),
        e2=np.r_[v[f[:, 2]] - v[f[:, 0]], [[0, 0, 0], [0.5, 0, 0]]].astype(np.float32),
        **{k: np.zeros((p + 2, 3), np.float32) for k in ("vn0", "vn1", "vn2")},
        **{k: np.zeros((p + 2, 2), np.float32) for k in ("uv0", "uv1", "uv2")},
        mat_id=np.zeros(p + 2, np.int32), emitter_id=np.full(p + 2, -1, np.int32),
        shape_id=np.zeros(p + 2, np.int32))
    return geometry_from_numpy(arrays, dev)


def _bvh_soup(dev):
    """The _cluster_scene geometry (1,280 blob triangles, a sphere and a
    cylinder) as a Geometry on the card, its BVH, and the same 65,536
    rays with maxt inf, 3.5 or 0."""
    from mitsuba_customization_tpu_torch.render import bvh

    g = _blob_geometry(dev, 3)
    _, o, d = _cluster_scene(dev)
    maxt = torch.full((o.shape[0],), float("inf"), device=dev)
    maxt[1::7] = 0.0
    maxt[2::7] = 3.5
    return bvh.build(g, dev), g, Ray(o, d, maxt)


def test_b1_b2_kernels_match_plain(dev):
    """B1 against intersect_plain: hit/miss and prims equal, t, u, v equal
    bit for bit (both sides round every product and sum on its own and
    walk the same nodes); B2 against occluded_plain on every lane; every
    prim type hit; maxt 0 lanes miss."""
    from mitsuba_customization_tpu_torch.render import bvh

    tree, g, ray = _bvh_soup(dev)
    before = dict(bvh.LAUNCHES)
    t, prim, u, v = bvh.intersect(tree, g, ray)
    occ = bvh.occluded(tree, g, ray)
    torch.cuda.synchronize()
    assert bvh.LAUNCHES == {"closest": before["closest"] + 1, "any": before["any"] + 1}
    t_p, prim_p, u_p, v_p = bvh.intersect_plain(tree, g, ray)
    assert torch.equal(prim, prim_p)
    for a, b in ((t, t_p), (u, u_p), (v, v_p)):
        assert torch.equal(a, b)
    hit = prim >= 0
    assert 0.3 < hit.float().mean() < 0.9 and not hit[1::7].any()
    assert set(g.prim_type[prim[hit]].unique().tolist()) == {geo.TRI, geo.SPHERE,
                                                             geo.CYLINDER}
    assert torch.equal(occ, bvh.occluded_plain(tree, g, ray))
    assert torch.equal(occ, hit)  # every hit lies below its own maxt


def test_b1_b2_on_a_shadow_geometry_and_without_cylinders(dev):
    """B2 over a shadow geometry whose first 200 prims are degenerate (the
    tree built on the geometry), and both kernels with the cylinders flag
    off on a soup whose cylinder is then tested as the plain version tests
    it (as a sphere): equal to the plain versions."""
    from mitsuba_customization_tpu_torch.render import bvh

    tree, g, ray = _bvh_soup(dev)
    keep = (torch.arange(g.p0.shape[0], device=dev) >= 200)[:, None]
    shadow = g._replace(e1=torch.where(keep, g.e1, 0.0), e2=torch.where(keep, g.e2, 0.0))
    assert torch.equal(bvh.occluded(tree, shadow, ray), bvh.occluded_plain(tree, shadow, ray))
    got = bvh.intersect(tree, g, ray, False)
    want = bvh.intersect_plain(tree, g, ray, False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(bvh.occluded(tree, g, ray, False), bvh.occluded_plain(tree, g, ray, False))


def _rays_around(dev, n, seed):
    """n rays from a shell around the unit blob, half aimed at it, with
    maxt inf, 3.5 or 0."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o *= (3.0 / np.linalg.norm(o, axis=-1, keepdims=True)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[: n // 2] = -o[: n // 2] + rng.normal(size=(n // 2, 3)).astype(np.float32) * 0.5
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    maxt = np.full(n, np.inf, np.float32)
    maxt[1::7] = 0.0
    maxt[2::7] = 3.5
    return Ray(*(torch.tensor(x, device=dev) for x in (o, d, maxt)))


def _b1_b2_cases(dev, case):
    """(tree, geometry, rays) of one case of test_b1_b2_match_plain_on_every_shape."""
    from mitsuba_customization_tpu_torch.render import bvh

    if case == "small_tree":
        g = _blob_geometry(dev, 2)  # 322 prims
        return bvh.build(g, dev), g, _rays_around(dev, 20_000, 1)
    if case == "tree_of_330k_prims":
        g = _blob_geometry(dev, 7)
        return bvh.build(g, dev), g, _rays_around(dev, 1 << 18, 2)
    tree, g, ray = _bvh_soup(dev)
    if case == "dead_lanes":
        maxt = ray.maxt.clone()
        maxt[0::5] = float("nan")
        maxt[3::11] = -1.0
        maxt[4::13] = float("-inf")
        maxt[6::17] = -0.0
        return tree, g, Ray(ray.o, ray.d, maxt)
    # more rays than the card runs at once (2,048 threads a SM), ragged
    n = 2 * torch.cuda.get_device_properties(dev).multi_processor_count * 2048 + 4097
    return tree, g, _rays_around(dev, n, 3)


@pytest.mark.parametrize("case", ["small_tree", "tree_of_330k_prims", "dead_lanes",
                                  "rays_past_one_wave"])
def test_b1_b2_match_plain_on_every_shape(dev, case):
    """B1 bit-equal to intersect_plain (t, prim, u, v) and B2 equal to
    occluded_plain on every lane: a tree of a few hundred nodes, one of
    327,682 prims, lanes with maxt NaN, -1, -inf, -0 or 0 (misses), and
    more rays than the card runs at once. Each launch counted; the packed
    storage made once; B2 walks near child first (the trees are shallow
    enough), and its skip-link walk (a deeper tree's) gives the same."""
    from mitsuba_customization_tpu_torch.render import bvh

    tree, g, ray = _b1_b2_cases(dev, case)
    pack, _ = bvh.packed(tree, g)
    assert pack.depth <= 64
    if case == "small_tree":
        assert tree.n_nodes < 1000
    if case == "tree_of_330k_prims":
        assert tree.n_nodes > 100_000
    before = dict(bvh.LAUNCHES)
    got = bvh.intersect(tree, g, ray)
    occ = bvh.occluded(tree, g, ray)
    torch.cuda.synchronize()
    assert bvh.LAUNCHES == {"closest": before["closest"] + 1, "any": before["any"] + 1}
    assert bvh.packed(tree, g)[0] is pack
    want = bvh.intersect_plain(tree, g, ray)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                           b.view(torch.int32) if b.is_floating_point() else b)
    hit = got[1] >= 0
    live = ray.maxt > 0
    assert not bool(hit[~live].any()) and 0.05 < float(hit.float().mean()) < 0.95
    assert torch.equal(occ, bvh.occluded_plain(tree, g, ray))
    assert torch.equal(occ, hit)  # every hit lies below its own maxt
    # B2's skip-link walk, which it takes on a tree deeper than its stack
    from mitsuba_customization_tpu_torch.ops import build as kbuild

    p = kbuild.ptr
    o, d, maxt = (x.contiguous() for x in cl._rays(ray))
    deep = torch.empty(o.shape[0], dtype=torch.uint8, device=dev)
    kbuild.check(kbuild.library().mct_bvh_any(
        p(o), p(d), p(maxt), o.shape[0], p(pack.nodes), tree.n_nodes, p(bvh.packed(tree, g)[1]),
        1, 1 << 30, p(deep), kbuild.stream_of(o)), "bvh_any")
    assert torch.equal(deep.bool(), occ)


def test_the_loader_packs_the_bvh_on_the_card(dev, monkeypatch):
    """load_dict makes the kernels' packed storage of a scene on the BVH
    (past a lowered MAX_PRIMS; B1's over the geometry, B2's over the
    shadow geometry), so that its first calls find it made; a scene on the
    clusters makes none."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.ops import clusters as tcl
    from mitsuba_customization_tpu_torch.render import bvh
    from mitsuba_customization_tpu_torch.scenes import matpreview_dict

    d = matpreview_dict(16, 2, 2, n_sub=3)
    d["null_ball"] = {"type": "sphere", "center": [0, 3, 0], "radius": 0.2,
                      "bsdf": {"type": "null"}}
    calls = []
    make = bvh.pack_nodes, bvh.pack_prims
    monkeypatch.setattr(bvh, "pack_nodes",
                        lambda *a, **k: calls.append("nodes") or make[0](*a, **k))
    monkeypatch.setattr(bvh, "pack_prims",
                        lambda *a, **k: calls.append("prims") or make[1](*a, **k))
    on_clusters = mt.load_dict(d, dev)
    assert on_clusters.config.intersector == "cluster" and on_clusters.bvh is not None
    assert calls == []
    monkeypatch.setattr(tcl, "MAX_PRIMS", on_clusters.geometry.p0.shape[0] - 1)
    scene = mt.load_dict(d, dev)
    assert scene.config.intersector == "bvh" and scene.shadow_geometry is not None
    assert calls == ["nodes", "prims", "prims"]
    calls.clear()
    ray = _rays_around(dev, 1000, 4)
    bvh.intersect(scene.bvh, scene.geometry, ray)
    bvh.occluded(scene.bvh, scene.shadow_geometry, ray)
    assert calls == []


def test_bvh_wrappers_reject_what_the_kernels_do_not_take(dev):
    from mitsuba_customization_tpu_torch.render import bvh

    tree, g, ray = _bvh_soup(dev)
    cpu_tree = bvh.BVH(*(x.cpu() for x in tree))
    for fn in (bvh.intersect, bvh.occluded):
        with pytest.raises(ValueError):
            fn(cpu_tree, g, ray)
        with pytest.raises(ValueError):
            fn(tree._replace(skip=tree.skip.long()), g, ray)
        with pytest.raises(ValueError):
            fn(tree, g._replace(p0=g.p0.double()), ray)


def test_bvh_frame_gpu_matches_cpu(dev):
    """The matpreview scene at 32x32, 4 spp, depth 3 on the "bvh"
    intersector: B1 and B2 launched on the card, means within 2 % of the
    CPU's (plain walks)."""
    import dataclasses

    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render import bvh
    from mitsuba_customization_tpu_torch.scenes import matpreview_dict

    d = matpreview_dict(32, 4, 3, n_sub=3)
    imgs = []
    for where in (dev, "cpu"):
        scene = mt.load_dict(d, where)
        scene = dataclasses.replace(scene, config=dataclasses.replace(scene.config,
                                                                      intersector="bvh"))
        before = dict(bvh.LAUNCHES)
        imgs.append(mt.render(scene, spp=4, seed=0).cpu())
        if where == dev:
            assert bvh.LAUNCHES["closest"] > before["closest"]
            assert bvh.LAUNCHES["any"] > before["any"]
    torch.testing.assert_close(imgs[0].mean((0, 1)), imgs[1].mean((0, 1)), rtol=0.02, atol=0)


def _all_counts():
    from mitsuba_customization_tpu_torch.render import bvh, medium, sdf

    return (k1.LAUNCHES, k2.LAUNCHES, cl.LAUNCHES["closest"], cl.LAUNCHES["shadow"],
            bvh.LAUNCHES["closest"], bvh.LAUNCHES["any"], medium.LAUNCHES["delta"],
            medium.LAUNCHES["ratio"], sdf.LAUNCHES)


def _launched(fn):
    before = _all_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, [a - b for a, b in zip(_all_counts(), before)]


# K1-K4, B1, B2, T1, T2 and S1 by the names a trace gives them, in
# _all_counts' order
_TRACE_NAMES = ("merl_eval_kernel", "cond_sample_kernel", "cluster_closest_kernel",
                "cluster_shadow_kernel", "bvh_closest_kernel", "bvh_any_kernel",
                "medium_delta_track_kernel", "medium_ratio_track_kernel", "sdf_march_kernel")


def _traced(fn):
    """fn()'s result and the launches of each kernel of _TRACE_NAMES in
    its trace (a replayed graph calls no wrapper)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, [sum(k in n for n in names) for k in _TRACE_NAMES]


@pytest.mark.parametrize("scene_name", ["flagship", "matpreview_probed"])
def test_render_jit_replays_render_bit_for_bit(dev, scene_name):
    """render_jit on the card (a captured CUDA graph, replayed) against
    render at two seeds, bit for bit on these box-filter frames: the
    flagship (K1, K2) and the matpreview scene with its probed compaction
    schedule (K1-K4), 64x64. A replay launches each kernel as often as
    render (counted in both traces, and by the wrappers in render), each
    kernel of the path > 0; a new seed replays the same graph."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render import frame_graph
    from mitsuba_customization_tpu_torch.render.integrator import render_jit
    from mitsuba_customization_tpu_torch.scenes import (
        flagship_dict,
        matpreview_dict,
        probe_compact_schedule,
    )

    if scene_name == "flagship":
        scene, need = mt.load_dict(flagship_dict(64, 8, 4), dev), (0, 1)
    else:
        scene, _ = probe_compact_schedule(mt.load_dict(matpreview_dict(64, 4, 6, n_sub=3), dev))
        need = (0, 1, 2, 3)
    frame_graph.clear()
    for seed in (1, 2):
        want = mt.render(scene, scene.config.spp, seed)
        got = render_jit(scene, scene.config.spp, seed)
        assert torch.equal(got, want), seed
    plans = frame_graph.PLANS
    got, jit_traced = _traced(lambda: render_jit(scene, scene.config.spp, 3))
    (want, counts), traced = _traced(lambda: _launched(
        lambda: mt.render(scene, scene.config.spp, 3)))
    assert torch.equal(got, want) and frame_graph.PLANS == plans
    assert jit_traced == traced == counts and all(counts[i] > 0 for i in need), (
        jit_traced, traced, counts)
    assert frame_graph.latest().graph is not None and frame_graph.latest().capture_s > 0
    frame_graph.clear()


def test_render_jit_reads_an_in_place_geometry_edit_on_the_bvh(dev, monkeypatch):
    """A scene on the BVH (past a lowered MAX_PRIMS): render_jit equals
    render; after an in-place edit of the geometry's vertices the packs
    are made anew (their addresses are in the frame's key), so the next
    render_jit captures again, drops the frame it replaces and still
    equals render; its replay launches B1 and B2."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.ops import clusters as tcl
    from mitsuba_customization_tpu_torch.render import frame_graph
    from mitsuba_customization_tpu_torch.render.integrator import render_jit
    from mitsuba_customization_tpu_torch.scenes import matpreview_dict

    d = matpreview_dict(48, 4, 4, n_sub=3)
    monkeypatch.setattr(tcl, "MAX_PRIMS", 64)
    scene = mt.load_dict(d, dev)
    assert scene.config.intersector == "bvh"
    frame_graph.clear()
    assert torch.equal(render_jit(scene, 4, 1), mt.render(scene, 4, 1))
    plans = frame_graph.PLANS
    with torch.no_grad():  # triangles shrink toward p0, inside the tree's boxes
        for g in {id(scene.geometry): scene.geometry,
                  id(scene.shadow_geometry): scene.shadow_geometry}.values():
            if g is not None:
                g.e1.mul_(0.9)
                g.e2.mul_(0.9)
    render_jit(scene, 4, 1)
    assert frame_graph.PLANS == plans + 1 and len(frame_graph._FRAMES) == 1
    got, jit_traced = _traced(lambda: render_jit(scene, 4, 1))
    assert torch.equal(got, mt.render(scene, 4, 1))
    assert jit_traced[4] > 0 and jit_traced[5] > 0
    frame_graph.clear()


def _looped_scene(name, dev):
    """(scene on the card, spp, the _all_counts entries that must launch)
    of a frame whose loops run to a condition per lane: the volpath scene
    with a 32^3 grid (T1 / T2, K1-K4), an SDF sphere (S1), the matpreview
    scene under ptracer without its sky and under bdpt (64x64, depth 4)."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.scenes import (
        matpreview_dict,
        sdf_sphere_dict,
        sphere_sdf,
        volpath_dict,
    )

    if name == "volpath":
        return mt.load_dict(volpath_dict(64, 4, 4, grid_res=32, n_sub=3), dev), 4, (0, 2, 3, 6, 7)
    if name == "sdf":
        tw = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
        tw[:3, 3] = -1.0
        d = sdf_sphere_dict({"type": "sdfgrid", "grid": sphere_sdf(n=64), "to_world": tw,
                             "bsdf": {"type": "diffuse"}}, 64, 4)
        return mt.load_dict(d, dev), 4, (8,)
    d = matpreview_dict(64, 4, 4, n_sub=3)
    d["integrator"] = {"type": name, "max_depth": 4}
    if name == "ptracer":
        del d["sky"]
    return mt.load_dict(d, dev), 4, (0, 2, 3)


@pytest.mark.parametrize("name", ["volpath", "sdf", "ptracer", "bdpt"])
def test_render_jit_replays_the_looped_frames(dev, name):
    """render_jit of the kinds whose loops run to a condition per lane
    (T1 / T2, S1 and the light tracers' bodies, which read nothing back to
    the host) against render at two seeds: volpath and the SDF frame bit
    for bit; ptracer and bdpt, whose camera connections splat with atomic
    adds, in per-channel means within three times the largest difference
    of four renders at the seed (1e-6 relative at least), every pixel
    within 1e-3 relative. A replay launches each kernel as often as render
    (both traces, and render's wrappers), those of the path > 0."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render import frame_graph
    from mitsuba_customization_tpu_torch.render.integrator import render_jit

    scene, spp, need = _looped_scene(name, dev)
    exact = name in ("volpath", "sdf")
    frame_graph.clear()
    for seed in (1, 2):
        got = render_jit(scene, spp, seed)
        wants = [mt.render(scene, spp, seed) for _ in range(1 if exact else 4)]
        if exact:
            assert torch.equal(got, wants[0]), seed
            continue
        means = [w.double().mean((0, 1)) for w in wants]
        spread = max(float((a - b).abs().max()) for i, a in enumerate(means)
                     for b in means[:i])
        limit = max(3 * spread, 1e-6 * float(means[0].abs().max()))
        assert float((got.double().mean((0, 1)) - means[0]).abs().max()) <= limit, seed
        torch.testing.assert_close(got, wants[0], rtol=1e-3, atol=1e-6)
    plans = frame_graph.PLANS
    got, jit_traced = _traced(lambda: render_jit(scene, spp, 3))
    (want, counts), traced = _traced(lambda: _launched(lambda: mt.render(scene, spp, 3)))
    assert frame_graph.PLANS == plans and bool(torch.isfinite(got).all())
    assert jit_traced == traced == counts and all(counts[i] > 0 for i in need), (
        jit_traced, traced, counts)
    frame_graph.clear()


def test_captured_volpath_ad_step_against_the_eager_step(dev):
    """grad_render of the volpath scene (64x64, 4 spp, depth 4, a 32^3
    grid) on the table and the four medium keys, captured (T1 / T2 at
    ad_mode's 48 steps and T1-bwd / T2-bwd in the graph) against the eager step at
    two seeds: the loss equal bit for bit (the box filter), each gradient
    within three times the spread of SPREAD_STEPS eager steps."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render import ad, frame_graph
    from mitsuba_customization_tpu_torch.render.params import traverse
    from mitsuba_customization_tpu_torch.scenes import volpath_dict

    scene = mt.load_dict(volpath_dict(64, 4, 4, grid_res=32, n_sub=3), dev)
    full = traverse(scene)
    params = {k: full[k] for k in ("bsdf.tabulated.table", "medium.sigma_t", "medium.albedo",
                                   "medium.phase_g", "medium.density")}
    target = torch.zeros((64, 64, 3), device=dev)
    frame_graph.clear()
    for seed in (1, 2):
        got = ad.grad_render(scene, params, target, 4, seed)
        eager = _eager_steps(ad, scene, params, target, 4, seed)
        assert torch.equal(got[0], eager[0][0]), seed
        _assert_within_spread(got[1], [e[1] for e in eager])
    assert frame_graph.latest().graph is not None
    frame_graph.clear()


def test_render_sharded_jit_on_one_rank_equals_render_sharded(dev):
    """render_sharded_jit without a process group (a world of one) on the
    card: the rank's captured slab equals render_sharded and render_jit."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.parallel import mesh as pm
    from mitsuba_customization_tpu_torch.render import frame_graph
    from mitsuba_customization_tpu_torch.render.integrator import render_jit
    from mitsuba_customization_tpu_torch.scenes import flagship_dict

    scene = mt.load_dict(flagship_dict(32, 4, 3), dev)
    frame_graph.clear()
    got = pm.render_sharded_jit(scene, None, 4, 5)
    assert torch.equal(got, pm.render_sharded(scene, None, 4, 5))
    assert torch.equal(got, render_jit(scene, 4, 5))
    frame_graph.clear()


def _rel_l2(a, b):
    return float((a - b).double().norm() / b.double().norm())


def _ad_step_scene(dev):
    """A matpreview-like AD step: 64x64, 4 spp, depth 6, the probed
    schedule, the 10-table stack and the floor's alpha."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render.params import traverse
    from mitsuba_customization_tpu_torch.scenes import matpreview_dict, probe_compact_schedule

    scene, _ = probe_compact_schedule(mt.load_dict(matpreview_dict(64, 4, 6, n_sub=3), dev))
    full = traverse(scene)
    keys = ("bsdf.tabulated.table", "bsdf.roughconductor.alpha_u")
    return scene, {k: full[k] for k in keys}, torch.zeros((64, 64, 3), device=dev)


SPREAD_STEPS = 4


def _eager_steps(ad, *args):
    """SPREAD_STEPS eager steps of the same arguments (their losses and
    gradients differ only by atomic order)."""
    return [ad._eager_loss_and_grad(*args) for _ in range(SPREAD_STEPS)]


def _assert_within_spread(got, eager):
    """Each gradient of `got` against the first of `eager` (eager steps'
    gradients at one seed) within three times the largest relative L2
    difference of two of them, which K1-bwd's atomic adds (and autograd's
    accumulating index backward, and a splat's) set; 1e-6 at least,
    float32 rounding."""
    want = eager[0]
    for k in want:
        spread = max(float((a[k] - b[k]).double().norm() / want[k].double().norm())
                     for i, a in enumerate(eager) for b in eager[:i])
        limit = max(3 * spread, 1e-6)
        assert _rel_l2(got[k], want[k]) <= limit, (k, _rel_l2(got[k], want[k]), limit)


def test_captured_ad_step_against_the_eager_step(dev):
    """grad_render on the card (a captured CUDA graph of the forward and the
    backward, replayed) against the eager step at two seeds: the loss
    equal bit for bit (the box filter), each gradient within three times
    the measured spread of SPREAD_STEPS eager steps. The first call warms up and captures (one
    table-gradient buffer each: the capture's lives in the graph's pool),
    a replay allocates none. A replay launches K1-K4 and K1-bwd as often
    as the eager step's wrappers count (counted in its trace), each > 0."""
    from mitsuba_customization_tpu_torch.render import ad, frame_graph

    scene, params, target = _ad_step_scene(dev)
    frame_graph.clear()
    buffers = k1.GRAD_BUFFERS
    ad.grad_render(scene, params, target, 4, 1)
    assert k1.GRAD_BUFFERS == buffers + 2
    step = frame_graph.latest()
    assert step.graph is not None and step.grad and step.capture_s > 0
    plans = frame_graph.PLANS
    for seed in (1, 2):
        eager = _eager_steps(ad, scene, params, target, 4, seed)
        buffers = k1.GRAD_BUFFERS
        got = ad.grad_render(scene, params, target, 4, seed)
        torch.cuda.synchronize()
        assert k1.GRAD_BUFFERS == buffers and frame_graph.PLANS == plans
        assert torch.equal(got[0], eager[0][0]), seed
        _assert_within_spread(got[1], [e[1] for e in eager])
    names = _TRACE_NAMES[:4] + ("merl_eval_bwd_kernel",)

    def traced(fn):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        ev = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        return [sum(n in e for e in ev) for n in names]

    jit_traced = traced(lambda: ad.grad_render(scene, params, target, 4, 3))
    before = _all_counts()[:4] + (k1.LAUNCHES_BWD,)
    ad._eager_loss_and_grad(scene, params, target, 4, 3)
    torch.cuda.synchronize()
    counts = [a - b for a, b in zip(_all_counts()[:4] + (k1.LAUNCHES_BWD,), before)]
    assert jit_traced == counts and min(counts) > 0, (jit_traced, counts)
    frame_graph.clear()


def test_captured_ad_step_reads_an_in_place_parameter_change(dev):
    """A replay after an in-place edit of the parameters (the table scaled,
    the alpha raised) plans nothing new and equals a fresh eager step on
    the edited values: the loss bit for bit, each gradient within three
    times the spread of SPREAD_STEPS eager steps."""
    from mitsuba_customization_tpu_torch.render import ad, frame_graph

    scene, params, target = _ad_step_scene(dev)
    params = {k: v.clone() for k, v in params.items()}
    frame_graph.clear()
    before = ad.grad_render(scene, params, target, 4, 1)
    plans = frame_graph.PLANS
    with torch.no_grad():
        params["bsdf.tabulated.table"].mul_(0.7)
        params["bsdf.roughconductor.alpha_u"].add_(0.1)
    got = ad.grad_render(scene, params, target, 4, 1)
    assert frame_graph.PLANS == plans and not torch.equal(got[0], before[0])
    eager = _eager_steps(ad, scene, params, target, 4, 1)
    assert torch.equal(got[0], eager[0][0])
    _assert_within_spread(got[1], [e[1] for e in eager])
    frame_graph.clear()


def _libcuda_nodes(graph):
    """A kept cudaGraph_t's node count from libcuda's cuGraphGetNodes
    (chip_smoke's own count before frames kept theirs)."""
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")
    count = ctypes.c_size_t(0)
    err = cuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None,
                               ctypes.byref(count))
    assert err == 0
    return int(count.value)


def _replay_kernels(graph, pad_s=0.05):
    """The kernels of one traced replay of `graph`, in start order (copies
    and sets left out, as the benchmark's trace reads them). A trace tends
    to drop the first launches after it starts (more once the process has
    captured an AD step), so the graph replays twice in it, and the
    kernels that started after the host's clock passed the second replay
    (a trace's device stamps share the host's clock) are the second's."""
    import time

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(pad_s)
        graph.replay()
        torch.cuda.synchronize()
        time.sleep(pad_s)
        t_second = time.time_ns()
        graph.replay()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    ev = [(e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events()
          if e.device_type() == torch.autograd.DeviceType.CUDA and e.start_ns() > t_second
          and not e.name().startswith(("Memcpy", "Memset"))]
    return [n for _, n in sorted(ev)]


def _check_table(graph, table, stages, traced=False):
    """A GraphTable against its graph: the node count libcuda gives, leaf
    spans tiling [0, nodes), each hand-written kernel of `stages` ({trace
    name: span name}) in that span only, and launched; if `traced`, kernel
    names equal to a traced replay's one for one (CUDA's own kernels for
    copy and set nodes, memcpy* / memset*, left out, at most one a copy
    node; a trace may drop a launch, so the first of three traces that
    drops none)."""
    assert table.nodes == _libcuda_nodes(graph)
    spans = table.spans
    assert spans[0][1] == 0 and spans[-1][2] == table.nodes
    assert all(a[2] == b[1] for a, b in zip(spans, spans[1:]))
    names = [n for _, n in table.kernels]
    for _ in range(3 if traced else 0):
        replayed = _replay_kernels(graph)
        own = [n for n in replayed if not n.startswith(("memcpy", "memset"))]
        if own == names:
            break
    if traced:
        assert own == names and len(replayed) - len(own) <= len(table.copies), (len(own),
                                                                               len(names))
    paths = table.kernel_paths()
    for kernel, stage in stages.items():
        where = {p for n, p in zip(names, paths) if kernel in n}
        assert where and all(stage in p.split("/") for p in where), (kernel, where)


def _in_a_child(check):
    """Run this file's function `check` in a fresh Python process: a
    profiler's trace of a captured graph's replay is sound in a process
    that has not traced and captured many graphs before (in one that has,
    traces drop launches)."""
    import os
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    code = f"import sys; sys.path.insert(0, {here!r}); import test_torch_cuda; test_torch_cuda.{check}()"
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=900, cwd=os.path.dirname(here))
    assert r.returncode == 0, (r.stdout[-4000:], r.stderr[-4000:])


def check_frame_tables_and_counters():
    """test_frame_tables_and_counters_on_the_card's checks."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render import frame_graph
    from mitsuba_customization_tpu_torch.render.integrator import render_jit, render_rows
    from mitsuba_customization_tpu_torch.scenes import matpreview_dict, probe_compact_schedule
    from mitsuba_customization_tpu_torch.utils import log

    scene, _ = probe_compact_schedule(mt.load_dict(matpreview_dict(64, 4, 6, n_sub=3), "cuda"))
    render_jit(scene, 4, 1)
    frame = frame_graph.latest()
    assert frame.nodes == frame.tables[0].nodes and log.GRAPHS[-1] is frame.tables[0]
    _check_table(frame.graph, frame.tables[0],
                 {"cluster_closest_kernel": "intersect", "cluster_shadow_kernel": "shadow",
                  "merl_eval_kernel": "bsdf", "cond_sample_kernel": "bsdf"}, traced=True)
    render_jit(scene, 4, 7)
    torch.cuda.synchronize()
    got = [(n, int(a), None if s is None else int(s)) for n, a, s in frame.counters]
    _, eager = render_rows(scene, 4, 7, None, None, False, 0, scene.config.height)
    _, stats = mt.render(scene, 4, 7, return_stats=True)
    want = [(n, int(a), None if s is None else int(s)) for n, a, s in eager]
    assert got == want and frame.tables[0].counters is frame.counters
    assert sum(a + (s or 0) for _, a, s in got) == stats["rays_traced"]


def test_frame_tables_and_counters_on_the_card(dev):
    """render_jit's frame keeps its graph's node count (libcuda's count of
    the kept graph), span table and kernel names (a traced replay's, one
    for one): K3 under intersect, K4 under shadow, K1 / K2 under bsdf;
    its bounce counters after a replay equal an eager render's at the
    same seed, and sum to its rays_traced. In a child process."""
    _in_a_child("check_frame_tables_and_counters")


def test_step_tables_on_the_card(dev):
    """grad_render's step keeps its graph's table: libcuda's node count,
    update, forward and backward tiling the nodes, K1-bwd under backward;
    loss_and_grad_sharded_jit's split step (gaussian filter) keeps a table
    a graph, the backward's all under backward. (Its replays' traces are
    held to the tables by the benchmark's readers: a traced replay of an AD
    step has crashed a test process.)"""
    from mitsuba_customization_tpu_torch.parallel import mesh as pm
    from mitsuba_customization_tpu_torch.render import ad, frame_graph

    scene, params, target = _ad_step_scene(dev)
    frame_graph.clear()
    ad.grad_render(scene, params, target, 4, 1)
    step = frame_graph.latest()
    (table,) = step.tables
    assert {p.split("/")[0] for p, _, _ in table.spans} == {"update", "forward", "backward"}
    _check_table(step.graph, table, {"merl_eval_bwd_kernel": "backward"})
    scene.config.rfilter = "gaussian"
    frame_graph.clear()
    pm.loss_and_grad_sharded_jit(scene, params, target, None, 4, 1)
    split = frame_graph.latest()
    fwd, bwd = split.tables
    assert (fwd.kind, bwd.kind) == ("forward", "backward") and split.nodes == fwd.nodes
    assert {p.split("/")[0] for p, _, _ in bwd.spans} == {"backward"}
    _check_table(split.graph, fwd, {"merl_eval_kernel": "forward"})
    _check_table(split.bwd_graph, bwd, {"merl_eval_bwd_kernel": "backward"})
    frame_graph.clear()


def test_loss_and_grad_sharded_jit_on_one_rank_equals_grad_render(dev):
    """loss_and_grad_sharded_jit without a process group (a world of one)
    on the card: the box filter's slab step (one graph) and the gaussian
    filter's split step (forward and backward graphs around the eager
    exchange) against grad_render's eager step at the same seed: the loss
    equal bit for bit under the box filter, under the gaussian's atomic
    splat within three times the spread of SPREAD_STEPS eager steps (1e-6
    relative at least); each gradient within three times their spread."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.parallel import mesh as pm
    from mitsuba_customization_tpu_torch.render import ad, frame_graph
    from mitsuba_customization_tpu_torch.render.params import traverse
    from mitsuba_customization_tpu_torch.scenes import flagship_dict

    for rfilter in ("box", "gaussian"):
        d = flagship_dict(32, 4, 3)
        d["sensor"]["film"]["rfilter"] = rfilter
        scene = mt.load_dict(d, dev)
        full = traverse(scene)
        params = {k: full[k] for k in ("bsdf.tabulated.table", "bsdf.roughconductor.alpha_u")}
        target = torch.zeros((32, 32, 3), device=dev)
        frame_graph.clear()
        for seed in (5, 6):
            got = pm.loss_and_grad_sharded_jit(scene, params, target, None, 4, seed)
            eager = _eager_steps(ad, scene, params, target, 4, seed)
            losses = [float(e[0]) for e in eager]
            if rfilter == "box":
                assert torch.equal(got[0], eager[0][0])
            else:
                assert abs(float(got[0]) - losses[0]) <= max(3 * (max(losses) - min(losses)),
                                                             1e-6 * losses[0])
            _assert_within_spread(got[1], [e[1] for e in eager])
        frame_graph.clear()

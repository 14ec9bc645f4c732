"""The port's CUDA kernels (K1-K4) against their plain PyTorch versions,
on a GPU.

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

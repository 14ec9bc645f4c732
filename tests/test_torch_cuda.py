"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Needs an NVIDIA Hopper GPU and nvcc; skips without one. This file imports
no JAX, so on a machine without it run it past tests/conftest.py:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from mitsuba_customization_tpu_torch.ops import marginal_sorted as k2
from mitsuba_customization_tpu_torch.ops import merl_sorted as k1

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

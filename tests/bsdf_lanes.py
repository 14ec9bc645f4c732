"""A BSDF table with every kernel the fused BSDF stage computes (diffuse,
GGX and Beckmann rough conductors, two MERL-format tables), a kernel it
does not (plastic) and a null material, and seeded bounce_shade lanes on
it: wi and wo_nee below the horizon, dead lanes, unlit NEE lanes, null
lanes. Shared by the CPU tests of the route and the GPU tests of the
kernels; imports no JAX."""

import numpy as np
import torch

from mitsuba_customization_tpu_torch.models import bsdf
from mitsuba_customization_tpu_torch.models.diffuse import DiffuseParams
from mitsuba_customization_tpu_torch.models.plastic import PlasticParams
from mitsuba_customization_tpu_torch.models.roughconductor import RoughConductorParams
from mitsuba_customization_tpu_torch.models.tabulated import TabulatedBRDF

# (kernel, slot) of each material id; the last is null
MATERIALS = (
    (bsdf.DIFFUSE, 0), (bsdf.ROUGHCONDUCTOR, 0), (bsdf.ROUGHCONDUCTOR_BECKMANN, 0),
    (bsdf.TABULATED, 0), (bsdf.PLASTIC, 0), (bsdf.ROUGHCONDUCTOR, 1),
    (bsdf.TABULATED, 1), (bsdf.DIFFUSE, 1), (bsdf.ROUGHCONDUCTOR_BECKMANN, 1),
    (bsdf.NULL, 0),
)


def table_array(rng, shape=(16, 16, 32, 3)):
    """A MERL-format table that varies smoothly along its three axes:
    tests/test_torch_kernels.smooth_table's formula, which that file's JAX
    imports keep from the GPU tests."""
    n_th, n_td, n_pd, _ = shape
    th = ((np.arange(n_th) + 0.5) / n_th) ** 2 * (np.pi / 2)
    td = (np.arange(n_td) + 0.5) / n_td * (np.pi / 2)
    pd = (np.arange(n_pd) + 0.5) / n_pd * np.pi
    a = rng.random((3, 3)) * 0.12
    t = (0.3 + a[0] * np.cos(3 * th)[:, None, None, None] * np.cos(2 * td)[None, :, None, None]
         + a[1] * np.sin(th)[:, None, None, None] ** 2 * np.sin(td)[None, :, None, None]
         * np.cos(2 * pd[None, None, :, None] + 10 * a[2]))
    return np.broadcast_to(t, shape).astype(np.float32)


def _rough(rng, n, dev):
    alpha = rng.uniform(0.05, 0.6, n)
    f = dict(alpha_u=alpha, alpha_v=alpha * rng.uniform(0.5, 1.5, n),
             eta=rng.uniform(0.2, 1.5, (n, 3)), k=rng.uniform(1.0, 4.0, (n, 3)),
             specular_reflectance=rng.random((n, 3)))
    return RoughConductorParams(**{k: torch.tensor(v, dtype=torch.float32, device=dev)
                                   for k, v in f.items()})


def mixed_table(dev, seed=0):
    """The BSDFTable of MATERIALS on `dev`, two smooth tables its MERL pair."""
    rng = np.random.default_rng(seed)

    def t(x, dtype=torch.float32):
        return torch.tensor(np.asarray(x), dtype=dtype, device=dev)

    tables = t(np.stack([table_array(rng), 0.5 * table_array(rng)]))
    stacks = {
        bsdf.DIFFUSE: DiffuseParams(t(rng.random((2, 3)))),
        bsdf.ROUGHCONDUCTOR: _rough(rng, 2, dev),
        bsdf.ROUGHCONDUCTOR_BECKMANN: _rough(rng, 2, dev),
        bsdf.TABULATED: TabulatedBRDF.build_stack(tables),
        bsdf.PLASTIC: PlasticParams(t(rng.random((1, 3)) * 0.5), t(np.ones((1, 3))),
                                    t([1.5])),
    }
    return bsdf.BSDFTable(mat_type=t([k for k, _ in MATERIALS], torch.int64),
                          mat_slot=t([s for _, s in MATERIALS], torch.int64), stacks=stacks)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def lanes(dev, n, n_mat, seed=0):
    """bounce_shade's lane inputs as a dict: wi mostly above the horizon
    (one in eight below), wo_nee anywhere, samples in [0, 1), a few at 0
    and at the top of the range; 15 % of lanes dead, 30 % of the live
    ones unlit for NEE."""
    rng = np.random.default_rng(seed)
    wi = _unit(rng, n)
    wi[:, 2] = np.abs(wi[:, 2]) * np.where(rng.random(n) < 0.125, -1.0, 1.0)
    s2 = rng.random((n, 2))
    s2[: n // 64] = 0.0
    s2[n // 64: n // 32, 0] = 1.0 - 2.0 ** -24
    active = rng.random(n) > 0.15

    def t(x, dtype=torch.float32):
        return torch.tensor(x, dtype=dtype, device=dev)

    return dict(mat_id=t(rng.integers(0, n_mat, n), torch.int64), wi=t(wi),
                wo_nee=t(_unit(rng, n)), sample2=t(s2), sample1=t(rng.random(n)),
                active=t(active, torch.bool),
                nee_mask=t(active & (rng.random(n) > 0.3), torch.bool))

"""The MERL lookup's table bins, as the JAX package's logical function
(`models/tabulated._grid_coords` and `_trilinear_gather`) addresses them:
the kernel counts of K1 and K1-bwd count each bin their lanes touch once."""

from __future__ import annotations

import math

import torch


def corner_bins(table_shape, wi, wo, slot):
    """The linear (slot, theta_h, theta_d, phi_d) bins of each lane's 8
    trilinear corners: the table's axes over the sqrt-warped half angle,
    the difference angle and the difference azimuth folded mod pi; theta
    corners clamp at the borders and phi_d wraps."""
    n_th, n_td, n_pd = table_shape[-4], table_shape[-3], table_shape[-2]
    h = wi + wo
    h = h / h.norm(dim=-1, keepdim=True).clamp(min=1e-7)
    theta_h = torch.arccos(h[:, 2].clamp(-1, 1))
    phi_h = torch.atan2(h[:, 1], h[:, 0])
    c, s = torch.cos(-phi_h), torch.sin(-phi_h)
    x1, y1, z1 = c * wi[:, 0] - s * wi[:, 1], s * wi[:, 0] + c * wi[:, 1], wi[:, 2]
    c, s = torch.cos(-theta_h), torch.sin(-theta_h)
    x2, z2 = c * x1 + s * z1, -s * x1 + c * z1
    theta_d = torch.arccos(z2.clamp(-1, 1))
    phi_d = torch.atan2(y1, x2)
    phi_d = torch.where(phi_d < 0, phi_d + math.pi, phi_d)
    u = [torch.sqrt((theta_h / (math.pi / 2)).clamp(min=0)) * n_th - 0.5,
         theta_d / (math.pi / 2) * n_td - 0.5, phi_d / math.pi * n_pd - 0.5]
    i0, j0, k0 = (torch.floor(x).long() for x in u)
    out = []
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                i = (i0 + di).clamp(0, n_th - 1)
                j = (j0 + dj).clamp(0, n_td - 1)
                k = (k0 + dk) % n_pd
                out.append(((slot * n_th + i) * n_td + j) * n_pd + k)
    return torch.cat(out)


def halves(a, n, device):
    """[(wo, live mask), ...] of a call's one or two halves (every lane
    live where a half has no mask), and the slot of each lane (0 where the
    call has none)."""
    out = [(a["wo"], a.get("mask"))]
    if a.get("wo_b") is not None:
        out.append((a["wo_b"], a.get("mask_b")))
    every = torch.ones(n, dtype=torch.bool, device=device)
    slot = a.get("slot")
    slot = torch.zeros(n, dtype=torch.long, device=device) if slot is None else slot.long()
    return [(wo, every if m is None else m) for wo, m in out], slot

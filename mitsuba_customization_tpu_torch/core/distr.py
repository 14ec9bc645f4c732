"""Tabulated sampling distributions (1-D and 2-D CDF inversion).

PyTorch port of mitsuba_customization_tpu/core/distr.py:
`DiscreteDistribution`, `Marginal2D.build`, `_invert_cdf` and `_select_at`.
The JAX package's one-hot MXU row fetches (`_fetch_stacked`) become plain
indexing here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_TINY = 1e-20
_BIG = 3e38


def _invert_cdf(cdf, u):
    """CDF inversion as masked reductions: (idx, lo, mass).

    cdf (..., K) nondecreasing, u broadcastable to cdf.shape[:-1].
    idx = count of cdf < u (strict), clipped to K-1; lo = largest value
    below u (0 if none); hi = smallest value at or above u (the last value
    if none); lo = min(lo, hi); mass = hi - lo.
    """
    below = cdf < u[..., None]
    idx = torch.clamp(below.sum(-1), 0, cdf.shape[-1] - 1)
    lo = torch.where(below, cdf, 0.0).amax(-1)
    hi = torch.where(below, _BIG, cdf).amin(-1)
    hi = torch.where(hi >= _BIG, cdf[..., -1].expand_as(hi), hi)
    lo = torch.minimum(lo, hi)
    return idx, lo, hi - lo


def _select_at(rows, idx):
    """rows (..., K) at per-lane idx (...) -> (...)."""
    return torch.gather(rows, -1, idx[..., None].long()).squeeze(-1)


class DiscreteDistribution(NamedTuple):
    """Normalized discrete distribution over K outcomes: one shared row, or
    a stack of rows (R, K) of which each lane names one (`row=`)."""

    pmf: torch.Tensor  # (K,) or (R, K)
    cdf: torch.Tensor  # (K,) or (R, K)

    @staticmethod
    def build(weights):
        w = torch.clamp(weights, min=0.0) + _TINY
        pmf = w / w.sum(-1, keepdim=True)
        return DiscreteDistribution(pmf=pmf, cdf=torch.cumsum(pmf, -1))

    def sample_reuse(self, u, row=None):
        """Sample an index and re-uniformize the used random number (per
        lane from stacked row `row` when given)."""
        cdf = self.cdf if row is None else self.cdf[row]
        idx, lo, p = _invert_cdf(cdf, u)
        u2 = torch.clamp((u - lo) / torch.clamp(p, min=_TINY), 0.0, 1.0 - 1e-7)
        return idx, u2

    def eval_pmf(self, idx, row=None):
        idx = torch.clamp(idx, 0, self.pmf.shape[-1] - 1)
        return self.pmf[idx] if row is None else self.pmf[row, idx]


class Marginal2D(NamedTuple):
    """Piecewise-constant 2-D density on the unit square, row-marginalized.

    pdf: (..., H, W); cdf_row: (..., H) marginal CDF over rows;
    cdf_cond: (..., H, W) conditional CDF within each row.
    """

    pdf: torch.Tensor
    cdf_row: torch.Tensor
    cdf_cond: torch.Tensor

    @staticmethod
    def build(weights):
        h, w_ = weights.shape[-2], weights.shape[-1]
        w = torch.clamp(weights, min=0.0) + _TINY
        row_mass = w.sum(-1)  # (..., H)
        total = row_mass.sum(-1, keepdim=True)  # (..., 1)
        pdf = w / total[..., None] * (h * w_)
        cdf_row = torch.cumsum(row_mass / total, -1)
        cdf_cond = torch.cumsum(
            w / torch.clamp(row_mass, min=_TINY)[..., None], -1
        )
        return Marginal2D(pdf=pdf, cdf_row=cdf_row, cdf_cond=cdf_cond)

"""Tabulated sampling distributions (1-D and 2-D CDF inversion).

PyTorch port of mitsuba_customization_tpu/core/distr.py:
`DiscreteDistribution`, `ContinuousDistribution`, `Marginal2D` (build,
gather_slice, sample, eval_pdf), `_invert_cdf` and `_select_at`.
The JAX package's one-hot MXU row fetches (`_fetch_stacked`) become plain
indexing here. A single 2-D Marginal2D (an envmap's, up to millions of
cells) inverts its CDFs by binary search over flat views and reads single
entries (`_search_cdf`), never a (lanes, W) row per lane; the result is
_invert_cdf's on nondecreasing rows.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mitsuba_customization_tpu_torch.core.math import gather_rows

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


def _search_cdf(flat, base, n, u):
    """_invert_cdf of the nondecreasing rows flat[base : base + n] (per-lane
    int64 base) at u by binary search: (idx, lo, mass), reading
    ceil(log2(n + 1)) + 2 entries a lane through index_select (gradients
    reach the two entries that bound u, as through the masked reduction)."""
    lo = torch.zeros_like(base)
    hi = torch.full_like(base, n)
    for _ in range(math.ceil(math.log2(n + 1))):
        live = lo < hi
        mid = (lo + hi) // 2
        less = gather_rows(flat, base + torch.clamp(mid, max=n - 1)) < u
        lo = torch.where(live & less, mid + 1, lo)
        hi = torch.where(live & ~less, mid, hi)
    idx = torch.clamp(lo, max=n - 1)
    v_hi = gather_rows(flat, base + idx)
    v_lo = torch.where(lo > 0, gather_rows(flat, base + torch.clamp(lo - 1, min=0)), 0.0)
    v_lo = torch.minimum(v_lo, v_hi)
    return idx, v_lo, v_hi - v_lo


def _select_at(rows, idx):
    """rows (..., K) at per-lane idx (...) -> (...)."""
    return torch.gather(rows, -1, idx[..., None].long()).squeeze(-1)


class DiscreteDistribution(NamedTuple):
    """Normalized discrete distribution over K outcomes: one shared row, or
    a stack of rows (R, K) of which each lane names one (`slice_=`)."""

    pmf: torch.Tensor  # (K,) or (R, K)
    cdf: torch.Tensor  # (K,) or (R, K)

    @staticmethod
    def build(weights):
        w = torch.clamp(weights, min=0.0) + _TINY
        pmf = w / w.sum(-1, keepdim=True)
        return DiscreteDistribution(pmf=pmf, cdf=torch.cumsum(pmf, -1))

    def sample_reuse(self, u, slice_=None):
        """Sample an index and re-uniformize the used random number (per
        lane from stacked row `slice_` when given)."""
        cdf = self.cdf if slice_ is None else self.cdf[slice_]
        idx, lo, p = _invert_cdf(cdf, u)
        u2 = torch.clamp((u - lo) / torch.clamp(p, min=_TINY), 0.0, 1.0 - 1e-7)
        return idx, u2

    def eval_pmf(self, idx, slice_=None):
        idx = torch.clamp(idx, 0, self.pmf.shape[-1] - 1)
        return self.pmf[idx] if slice_ is None else self.pmf[slice_, idx]


class ContinuousDistribution(NamedTuple):
    """Piecewise-constant density on [0, 1) over K cells: pdf (..., K)
    density values, cdf (..., K) inclusive cumulative cell masses."""

    pdf: torch.Tensor
    cdf: torch.Tensor

    @staticmethod
    def build(weights):
        k = weights.shape[-1]
        w = torch.clamp(weights, min=0.0) + _TINY
        mass = w / w.sum(-1, keepdim=True)
        return ContinuousDistribution(pdf=mass * k, cdf=torch.cumsum(mass, -1))

    def sample(self, u):
        """u in [0,1) -> x in [0,1), uniform within its cell."""
        k = self.pdf.shape[-1]
        idx, lo, mass = _invert_cdf(self.cdf, u)
        frac = torch.clamp((u - lo) / torch.clamp(mass, min=_TINY), 0.0, 1.0 - 1e-7)
        return (idx.to(torch.float32) + frac) / k

    def eval_pdf(self, x):
        k = self.pdf.shape[-1]
        idx = torch.clamp((x * k).long(), 0, k - 1)
        if self.pdf.dim() == 1:
            return self.pdf[idx]
        return _select_at(self.pdf.expand(idx.shape + self.pdf.shape[-1:]), idx)


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

    def gather_slice(self, idx):
        """Per-lane tables from a stack (materializes (lanes, H, W); the
        lazy `slice_` of sample / eval_pdf does not)."""
        return Marginal2D(*(f[idx] for f in self))

    def _cond_rows(self, slice_, row):
        """The conditional CDF row `row` of each lane's table (..., W)."""
        h = self.cdf_cond.shape[-2]
        if slice_ is not None:
            return self.cdf_cond[slice_ + (row,)]
        if self.cdf_cond.dim() == 2:
            return self.cdf_cond[row.clamp(0, h - 1)]
        cond = self.cdf_cond.expand(row.shape + self.cdf_cond.shape[-2:])
        return torch.gather(cond, -2, row[..., None, None].expand(
            row.shape + (1, cond.shape[-1]))).squeeze(-2)

    def sample(self, sample2, slice_=None):
        """sample2 (..., 2) in [0,1)^2 -> ((..., 2) position (y, x), pdf).
        slice_: a tuple of per-lane indices into the leading stack axes."""
        h, w = self.pdf.shape[-2], self.pdf.shape[-1]
        u_row, u_col = sample2[..., 0], sample2[..., 1]
        if slice_ is None and self.cdf_cond.dim() == 2:  # one table: search
            zero = torch.zeros(u_row.shape, dtype=torch.int64, device=u_row.device)
            row, row_lo, row_mass = _search_cdf(self.cdf_row, zero, h, u_row)
            col, col_lo, col_mass = _search_cdf(self.cdf_cond.reshape(-1), row * w, w, u_col)
        else:
            cdf_row = self.cdf_row if slice_ is None else self.cdf_row[slice_]
            row, row_lo, row_mass = _invert_cdf(cdf_row, u_row)
            col, col_lo, col_mass = _invert_cdf(self._cond_rows(slice_, row), u_col)
        dy = torch.clamp((u_row - row_lo) / torch.clamp(row_mass, min=_TINY),
                         0.0, 1.0 - 1e-7)
        dx = torch.clamp((u_col - col_lo) / torch.clamp(col_mass, min=_TINY),
                         0.0, 1.0 - 1e-7)
        y = (row.to(torch.float32) + dy) / h
        x = (col.to(torch.float32) + dx) / w
        return torch.stack([y, x], -1), row_mass * col_mass * (h * w)

    def eval_pdf(self, pos, slice_=None):
        """Density at pos (..., 2) = (y, x), from the CDF differences at
        its cell."""
        h, w = self.pdf.shape[-2], self.pdf.shape[-1]
        row = torch.clamp((pos[..., 0] * h).long(), 0, h - 1)
        col = torch.clamp((pos[..., 1] * w).long(), 0, w - 1)
        if slice_ is None and self.cdf_cond.dim() == 2:
            def mass(flat, base, i):
                return gather_rows(flat, base + i) - torch.where(
                    i > 0, gather_rows(flat, base + torch.clamp(i - 1, min=0)), 0.0)

            cond = self.cdf_cond.reshape(-1)
            return mass(self.cdf_row, 0, row) * mass(cond, row * w, col) * (h * w)
        cdf_row = self.cdf_row if slice_ is None else self.cdf_row[slice_]
        cdf_row = cdf_row.expand(row.shape + cdf_row.shape[-1:])
        row_mass = _select_at(cdf_row, row) - torch.where(
            row > 0, _select_at(cdf_row, (row - 1).clamp(min=0)), 0.0)
        cond = self._cond_rows(slice_, row)
        col_mass = _select_at(cond, col) - torch.where(
            col > 0, _select_at(cond, (col - 1).clamp(min=0)), 0.0)
        return row_mass * col_mass * (h * w)

"""Chi-square goodness-of-fit harness for sampling routines.

A copy of mitsuba_customization_tpu/utils/chi2.py (numpy and scipy only;
the port imports nothing of the JAX package), the counterpart of mitsuba3
python/python/chi2.py (ChiSquareTest, SphericalDomain, PlanarDomain): a
histogram of sample() draws is tested against the numerically integrated
pdf() with a Pearson chi^2 test and a Sidak-corrected significance. The
functors take and return numpy arrays; wrap a torch sampler with
`.numpy()` / `torch.as_tensor` at the boundary.
"""

from __future__ import annotations

import numpy as np
from scipy.stats import chi2 as _chi2_dist


class SphericalDomain:
    """Full sphere parameterized by (cos(theta), phi) — constant Jacobian.

    Matches mitsuba3 chi2.SphericalDomain: histogram coordinates are
    x = phi in [-pi, pi], y = cos(theta) in [-1, 1]; d(omega) = dy dx.
    """

    bounds = np.array([[-np.pi, np.pi], [-1.0, 1.0]])
    aspect = 2

    def map_forward(self, d):
        """Direction (N, 3) -> (N, 2) histogram coordinates."""
        d = np.asarray(d)
        return np.stack(
            [np.arctan2(d[..., 1], d[..., 0]), np.clip(d[..., 2], -1, 1)], axis=-1
        )

    def map_backward(self, p):
        """Histogram coordinates (N, 2) -> direction (N, 3)."""
        phi, cos_theta = p[..., 0], p[..., 1]
        sin_theta = np.sqrt(np.maximum(0.0, 1.0 - cos_theta**2))
        return np.stack(
            [sin_theta * np.cos(phi), sin_theta * np.sin(phi), cos_theta], axis=-1
        )


class PlanarDomain:
    """Axis-aligned planar domain (for 2-D warps like the concentric disk)."""

    def __init__(self, bounds):
        self.bounds = np.asarray(bounds, dtype=np.float64)
        ext = self.bounds[:, 1] - self.bounds[:, 0]
        self.aspect = ext[0] / ext[1]

    def map_forward(self, p):
        return np.asarray(p)

    def map_backward(self, p):
        return np.asarray(p)


class ChiSquareTest:
    """Pearson chi^2 test of sample() against numerically integrated pdf().

    Parameters mirror mitsuba3's ChiSquareTest: `domain`, a
    `sample_functor(sample2) -> points` (may also return (points, weight/
    valid mask)), a `pdf_functor(points) -> density` in domain measure,
    `sample_count`, histogram `res`, and `ires` sub-integration resolution.
    """

    def __init__(
        self,
        domain,
        sample_functor,
        pdf_functor,
        sample_count=1_000_000,
        res=101,
        ires=8,
        seed=0,
    ):
        self.domain = domain
        self.sample_functor = sample_functor
        self.pdf_functor = pdf_functor
        self.sample_count = int(sample_count)
        self.res = int(res)
        self.ires = int(ires)
        self.seed = seed
        self.histogram = None
        self.pdf = None
        self.messages = []

    def tabulate_histogram(self):
        rng = np.random.default_rng(self.seed)
        u = rng.random((self.sample_count, 2), dtype=np.float64)
        out = self.sample_functor(u.astype(np.float32))
        weight = None
        if isinstance(out, tuple):
            out, weight = out
        p = self.domain.map_forward(np.asarray(out, dtype=np.float64))
        b = self.domain.bounds
        res_y = self.res
        res_x = int(self.res * self.domain.aspect)
        eps_x = (b[0, 1] - b[0, 0]) * 1e-9
        eps_y = (b[1, 1] - b[1, 0]) * 1e-9
        x = np.clip(p[..., 0], b[0, 0], b[0, 1] - eps_x)
        y = np.clip(p[..., 1], b[1, 0], b[1, 1] - eps_y)
        ix = ((x - b[0, 0]) / (b[0, 1] - b[0, 0]) * res_x).astype(np.int64)
        iy = ((y - b[1, 0]) / (b[1, 1] - b[1, 0]) * res_y).astype(np.int64)
        flat = iy * res_x + ix
        if weight is None:
            weight = np.ones(len(flat))
        else:
            weight = np.asarray(weight, dtype=np.float64)
        self.histogram = np.bincount(
            flat, weights=weight, minlength=res_y * res_x
        ).reshape(res_y, res_x)
        self.res_x, self.res_y = res_x, res_y

    def tabulate_pdf(self):
        """Numerically integrate pdf over each histogram cell (midpoint rule
        on an ires x ires sub-grid), scaled to expected counts."""
        b = self.domain.bounds
        res_x, res_y = self.res_x, self.res_y
        ix = (np.arange(res_x * self.ires) + 0.5) / (res_x * self.ires)
        iy = (np.arange(res_y * self.ires) + 0.5) / (res_y * self.ires)
        xs = b[0, 0] + ix * (b[0, 1] - b[0, 0])
        ys = b[1, 0] + iy * (b[1, 1] - b[1, 0])
        xg, yg = np.meshgrid(xs, ys)  # (resy*ires, resx*ires)
        pts = np.stack([xg.ravel(), yg.ravel()], axis=-1)
        dirs = self.domain.map_backward(pts)
        dens = np.asarray(
            self.pdf_functor(dirs.astype(np.float32)), dtype=np.float64
        ).reshape(yg.shape)
        cell_area = ((b[0, 1] - b[0, 0]) / res_x) * ((b[1, 1] - b[1, 0]) / res_y)
        sub = dens.reshape(res_y, self.ires, res_x, self.ires).mean(axis=(1, 3))
        self.pdf = sub * cell_area * self.sample_count

    def run(self, significance_level=0.01, test_count=1):
        """Returns True if the sampler is consistent with the pdf.

        `test_count` applies a Sidak correction when this is one of several
        simultaneous tests (as mitsuba3 does per BSDF test file).
        """
        if self.histogram is None:
            self.tabulate_histogram()
        if self.pdf is None:
            self.tabulate_pdf()

        # Integrated density should match the sample count (within MC noise):
        # catches pdf() normalization bugs even when shapes agree.
        integral = self.pdf.sum()
        count = self.histogram.sum()
        if integral > 0 and abs(integral - count) / max(count, 1) > 0.05:
            self.messages.append(
                f"pdf integrates to {integral:.1f} but {count:.0f} samples "
                f"drawn — normalization mismatch"
            )
            return False

        obs = self.histogram.ravel()
        exp = self.pdf.ravel()
        order = np.argsort(exp)
        obs, exp = obs[order], exp[order]
        # Pool cells with expected count < 5 (standard Pearson validity rule,
        # same pooling as mitsuba3 chi2.py).
        pooled_obs, pooled_exp = [], []
        acc_o = acc_e = 0.0
        for o, e in zip(obs, exp):
            acc_o += o
            acc_e += e
            if acc_e >= 5.0:
                pooled_obs.append(acc_o)
                pooled_exp.append(acc_e)
                acc_o = acc_e = 0.0
        if acc_e > 0 and pooled_exp:
            pooled_obs[-1] += acc_o
            pooled_exp[-1] += acc_e
        pooled_obs = np.array(pooled_obs)
        pooled_exp = np.array(pooled_exp)
        dof = len(pooled_obs) - 1
        if dof <= 0:
            self.messages.append("degenerate test: too few cells")
            return False
        stat = np.sum((pooled_obs - pooled_exp) ** 2 / pooled_exp)
        p_value = _chi2_dist.sf(stat, dof)
        alpha = 1.0 - (1.0 - significance_level) ** (1.0 / test_count)
        self.p_value = p_value
        self.messages.append(
            f"chi2 stat={stat:.2f} dof={dof} p={p_value:.4g} alpha={alpha:.4g}"
        )
        return bool(p_value > alpha)

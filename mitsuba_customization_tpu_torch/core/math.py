"""Vector math and numeric helpers.

PyTorch port of mitsuba_customization_tpu/core/math.py. All functions are
elementwise over leading axes; 3-vectors are tensors of shape (..., 3).
No matmul is used, so TF32 never applies.
"""

from __future__ import annotations

import torch

EPSILON = 1e-7
RAY_EPSILON = 1e-4  # min-t offset used to avoid self-intersection
ONE_MINUS_EPSILON = 1.0 - 2.0 ** -24  # the largest float32 below 1
INF = float("inf")


def safe_sqrt(x):
    """sqrt clamped to zero below."""
    return torch.sqrt(torch.clamp(x, min=0.0))


def safe_acos(x):
    return torch.arccos(torch.clamp(x, -1.0, 1.0))


def safe_asin(x):
    return torch.arcsin(torch.clamp(x, -1.0, 1.0))


def safe_div(a, b, default=0.0):
    """a/b with a zero denominator guarded (returns `default` there)."""
    zero = b == 0.0
    b_safe = torch.where(zero, torch.ones_like(b), b)
    return torch.where(zero, default, a / b_safe)


def safe_rsqrt(x):
    return torch.rsqrt(torch.clamp(x, min=EPSILON * EPSILON))


def dot(a, b):
    """Dot product over the last axis."""
    return (a * b).sum(-1)


def dot_keep(a, b):
    return (a * b).sum(-1, keepdim=True)


def abs_dot(a, b):
    return dot(a, b).abs()


def squared_norm(v):
    return (v * v).sum(-1)


def lerp(a, b, t):
    return a * (1.0 - t) + b * t


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def norm(v):
    return torch.sqrt((v * v).sum(-1))


def normalize(v):
    """Normalize over the last axis; zero vectors map to zero."""
    # rsqrt: on the CPU it rounds as 1/sqrt does in numpy and XLA, which
    # torch.sqrt does not always (acos of a normalized component magnifies
    # a 1-ulp difference near the poles)
    return v * safe_rsqrt((v * v).sum(-1, keepdim=True))


def sign(x):
    """Sign that maps 0 -> +1."""
    return torch.where(x >= 0.0, 1.0, -1.0)


def sph_to_dir(theta, phi):
    """Spherical (theta from +z, phi from +x) to unit vector (..., 3)."""
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    return torch.stack([st * cp, st * sp, ct], -1)


def dir_to_sph(d):
    """Unit vector to (theta, phi); phi in (-pi, pi]."""
    theta = safe_acos(d[..., 2])
    phi = torch.atan2(d[..., 1], d[..., 0])
    return theta, phi


def coordinate_system(n):
    """Orthonormal basis (s, t) around unit normal n (Duff et al. 2017)."""
    z = n[..., 2]
    s = sign(z)
    a = -1.0 / (s + z)
    b = n[..., 0] * n[..., 1] * a
    x = torch.stack(
        [1.0 + s * n[..., 0] * n[..., 0] * a, s * b, -s * n[..., 0]], -1
    )
    y = torch.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], -1)
    return x, y


def mulsign(value, s):
    """value * sign(s), with sign(0) = +1."""
    return torch.where(s >= 0.0, value, -value)


def reflect(w):
    """Reflect w about the shading frame's +z axis."""
    return torch.stack([-w[..., 0], -w[..., 1], w[..., 2]], -1)


def refract(wi, cos_theta_t, eta_ti):
    """wi refracted about +z, given the transmitted cosine and 1/eta."""
    return torch.stack([-eta_ti * wi[..., 0], -eta_ti * wi[..., 1], cos_theta_t], -1)


def cos_theta(w):
    return w[..., 2]


def cos_theta2(w):
    return w[..., 2] * w[..., 2]


def abs_cos_theta(w):
    return w[..., 2].abs()


def sin_theta2(w):
    return torch.clamp(1.0 - w[..., 2] * w[..., 2], min=0.0)


def sin_theta(w):
    return torch.sqrt(sin_theta2(w))


def tan_theta(w):
    return safe_div(sin_theta(w), cos_theta(w))


def tan_theta2(w):
    return safe_div(sin_theta2(w), cos_theta2(w))


def sin_phi(w):
    s = sin_theta(w)
    return torch.where(s == 0.0, 0.0, torch.clamp(safe_div(w[..., 1], s), -1.0, 1.0))


def cos_phi(w):
    s = sin_theta(w)
    return torch.where(s == 0.0, 1.0, torch.clamp(safe_div(w[..., 0], s), -1.0, 1.0))


def gather_rows(t, idx):
    """t[idx] for a per-lane int64 index tensor of any shape, through
    index_select: its backward is one index_add_, where advanced indexing's
    sorts the indices first."""
    return t.index_select(0, idx.reshape(-1)).reshape(idx.shape + t.shape[1:])

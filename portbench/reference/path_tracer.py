"""Plain PyTorch reference of the port's path integrator, for the
benchmark's check of what a timed frame produced.

It renders chosen pixels of a scene dict (triangle meshes and rectangles;
MERL-format tabulated, GGX rough-conductor and diffuse materials; area and
constant emitters; a perspective camera; the box filter) with the same
integrator, drawing the same uniforms: the independent sampler's
counter-based hash of (seed, lane, dimension), the path tracer's
dimension layout, next-event estimation with the power heuristic, the
luminance-weighted half-vector sampling of a tabulated BRDF mixed with a
cosine lobe, GGX visible-normal sampling and Russian roulette. Every
quantity the program derives from the scene (transforms, normals, the
emitters' pmfs, the tables' sampling CDFs) is worked out here again from
the dict, and rays are intersected by brute force over every triangle,
so nothing of the program's acceleration structures, kernels or layouts
is read. It imports nothing of the program.

A frame's wavefront compaction moves live lanes to a prefix and thins
them only where they outgrow a bounce's capacity; the reference traces
every lane to its end, which is the program's result wherever no lane is
thinned (a configuration's schedule keeps every capacity above the live
lanes). Thinning draws survivors by their rank among all of a pass's live
lanes, so one lane that rounds the other way at bounce 0 reorders the
survivors of the whole pass: no per-pixel reference can follow it.

`dtype` sets the precision of every floating-point step (float32 is the
program's; the benchmark's control runs bfloat16).
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
HALF_PI = math.pi / 2.0
INV_PI = 1.0 / math.pi
RAY_EPSILON = 1e-4
SHADOW_INF = 1e30
CAMERA_DIMS, BOUNCE_DIMS, OFF_NEE = 4, 8, 4
COSINE_MIX = 0.1
N_THETA_I, RES_H, RES_PHI = 32, 32, 64
TINY = 1e-20
DEFAULT_ETA = (0.2004, 0.9240, 1.1022)
DEFAULT_K = (3.9129, 2.4528, 2.1421)
GGX, DIFFUSE, MERL, NULL = 0, 1, 2, 3


# ---------------------------------------------------------------- hashing
def _mul32(x, c):
    return ((x * (c & 0xFFFF)) + (((x * (c >> 16)) & 0xFFFF) << 16)) & MASK32


def _hash_u32(x):
    x = x & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _hash_combine(a, b):
    a, b = a & MASK32, b & MASK32
    return _hash_u32(a ^ ((b + 0x9E3779B9 + ((a << 6) & MASK32) + (a >> 2)) & MASK32))


class _Uniforms:
    """The independent sampler's stream of one set of lanes: draw(dim) =
    the top 24 bits of hash(hash(seed, lane), dim) over 2^24."""

    def __init__(self, seed, lane, dtype):
        self.key = _hash_combine(torch.full_like(lane, int(seed) & MASK32), lane & MASK32)
        self.dtype = dtype

    def draw(self, dim, rows=None):
        key = self.key if rows is None else self.key[rows]
        bits = _hash_combine(key, torch.full_like(key, dim))
        return ((bits >> 8).to(torch.float32) * (1.0 / (1 << 24))).to(self.dtype)


# ---------------------------------------------------------------- vectors
def _dot(a, b):
    return (a * b).sum(-1)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _normalize(v):
    return v * torch.rsqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=1e-14))


def _safe_div(a, b):
    zero = b == 0.0
    return torch.where(zero, torch.zeros_like(a), a / torch.where(zero, torch.ones_like(b), b))


def _sph_to_dir(theta, phi):
    st = torch.sin(theta)
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), torch.cos(theta)], -1)


def _dir_to_sph(d):
    return torch.arccos(torch.clamp(d[..., 2], -1.0, 1.0)), torch.atan2(d[..., 1], d[..., 0])


def _rotate_z(v, angle):
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack([c * v[..., 0] - s * v[..., 1], s * v[..., 0] + c * v[..., 1],
                        v[..., 2]], -1)


def _rotate_y(v, angle):
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack([c * v[..., 0] + s * v[..., 2], v[..., 1],
                        -s * v[..., 0] + c * v[..., 2]], -1)


def _basis(n):
    """An orthonormal (s, t) around unit n (Duff et al. 2017)."""
    sgn = torch.where(n[..., 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sgn + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    s = torch.stack([1.0 + sgn * n[..., 0] * n[..., 0] * a, sgn * b, -sgn * n[..., 0]], -1)
    t = torch.stack([b, sgn + n[..., 1] * n[..., 1] * a, -n[..., 1]], -1)
    return s, t


def _cosine_hemisphere(u):
    """Concentric disk (Shirley-Chiu) lifted to the hemisphere."""
    x, y = 2.0 * u[..., 0] - 1.0, 2.0 * u[..., 1] - 1.0
    zero = (x == 0.0) & (y == 0.0)
    qx = x.abs() > y.abs()
    r = torch.where(qx, x, y)
    ratio = torch.where(qx, torch.where(x != 0.0, y / torch.where(x == 0.0, 1.0, x), 0.0),
                        torch.where(y != 0.0, x / torch.where(y == 0.0, 1.0, y), 0.0))
    phi = torch.where(qx, (math.pi / 4.0) * ratio, (math.pi / 2.0) - (math.pi / 4.0) * ratio)
    r = torch.where(zero, 0.0, r)
    px, py = r * torch.cos(phi), r * torch.sin(phi)
    return torch.stack([px, py, torch.sqrt(torch.clamp(1.0 - px * px - py * py, min=0.0))], -1)


def _mis(a, b):
    a2 = a * a
    return torch.where(a > 0.0, _safe_div(a2, a2 + b * b), 0.0)


def _invert_cdf(cdf, u):
    """(index, lower CDF value, cell mass) of u in nondecreasing rows."""
    below = cdf < u[..., None]
    idx = torch.clamp(below.sum(-1), 0, cdf.shape[-1] - 1)
    lo = torch.where(below, cdf, 0.0).amax(-1)
    hi = torch.where(below, 3e38, cdf).amin(-1)
    hi = torch.where(hi >= 3e38, cdf[..., -1].expand_as(hi), hi)
    lo = torch.minimum(lo, hi)
    return idx, lo, hi - lo


def _take(rows, idx):
    return torch.gather(rows, -1, idx[..., None]).squeeze(-1)


# ---------------------------------------------------------------- the scene
def _unit_cube():
    """[-1, 1]^3 as 12 triangles, outward (Mitsuba 3's cube)."""
    verts, faces = [], []
    for axis in range(3):
        for sgn in (-1.0, 1.0):
            base = len(verts)
            u_ax, v_ax = (axis + 1) % 3, (axis + 2) % 3
            for du, dv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                p = [0.0, 0.0, 0.0]
                p[axis], p[u_ax], p[v_ax] = sgn, du * sgn, dv
                verts.append(p)
            faces += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    return np.asarray(verts, np.float32), np.asarray(faces, np.int64)


def _transform(t):
    """A 4x4 array, or {scale, rotate, translate} applied in that order."""
    if not isinstance(t, dict):
        return np.eye(4, dtype=np.float32) if t is None else np.asarray(t, np.float32)
    mat = np.eye(4)
    if "scale" in t:
        s = np.asarray(t["scale"], np.float64)
        mat = np.diag(np.append(np.full(3, s) if s.ndim == 0 else s, 1.0)) @ mat
    if "rotate" in t:
        x, y, z = np.asarray(t["rotate"]["axis"], np.float64) / np.linalg.norm(
            t["rotate"]["axis"])
        a = np.deg2rad(t["rotate"]["angle"])
        c, s_ = np.cos(a), np.sin(a)
        r = np.eye(4)
        r[:3, :3] = [[c + x * x * (1 - c), x * y * (1 - c) - z * s_, x * z * (1 - c) + y * s_],
                     [y * x * (1 - c) + z * s_, c + y * y * (1 - c), y * z * (1 - c) - x * s_],
                     [z * x * (1 - c) - y * s_, z * y * (1 - c) + x * s_, c + z * z * (1 - c)]]
        mat = r @ mat
    if "translate" in t:
        tr = np.eye(4)
        tr[:3, 3] = t["translate"]
        mat = tr @ mat
    return mat.astype(np.float32)


class Scene:
    """A scene dict's prims, materials, emitters and camera as tensors of
    `dtype` on `device`.

    Prims are the triangles of the shapes in the dict's order (a rectangle
    two of the unit square, a cube twelve of the unit cube; a mesh keeps
    its vertex normals, a shape without them takes area-weighted ones),
    then its spheres. A shape's "interior" medium is kept a prim (its
    index among the dict's media in shape order, -1 for none) with the
    medium's dict (`media`); a null material makes a prim that only
    bounds media: it never occludes a shadow ray."""

    def __init__(self, d, device, dtype=torch.float32, params=None):
        self.device, self.dtype = device, dtype
        params = params or {}
        rows = {k: [] for k in ("p0", "e1", "e2", "n0", "n1", "n2", "mat", "emitter",
                                "interior")}
        spheres = {k: [] for k in ("center", "radius", "mat", "interior")}
        self.materials, tables, lights, self.media = [], [], [], []
        self.sky = np.zeros(3, np.float32)
        for key, val in d.items():
            if not isinstance(val, dict) or key in ("integrator", "sensor"):
                continue
            kind = val.get("type")
            if kind == "constant":
                self.sky = np.asarray(val["radiance"], np.float32)
                continue
            if kind not in ("rectangle", "mesh", "cube", "sphere"):
                raise ValueError(f"reference: unsupported entry {key!r} of type {kind!r}")
            mat = self._material(val.get("bsdf", {"type": "diffuse"}), tables)
            interior = -1
            if "interior" in val:
                self.media.append(val["interior"])
                interior = len(self.media) - 1
            to_w = _transform(val.get("to_world"))
            if kind == "sphere":
                c = np.asarray(val.get("center", [0, 0, 0]), np.float64)
                spheres["center"].append(c @ to_w[:3, :3].T + to_w[:3, 3])
                spheres["radius"].append(float(val.get("radius", 1.0))
                                         * np.cbrt(abs(np.linalg.det(to_w[:3, :3]))))
                spheres["mat"].append(mat)
                spheres["interior"].append(interior)
                continue
            if kind == "rectangle":
                v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
                f = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
                n = None
            elif kind == "cube":
                v, f = _unit_cube()
                n = None
            else:
                v = np.asarray(val["vertices"], np.float32)
                f = np.asarray(val["faces"], np.int64)
                n = val.get("normals")
            v = (v.astype(np.float64) @ to_w[:3, :3].T + to_w[:3, 3]).astype(np.float32)
            if n is None:
                n = np.zeros_like(v)
                fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
                for k in range(3):
                    np.add.at(n, f[:, k], fn)
            else:
                n = np.asarray(n, np.float32) @ np.linalg.inv(to_w[:3, :3]).T.T
            n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
            first = sum(len(r) for r in rows["p0"])
            p0 = v[f[:, 0]]
            for name, arr in (("p0", p0), ("e1", v[f[:, 1]] - p0), ("e2", v[f[:, 2]] - p0),
                              ("n0", n[f[:, 0]]), ("n1", n[f[:, 1]]), ("n2", n[f[:, 2]])):
                rows[name].append(arr.astype(np.float32))
            rows["mat"].append(np.full(len(f), mat))
            rows["interior"].append(np.full(len(f), interior))
            if "emitter" in val:
                if val["emitter"].get("type") != "area":
                    raise ValueError("reference: only area shape emitters")
                lights.append((np.asarray(val["emitter"]["radiance"], np.float32),
                               np.arange(first, first + len(f))))
                rows["emitter"].append(np.full(len(f), len(lights) - 1))
            else:
                rows["emitter"].append(np.full(len(f), -1))
        cat = {k: np.concatenate(v) for k, v in rows.items()}
        self.prims = {k: self._t(cat[k]) for k in ("p0", "e1", "e2", "n0", "n1", "n2")}
        self.n_tris = len(cat["mat"])
        self.n_spheres = len(spheres["mat"])
        self.sphere_center = self._t(np.reshape(spheres["center"], (-1, 3)))
        self.sphere_radius = self._t(np.asarray(spheres["radius"]))
        self.mat = torch.as_tensor(np.concatenate([cat["mat"], spheres["mat"]]).astype(np.int64),
                                   device=device)
        self.emitter = torch.as_tensor(np.concatenate(
            [cat["emitter"], np.full(self.n_spheres, -1)]).astype(np.int64), device=device)
        self.interior = torch.as_tensor(np.concatenate(
            [cat["interior"], spheres["interior"]]).astype(np.int64), device=device)
        self.n_prims = self.n_tris + self.n_spheres
        ids, lo, hi = _groups(cat["p0"], cat["e1"], cat["e2"])
        self.group_ids = torch.as_tensor(ids, device=device)
        self.group_lo = torch.as_tensor(lo, dtype=torch.float32, device=device)
        self.group_hi = torch.as_tensor(hi, dtype=torch.float32, device=device)
        self._lights(lights, cat)
        self._camera(d["sensor"])
        self.max_depth = int(d["integrator"].get("max_depth", 5))
        self.rr_depth = int(d["integrator"].get("rr_depth", 5))
        self.mat_kind = torch.as_tensor([m[0] for m in self.materials], device=device)
        self.mat_slot = torch.as_tensor([m[1] for m in self.materials], device=device)
        # prims that stop a shadow ray: all but those of a null material
        self.occludes = self.mat_kind[self.mat] != NULL
        self.ggx = [m[2] for m in self.materials if m[0] == GGX]
        self.diffuse = [m[2] for m in self.materials if m[0] == DIFFUSE]
        # the differentiable values: the scene's own, or the caller's
        # tensors (keys as the program names them), which gradients reach
        for i, p in enumerate(self.ggx):
            for key, field in (("bsdf.roughconductor.alpha_u", "au"),
                               ("bsdf.roughconductor.alpha_v", "av")):
                p[field] = params[key][i] if key in params else self._t(p[field])
        if tables:
            self.tables = params.get("bsdf.tabulated.table", None)
            if self.tables is None:
                self.tables = self._t(np.stack(tables))
            self.cdf_row, self.cdf_cond = zip(*(self._sampling(t.detach())
                                                for t in self.tables))
            self.cdf_row, self.cdf_cond = torch.stack(self.cdf_row), torch.stack(self.cdf_cond)

    def _t(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device).to(self.dtype)

    def _material(self, bd, tables):
        kind = bd.get("type")
        if kind == "merl":
            tables.append(np.asarray(bd["table"], np.float32))
            self.materials.append((MERL, len(tables) - 1, None))
        elif kind == "roughconductor" and bd.get("distribution", "ggx") == "ggx":
            a = float(bd.get("alpha", 0.1))
            params = dict(au=float(bd.get("alpha_u", a)), av=float(bd.get("alpha_v", a)),
                          eta=bd.get("eta", DEFAULT_ETA), k=bd.get("k", DEFAULT_K),
                          spec=bd.get("specular_reflectance", [1.0, 1.0, 1.0]))
            self.materials.append((GGX, len(self.ggx_rows()), params))
        elif kind == "null":
            self.materials.append((NULL, 0, None))
        elif kind == "diffuse":
            refl = bd.get("reflectance", [0.5, 0.5, 0.5])
            self.materials.append((DIFFUSE, len(self.diffuse_rows()),
                                   dict(refl=np.full(3, refl, np.float32))))
        else:
            raise ValueError(f"reference: unsupported material {kind!r}")
        return len(self.materials) - 1

    def ggx_rows(self):
        return [m for m in self.materials if m[0] == GGX]

    def diffuse_rows(self):
        return [m for m in self.materials if m[0] == DIFFUSE]

    def _lights(self, lights, cat):
        """Area lights with a pmf over their prims by area; uniform
        selection over them (the constant sky is left to BSDF sampling
        where area lights exist, and then gets NEE density 0)."""
        if not lights or len(lights) > 1:
            raise ValueError("reference: exactly one area light")
        radiance, prims = lights[0]
        area = 0.5 * np.linalg.norm(np.cross(cat["e1"][prims], cat["e2"][prims]), axis=-1)
        area = area.astype(np.float32)
        pmf = (area / area.sum()).astype(np.float32)
        self.light_radiance = self._t(radiance)
        self.light_prims = torch.as_tensor(prims, device=self.device)
        self.light_area = self._t(area)
        self.light_pmf = self._t(pmf)
        self.light_cdf = self._t(np.cumsum(pmf, dtype=np.float32))
        self.prim_light_row = torch.full((self.n_prims,), -1, dtype=torch.int64,
                                         device=self.device)
        self.prim_light_row[self.light_prims] = torch.arange(len(prims), device=self.device)

    def _camera(self, s):
        if s.get("type", "perspective") != "perspective":
            raise ValueError("reference: perspective camera only")
        film = s["film"]
        self.width, self.height = int(film["width"]), int(film["height"])
        self.spp = int(s["sampler"]["sample_count"])
        to_w = _transform(s.get("to_world"))
        self.cam_rot = self._t(to_w[:3, :3])
        self.cam_pos = self._t(to_w[:3, 3])
        self.tan_half = torch.tan(self._t(float(s.get("fov", 45.0))) * (math.pi / 180.0) * 0.5)
        self.near_clip = float(s.get("near_clip", 1e-3))

    # ------------------------------------------------------ MERL sampling
    def _sampling(self, table):
        """One table's half-vector sampling CDFs: for each of N_THETA_I
        incident-angle bins (phi_i = 0), the luminance of f over a
        (theta_h = pi/2 y^2, phi_h) grid times the Jacobian to solid angle
        at wo, as a row-marginal 2-D distribution."""
        dt, dev = self.dtype, self.device
        ti = (torch.arange(N_THETA_I, device=dev).to(dt) + 0.5) / N_THETA_I * HALF_PI
        yy = (torch.arange(RES_H, device=dev).to(dt) + 0.5) / RES_H
        xx = (torch.arange(RES_PHI, device=dev).to(dt) + 0.5) / RES_PHI
        ti_g, y_g, x_g = torch.meshgrid(ti, yy, xx, indexing="ij")
        wi = _sph_to_dir(ti_g, torch.zeros_like(ti_g))
        h, jac = _halfvec(y_g, x_g)
        wo = 2.0 * (wi * h).sum(-1, keepdim=True) * h - wi
        f = _merl_raw(table, wi, wo)
        lum = f[..., 0] * 0.212671 + f[..., 1] * 0.715160 + f[..., 2] * 0.072169
        w = torch.where(wo[..., 2] > 0.0, lum * jac * 4.0 * _dot(wo, h).abs(), 0.0)
        w = torch.clamp(w, min=0.0) + TINY
        row_mass = w.sum(-1)
        total = row_mass.sum(-1, keepdim=True)
        return (torch.cumsum(row_mass / total, -1),
                torch.cumsum(w / torch.clamp(row_mass, min=TINY)[..., None], -1))


def scene_of(d, device, dtype=torch.float32, params=None):
    """The Scene of dict `d` (the references' common entry)."""
    return Scene(d, device, dtype, params)


def _halfvec(y, x):
    theta_h = HALF_PI * y * y
    return (_sph_to_dir(theta_h, 2.0 * math.pi * x - math.pi),
            2.0 * math.pi * math.pi * y * torch.sin(theta_h))


def _merl_raw(table, wi, wo, slot=None):
    """Trilinear f(wi, wo) of a MERL table over (sqrt-warped theta_h,
    theta_d, phi_d mod pi), clamped at 0, zero below either horizon."""
    h = _normalize(wi + wo)
    theta_h, phi_h = _dir_to_sph(h)
    theta_d, phi_d = _dir_to_sph(_rotate_y(_rotate_z(wi, -phi_h), -theta_h))
    n_th, n_td, n_pd = table.shape[-4], table.shape[-3], table.shape[-2]
    u_th = torch.sqrt(torch.clamp(theta_h / HALF_PI, min=0.0)) * n_th - 0.5
    u_td = theta_d / HALF_PI * n_td - 0.5
    u_pd = torch.where(phi_d < 0.0, phi_d + math.pi, phi_d) / math.pi * n_pd - 0.5
    i0, j0, k0 = (torch.floor(u).long() for u in (u_th, u_td, u_pd))
    fth, ftd, fpd = ((u - i)[..., None] for u, i in ((u_th, i0), (u_td, j0), (u_pd, k0)))
    ii = (i0.clamp(0, n_th - 1), (i0 + 1).clamp(0, n_th - 1))
    jj = (j0.clamp(0, n_td - 1), (j0 + 1).clamp(0, n_td - 1))
    kk = (k0 % n_pd, (k0 + 1) % n_pd)

    def at(a, b, c):
        return table[ii[a], jj[b], kk[c]] if slot is None else table[slot, ii[a], jj[b], kk[c]]

    def mix_k(a, b):
        return at(a, b, 0) * (1.0 - fpd) + at(a, b, 1) * fpd

    c0 = mix_k(0, 0) * (1.0 - ftd) + mix_k(0, 1) * ftd
    c1 = mix_k(1, 0) * (1.0 - ftd) + mix_k(1, 1) * ftd
    val = c0 * (1.0 - fth) + c1 * fth
    above = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return torch.where(above[..., None], torch.clamp(val, min=0.0), 0.0)


# ---------------------------------------------------------------- geometry
GROUP = 128  # prims a group: brute force within a group, boxes between


def _groups(p0, e1, e2):
    """The prims in groups of GROUP by the Morton order of their centroids,
    with each group's box (padded so that rounding never culls a hit); a
    prim whose box is far larger than the median goes to a group of such
    prims, which every ray tests. numpy in, (prim ids (G, GROUP) padded
    with -1, lo (G, 3), hi (G, 3)) out."""
    pts = np.stack([p0, p0 + e1, p0 + e2])
    lo_p, hi_p = pts.min(0), pts.max(0)
    diag = np.linalg.norm(hi_p - lo_p, axis=-1)
    big = diag > 8.0 * max(float(np.median(diag)), 1e-12)
    c = 0.5 * (lo_p + hi_p)
    s_lo, s_hi = c.min(0), c.max(0)
    cell = np.clip(((c - s_lo) / np.maximum(s_hi - s_lo, 1e-12) * 1023).astype(np.int64), 0, 1023)
    code = np.zeros(len(c), np.int64)
    for bit in range(10):
        for ax in range(3):
            code |= ((cell[:, ax] >> bit) & 1) << (3 * bit + ax)
    small = np.flatnonzero(~big)
    small = small[np.argsort(code[small], kind="stable")]
    groups = [np.flatnonzero(big)] if big.any() else []
    groups += [small[i:i + GROUP] for i in range(0, len(small), GROUP)]
    ids = np.full((len(groups), max(len(g) for g in groups)), -1, np.int64)
    lo = np.zeros((len(groups), 3), np.float64)
    hi = np.zeros((len(groups), 3), np.float64)
    for i, g in enumerate(groups):
        ids[i, :len(g)] = g
        lo[i], hi[i] = lo_p[g].min(0), hi_p[g].max(0)
    pad = 1e-4 * (1.0 + np.abs(np.concatenate([lo, hi])).max())
    return ids, lo - pad, hi + pad


def _tri_test(o, d, p0, e1, e2, maxt):
    """Moller-Trumbore of rays (K, 1, 3) against their prims (K, M, 3):
    (t with inf off a hit, u, v)."""
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    inv = _safe_div(torch.ones_like(det), det)
    tvec = o - p0
    u = _dot(tvec, pvec) * inv
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv
    t = _dot(e2, qvec) * inv
    ok = ((det.abs() > 1e-7) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
          & (t < maxt[:, None]))
    return torch.where(ok, t, float("inf")), u, v


def _hits(scene, o, d, maxt, any_hit, ray_chunk=1 << 15):
    """Rays against every prim by brute force within the groups whose box
    each ray enters: (t, prim, u, v) of the nearest hit with t < maxt
    (prim -1 on a miss; of equal t the lowest prim id), or a bool any-hit.
    """
    n, dev = o.shape[0], o.device
    pair_chunk = 1 << (17 if o.is_cuda else 15)
    pr = scene.prims
    of = o.float()
    inv_d = 1.0 / torch.where(d.float().abs() < 1e-30, 1e-30, d.float())
    lim = torch.where(maxt.float() > 0.0, maxt.float(), -1.0)
    rays, groups = [], []
    for s in range(0, n, ray_chunk):
        t0 = (scene.group_lo[None] - of[s:s + ray_chunk, None]) * inv_d[s:s + ray_chunk, None]
        t1 = (scene.group_hi[None] - of[s:s + ray_chunk, None]) * inv_d[s:s + ray_chunk, None]
        near = torch.minimum(t0, t1).amax(-1)
        far = torch.maximum(t0, t1).amin(-1)
        pair = torch.nonzero((far >= torch.clamp(near, min=0.0))
                             & (near <= lim[s:s + ray_chunk, None]))
        rays.append(pair[:, 0] + s)
        groups.append(pair[:, 1])
    rays, groups = torch.cat(rays), torch.cat(groups)
    t_p, prim_p, u_p, v_p = [], [], [], []
    m = scene.group_ids.shape[1]
    cols = torch.arange(m, device=dev)
    for s in range(0, rays.shape[0], pair_chunk):
        r, g = rays[s:s + pair_chunk], groups[s:s + pair_chunk]
        ids = scene.group_ids[g]
        safe = ids.clamp(min=0)
        t, u, v = _tri_test(o[r, None], d[r, None], pr["p0"][safe], pr["e1"][safe],
                            pr["e2"][safe], maxt[r])
        keep = ids >= 0
        if any_hit:
            keep = keep & scene.occludes[safe]
        t = torch.where(keep, t, float("inf"))
        t_g = t.amin(-1)
        j = torch.where(t == t_g[:, None], cols, m).amin(-1).clamp(max=m - 1)
        t_p.append(t_g)
        prim_p.append(torch.gather(ids, 1, j[:, None]).squeeze(1))
        if not any_hit:
            u_p.append(torch.gather(u, 1, j[:, None]).squeeze(1))
            v_p.append(torch.gather(v, 1, j[:, None]).squeeze(1))
    cat = (lambda xs, like: torch.cat(xs) if xs else like.new_zeros((0,)))
    t_p, prim_p = cat(t_p, o), cat(prim_p, rays)
    u_p, v_p = cat(u_p, o), cat(v_p, o)
    if scene.n_spheres:
        # every ray against every sphere (a scene holds few)
        oc = o[:, None] - scene.sphere_center[None]
        b = _dot(oc, d[:, None])
        c = _dot(oc, oc) - scene.sphere_radius[None] ** 2
        disc = b * b - c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t0, t1 = -b - sq, -b + sq
        ts = torch.where(t0 > 1e-7, t0, t1)
        ok = (disc >= 0.0) & (ts > 1e-7) & (ts < maxt[:, None])
        if any_hit:
            ok = ok & scene.occludes[scene.n_tris:][None]
        rs, js = torch.nonzero(ok, as_tuple=True)
        rays = torch.cat([rays, rs])
        t_p = torch.cat([t_p, ts[rs, js]])
        prim_p = torch.cat([prim_p, js + scene.n_tris])
        u_p = torch.cat([u_p, torch.zeros_like(ts[rs, js])])
        v_p = torch.cat([v_p, torch.zeros_like(ts[rs, js])])
    hit = torch.isfinite(t_p)
    if any_hit:
        occluded = torch.zeros(n, dtype=torch.bool, device=dev)
        occluded[rays[hit]] = True
        return occluded
    best_t = torch.full((n,), float("inf"), dtype=o.dtype, device=dev)
    best_t = best_t.scatter_reduce(0, rays, t_p, "amin")
    tie = hit & (t_p == best_t[rays])
    big = scene.n_prims
    best_p = torch.full((n,), big, dtype=torch.int64, device=dev)
    best_p = best_p.scatter_reduce(0, rays[tie], prim_p[tie], "amin")
    win = tie & (prim_p == best_p[rays])
    best_u = torch.zeros(n, dtype=o.dtype, device=dev)
    best_v = torch.zeros(n, dtype=o.dtype, device=dev)
    best_u[rays[win]] = u_p[win]
    best_v[rays[win]] = v_p[win]
    return best_t, torch.where(best_p < big, best_p, -1), best_u, best_v


class _Hit:
    """A lane's surface interaction: position, geometric normal, shading
    frame (flipped toward the arriving ray), local wi, material,
    emitter."""

    def __init__(self, scene, o, d, t, prim, u, v):
        self.valid = prim >= 0
        g = prim.clamp(min=0)
        tri = g.clamp(max=scene.n_tris - 1)
        pr = {k: scene.prims[k][tri] for k in scene.prims}
        self.t = t
        self.p = o + d * torch.where(self.valid, t, 0.0)[..., None]
        n_tri = _normalize(_cross(pr["e1"], pr["e2"]))
        w = (1.0 - u - v)[..., None]
        sh_tri = w * pr["n0"] + u[..., None] * pr["n1"] + v[..., None] * pr["n2"]
        if scene.n_spheres:
            is_sph = (g >= scene.n_tris)[..., None]
            j = (g - scene.n_tris).clamp(0, scene.n_spheres - 1)
            n_sph = ((self.p - scene.sphere_center[j])
                     / torch.clamp(scene.sphere_radius[j], min=1e-12)[..., None])
            self.n = torch.where(is_sph, n_sph, n_tri)
            n_sh = _normalize(torch.where(is_sph, n_sph, sh_tri))
        else:
            self.n = n_tri
            n_sh = _normalize(sh_tri)
        n_sh = torch.where((_dot(self.n, d) < 0.0)[..., None], n_sh, -n_sh)
        self.s, self.tt = _basis(n_sh)
        self.sn = n_sh
        self.wi = self.to_local(-d)
        self.prim = torch.where(self.valid, prim, -1)
        self.mat = torch.where(self.valid, scene.mat[g], 0)
        self.emitter = torch.where(self.valid, scene.emitter[g], -1)

    def to_local(self, v):
        return torch.stack([_dot(v, self.s), _dot(v, self.tt), _dot(v, self.sn)], -1)

    def to_world(self, v):
        return v[..., 0:1] * self.s + v[..., 1:2] * self.tt + v[..., 2:3] * self.sn

    def spawn(self, d):
        sgn = torch.where(_dot(d, self.n) >= 0.0, 1.0, -1.0).to(d.dtype)
        scale = RAY_EPSILON * (1.0 + self.p.abs().amax(-1))
        return self.p + (sgn * scale)[..., None] * self.n


# ---------------------------------------------------------------- materials
def _ggx(p, wi, wo_nee, u2, dt, dev):
    """A GGX rough conductor: (f cos at wo_nee, pdf at wo_nee, wo, pdf,
    weight) with visible-normal sampling (Heitz 2018). The sampled wo and
    the pdfs are detached, and the weight is f cos at wo held fixed over
    the detached pdf: the detached estimator, whose gradient in alpha is
    the eval's."""
    au, av = torch.clamp(p["au"], min=1e-4), torch.clamp(p["av"], min=1e-4)
    eta = torch.tensor(p["eta"], dtype=torch.float32, device=dev).to(dt)
    k = torch.tensor(p["k"], dtype=torch.float32, device=dev).to(dt)
    spec = torch.tensor(p["spec"], dtype=torch.float32, device=dev).to(dt)

    def ndf(h):
        t = (h[..., 0] / au) ** 2 + (h[..., 1] / av) ** 2 + h[..., 2] ** 2
        return torch.where(h[..., 2] > 0.0, _safe_div(torch.ones_like(t),
                                                      math.pi * au * av * t * t), 0.0)

    def g1(v, h):
        a2 = (au * v[..., 0]) ** 2 + (av * v[..., 1]) ** 2
        lam = 0.5 * (-1.0 + torch.sqrt(1.0 + _safe_div(a2, v[..., 2] * v[..., 2])))
        return torch.where(_dot(v, h) * v[..., 2] <= 0.0, 0.0, 1.0 / (1.0 + lam))

    def fresnel(cos_i):
        c = torch.clamp(cos_i.abs(), min=1e-6)[..., None]
        c2 = c * c
        s2 = 1.0 - c2
        e2, k2 = eta * eta, k * k
        t0 = e2 - k2 - s2
        a2b2 = torch.sqrt(torch.clamp(t0 * t0 + 4.0 * e2 * k2, min=0.0))
        t1 = a2b2 + c2
        a = torch.sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0.0))
        t2 = 2.0 * a * c
        rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-12)
        t3 = c2 * a2b2 + s2 * s2
        t4 = t2 * s2
        return 0.5 * (rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-12) + rs)

    def evaluate(wo):
        ci, co = wi[..., 2], wo[..., 2]
        h = _normalize(wi + wo)
        g2 = g1(wi, h) * g1(wo, h)
        val = spec * fresnel(_dot(wi, h)) * _safe_div(ndf(h) * g2, 4.0 * ci)[..., None]
        return torch.where(((ci > 0.0) & (co > 0.0))[..., None], val, 0.0)

    def pdf(wo):
        h = _normalize(wi + wo)
        dv = _safe_div(g1(wi, h) * torch.clamp(_dot(wi, h), min=0.0) * ndf(h),
                       wi[..., 2].abs())
        return torch.where((wi[..., 2] > 0.0) & (wo[..., 2] > 0.0),
                           _safe_div(dv, 4.0 * _dot(wo, h).abs()), 0.0)

    vh = _normalize(torch.stack([au * wi[..., 0], av * wi[..., 1], wi[..., 2]], -1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv_len = torch.rsqrt(torch.clamp(lensq, min=1e-14))
    x_axis = torch.zeros_like(vh)
    x_axis[..., 0] = 1.0
    t1 = torch.where((lensq > 1e-12)[..., None],
                     torch.stack([-vh[..., 1] * inv_len, vh[..., 0] * inv_len,
                                  torch.zeros_like(inv_len)], -1), x_axis)
    t2 = _cross(vh, t1)
    r = torch.sqrt(u2[..., 0])
    phi = 2.0 * math.pi * u2[..., 1]
    p1, p2 = r * torch.cos(phi), r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    nh = (p1[..., None] * t1 + p2[..., None] * t2
          + torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))[..., None] * vh)
    h = _normalize(torch.stack([au * nh[..., 0], av * nh[..., 1],
                                torch.clamp(nh[..., 2], min=1e-6)], -1))
    wo = (2.0 * (wi * h).sum(-1, keepdim=True) * h - wi).detach()
    p_s = pdf(wo).detach()
    ok = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0) & (p_s > 0.0)
    weight = torch.where(ok[..., None], _safe_div(evaluate(wo), p_s[..., None]), 0.0)
    return evaluate(wo_nee), pdf(wo_nee).detach(), wo, torch.where(ok, p_s, 0.0), weight


def _diffuse(p, wi, wo_nee, u2, dt, dev):
    refl = torch.as_tensor(p["refl"], device=dev).to(dt)
    wo = _cosine_hemisphere(u2)

    def pdf(w):
        ok = (wi[..., 2] > 0.0) & (w[..., 2] > 0.0)
        return torch.where(ok, torch.clamp(w[..., 2], min=0.0) * INV_PI, 0.0)

    ok_nee = (wi[..., 2] > 0.0) & (wo_nee[..., 2] > 0.0)
    f_nee = torch.where(ok_nee[..., None],
                        refl * (INV_PI * torch.clamp(wo_nee[..., 2], min=0.0))[..., None], 0.0)
    weight = torch.where((wi[..., 2] > 0.0)[..., None], refl.expand_as(wo), 0.0)
    return f_nee, pdf(wo_nee), wo, pdf(wo), weight


def _merl(scene, slot, wi, wo_nee, u2, u_lobe, mask, mask_nee):
    """The tabulated BRDF's bounce: f cos and pdf toward wo_nee, and a
    direction from the mixture of the luminance-weighted half-vector
    distribution of wi's incident-angle bin (0.9) and a cosine lobe
    (0.1), with its pdf and weight."""
    cos_wi_ok = wi[..., 2] > 0.0
    any_mask = cos_wi_ok & (mask | mask_nee)
    theta_i, phi_i = _dir_to_sph(wi)
    wi_c = _sph_to_dir(theta_i, torch.zeros_like(theta_i))
    tbin = torch.where(any_mask, torch.clamp((theta_i / HALF_PI * N_THETA_I).long(), 0,
                                             N_THETA_I - 1), 0)
    slot = torch.where(any_mask, slot, 0)
    use_cos = u_lobe < COSINE_MIX
    u_row, u_col = u2[..., 0], u2[..., 1]
    rows = scene.cdf_row[slot, tbin]
    r_own, row_lo, row_mass = _invert_cdf(rows, u_row)
    dy = torch.clamp((u_row - row_lo) / torch.clamp(row_mass, min=TINY), 0.0, 1.0 - 1e-7)

    nee_ok = (wo_nee[..., 2] > 0.0) & mask_nee
    wo_nee_c = torch.where(nee_ok[..., None], _rotate_z(wo_nee, -phi_i), wi_c)
    wo_cos = _cosine_hemisphere(u2)

    def cell(wo_c):
        h = _normalize(wi_c + wo_c)
        th, ph = _dir_to_sph(h)
        y = torch.sqrt(torch.clamp(th / HALF_PI, min=0.0))
        x = torch.clamp((ph + math.pi) / (2.0 * math.pi), 0.0, 1.0 - 1e-7)
        r = torch.clamp((y * RES_H).long(), 0, RES_H - 1)
        c = torch.clamp((x * RES_PHI).long(), 0, RES_PHI - 1)
        theta_h = HALF_PI * y * y
        denom = 2.0 * math.pi * math.pi * y * torch.sin(theta_h) * 4.0 * _dot(wo_c, h).abs()
        return r, c, denom

    r_nee, c_nee, denom_nee = cell(wo_nee_c)
    r_cos, c_cos, denom_cos = cell(wo_cos)
    cond = scene.cdf_cond.reshape(-1, RES_PHI)
    cond_base = (slot * N_THETA_I + tbin) * RES_H

    def cond_row(r):
        return cond[cond_base + r]

    col, col_lo, col_mass = _invert_cdf(cond_row(r_own), u_col)
    dx = torch.clamp((u_col - col_lo) / torch.clamp(col_mass, min=TINY), 0.0, 1.0 - 1e-7)
    x = torch.where(any_mask, (col.to(u_col.dtype) + dx) / RES_PHI, 0.0)
    mass_own = torch.where(any_mask, col_mass, 0.0)

    def cell_mass(cdf_rows, r, c):
        row = cdf_rows if r is None else cond_row(r)
        return _take(row, c) - torch.where(c > 0, _take(row, (c - 1).clamp(min=0)), 0.0)

    mass_nee = torch.where(any_mask, cell_mass(None, r_nee, c_nee), 0.0)
    mass_cos = torch.where(any_mask, cell_mass(None, r_cos, c_cos), 0.0)
    hw = RES_H * RES_PHI
    h, jac = _halfvec((r_own.to(u_row.dtype) + dy) / RES_H, x)
    wo_tab = 2.0 * (wi_c * h).sum(-1, keepdim=True) * h - wi_c
    p_own = _safe_div(row_mass * mass_own * hw, jac * 4.0 * _dot(wo_tab, h).abs())
    p_cos_tab = _safe_div(cell_mass(rows, None, r_cos) * mass_cos * hw, denom_cos)
    wo_c = torch.where(use_cos[..., None], wo_cos, wo_tab)
    wo = _rotate_z(wo_c, phi_i)
    pdf_s = ((1.0 - COSINE_MIX) * torch.where(use_cos, p_cos_tab, p_own)
             + COSINE_MIX * torch.clamp(wo_c[..., 2], min=0.0) * INV_PI)
    valid_s = (pdf_s > 1e-12) & (wo_c[..., 2] > 0.0) & cos_wi_ok
    p_nee_tab = _safe_div(cell_mass(rows, None, r_nee) * mass_nee * hw, denom_nee)
    pdf_nee = ((1.0 - COSINE_MIX) * p_nee_tab
               + COSINE_MIX * torch.clamp(wo_nee_c[..., 2], min=0.0) * INV_PI)
    pdf_nee = torch.where(nee_ok & cos_wi_ok, pdf_nee, 0.0)

    def f_cos(wo_, m):
        f = _merl_raw(scene.tables, wi, wo_, slot)
        return torch.where(m[..., None], f, 0.0) * torch.clamp(wo_[..., 2], min=0.0)[..., None]

    f_nee = f_cos(wo_nee, nee_ok & cos_wi_ok)
    f_s = f_cos(wo, valid_s & mask)
    weight = torch.where(valid_s[..., None], _safe_div(f_s, pdf_s[..., None]), 0.0)
    return f_nee, pdf_nee, wo, torch.where(valid_s, pdf_s, 0.0), weight


def _shade(scene, hit, wo_nee, u2, u_lobe, active, nee_vis):
    """Every material's bounce on its lanes; lanes outside `active` get 0."""
    n = wo_nee.shape[0]
    z3 = torch.zeros_like(wo_nee)
    z1 = torch.zeros(n, dtype=wo_nee.dtype, device=wo_nee.device)
    f_nee, p_nee, wo, p_s, weight = z3, z1, z3, z1, z3
    kind, slot = scene.mat_kind[hit.mat], scene.mat_slot[hit.mat]
    dt, dev = scene.dtype, scene.device

    def put(mask, res):
        nonlocal f_nee, p_nee, wo, p_s, weight
        f_nee, p_nee, wo, p_s, weight = (
            torch.where(mask[..., None] if r.dim() == 2 else mask, r, o)
            for o, r in zip((f_nee, p_nee, wo, p_s, weight), res))

    if (kind == MERL).any():
        mask = (kind == MERL) & active
        put(mask, _merl(scene, torch.where(mask, slot, 0), hit.wi, wo_nee, u2, u_lobe,
                        mask, mask & nee_vis))
    for kid, fn, params in ((GGX, _ggx, scene.ggx), (DIFFUSE, _diffuse, scene.diffuse)):
        for i, p in enumerate(params):
            mask = (kind == kid) & (slot == i) & active
            if bool(mask.any()):
                put(mask, fn(p, hit.wi, wo_nee, u2, dt, dev))
    return f_nee, p_nee, wo, p_s, weight


# ---------------------------------------------------------------- the paths
def trace(scene, seed, pixel, sample):
    """Per-lane radiance (N, 3) of lanes (pixel, sample index): int64
    tensors on the scene's device, pixel = y * width + x."""
    dt, dev = scene.dtype, scene.device
    w, h, spp = scene.width, scene.height, scene.spp
    lane = pixel * spp + sample
    rng = _Uniforms(seed, lane, dt)
    n = lane.shape[0]
    jitter = torch.stack([rng.draw(0), rng.draw(1)], -1)
    film = torch.stack([(pixel % w).to(dt), (pixel // w).to(dt)], -1) + jitter
    uv = film / torch.tensor([w, h], dtype=torch.float32, device=dev).to(dt)
    x = (2.0 * uv[:, 0] - 1.0) * scene.tan_half
    y = (1.0 - 2.0 * uv[:, 1]) * scene.tan_half / (w / h)
    d_cam = _normalize(torch.stack([x, y, torch.ones_like(x)], -1))
    rot = scene.cam_rot
    d = _normalize(d_cam[:, 0:1] * rot[:, 0] + d_cam[:, 1:2] * rot[:, 1]
                   + d_cam[:, 2:3] * rot[:, 2])
    o = scene.cam_pos + d * scene.near_clip
    maxt = torch.full((n,), float("inf"), dtype=dt, device=dev)
    thr = torch.ones((n, 3), dtype=dt, device=dev)
    L = torch.zeros((n, 3), dtype=dt, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros(n, dtype=dt, device=dev)
    prev_delta = torch.ones(n, dtype=torch.bool, device=dev)
    sky = torch.as_tensor(scene.sky, device=dev).to(dt)
    depth = scene.max_depth
    for b in range(depth):
        base = CAMERA_DIMS + b * BOUNCE_DIMS
        t, prim, u, v = _hits(scene, o, d, torch.where(active, maxt, 0.0), False)
        hit = _Hit(scene, o, d, t, prim, u, v)
        # emitted radiance reached by the ray: the area light's front, or the sky
        row = scene.prim_light_row[hit.prim.clamp(min=0)].clamp(min=0)
        on_light = hit.valid & (hit.emitter >= 0)
        front = _dot(hit.n, hit.to_world(hit.wi)) > 0.0
        rad = torch.where((on_light & front)[..., None], scene.light_radiance, 0.0)
        rad = torch.where(hit.valid[..., None], rad, sky)
        to_x = hit.p - o
        dist2 = (to_x * to_x).sum(-1)
        cos_e = _dot(hit.n, -(to_x * torch.rsqrt(torch.clamp(dist2, min=1e-14))[..., None]))
        pdf_hit = _safe_div(scene.light_pmf[row] / torch.clamp(scene.light_area[row], min=1e-12)
                            * dist2, cos_e)
        em_pdf = torch.where(on_light & (cos_e > 0.0), pdf_hit, 0.0)
        w_mis = torch.where(prev_delta, 1.0, _mis(prev_pdf, em_pdf)).to(dt).detach()
        L = L + torch.where(active[..., None], thr * rad * w_mis[..., None], 0.0)
        active = active & hit.valid
        if b == depth - 1:
            break
        u2 = torch.stack([rng.draw(base), rng.draw(base + 1)], -1)
        u_lobe = rng.draw(base + 2)
        u3 = [rng.draw(base + OFF_NEE + i) for i in range(3)]
        # NEE toward the area light: a prim by area (reusing the first
        # uniform), a uniform point on it from the other two
        q = _invert_cdf(scene.light_cdf.expand(n, -1), torch.clamp(u3[0], max=1.0 - 1e-7))[0]
        prim_q = scene.light_prims[q]
        e1, e2 = scene.prims["e1"][prim_q], scene.prims["e2"][prim_q]
        su = torch.sqrt(torch.clamp(1.0 - u3[1], min=0.0))
        pos = (scene.prims["p0"][prim_q] + (1.0 - su)[..., None] * e1
               + (su * u3[2])[..., None] * e2)
        n_e = _normalize(_cross(e1, e2))
        to_l = pos - hit.p
        ldist2 = (to_l * to_l).sum(-1)
        ldist = torch.sqrt(torch.clamp(ldist2, min=1e-12))
        ld = to_l / ldist[..., None]
        cos_l = _dot(n_e, -ld)
        lfront = cos_l > 0.0
        p_area = _safe_div(scene.light_pmf[q], scene.light_area[q])
        l_pdf = torch.where(lfront, _safe_div(p_area * ldist2, cos_l), 0.0)
        l_rad = torch.where(lfront[..., None], scene.light_radiance, 0.0)
        wo_nee = hit.to_local(ld)
        nee_ok = active & (l_pdf > 0.0) & (b + 2 <= depth) & (wo_nee[..., 2] > 0.0)
        smaxt = torch.where(nee_ok, ldist * (1.0 - 1e-3), 0.0)
        nee_vis = nee_ok & ~_hits(scene, hit.spawn(ld), ld, smaxt, True)
        f_nee, p_nee, wo, p_s, weight = _shade(scene, hit, wo_nee, u2, u_lobe, active,
                                               nee_vis)
        w_nee = _mis(l_pdf, p_nee)
        L = L + torch.where(nee_vis[..., None],
                            thr * f_nee * l_rad * _safe_div(w_nee, l_pdf).detach()[..., None],
                            0.0)
        thr = thr * torch.where(active[..., None], weight, 1.0)
        wo, p_s = wo.detach(), p_s.detach()
        d_new = hit.to_world(wo)
        o = torch.where(active[..., None], hit.spawn(d_new), o)
        d = torch.where(active[..., None], d_new, d)
        active = active & (p_s > 0.0) & (weight > 0.0).any(-1) & (b + 1 < depth)
        if b + 1 >= scene.rr_depth:
            qq = torch.clamp(thr.amax(-1), 0.05, 0.95).detach()
            survive = rng.draw(base + 3) < qq
            thr = torch.where(survive[..., None], thr / qq[..., None], thr)
            active = active & survive
        prev_pdf = p_s
        prev_delta = torch.zeros_like(active)
    return L


def render_pixels(scene, seed, pixels):
    """The box-filtered values (M, 3) of `pixels` (int64, y * width + x) at
    `seed`: the mean of each pixel's spp lanes."""
    spp = scene.spp
    pix = pixels.repeat_interleave(spp)
    smp = torch.arange(spp, device=pixels.device).repeat(pixels.shape[0])
    return trace(scene, seed, pix, smp).reshape(-1, spp, 3).mean(1)


# ---------------------------------------------------------------- inverse rendering
def loss_and_grad(d, params, target, seed, device, dtype=torch.float32,
                  lanes_per_block=None):
    """The mean squared error of the image of scene dict `d` with `params`
    ({key: tensor}) against `target` (H, W, 3), and its gradient in each
    parameter, block of pixels by block: (loss, {key: gradient})."""
    leaves = {k: v.detach().to(device=device, dtype=dtype).requires_grad_(True)
              for k, v in params.items()}
    scene = Scene(d, device, dtype, leaves)
    w, h, spp = scene.width, scene.height, scene.spp
    tgt = target.to(device=device, dtype=dtype).reshape(-1, 3)
    lanes_per_block = lanes_per_block or (1 << (18 if torch.device(device).type == "cuda"
                                                    else 14))
    per = max(1, lanes_per_block // spp)
    total = torch.zeros((), dtype=torch.float64, device=device)
    for p0 in range(0, w * h, per):
        pix = torch.arange(p0, min(p0 + per, w * h), device=device)
        part = ((render_pixels(scene, seed, pix) - tgt[pix]) ** 2).sum() / (w * h * 3)
        if part.requires_grad:  # rows of sky alone depend on no parameter
            part.backward()
        total += part.detach().double()
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v)) for k, v in leaves.items()}
    return total, grads


class Adam:
    """Adam (Kingma and Ba 2015) with bias correction, betas (0.9, 0.999),
    eps 1e-8, each parameter clamped to >= 0 after its step."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8):
        self.params = {k: v.detach().clone() for k, v in params.items()}
        self.lr, self.betas, self.eps, self.t = lr, betas, eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}

    def step(self, grads):
        self.t += 1
        b1, b2 = self.betas
        for k, p in self.params.items():
            g = grads[k].to(p.dtype)
            self.m[k] = b1 * self.m[k] + (1.0 - b1) * g
            self.v[k] = b2 * self.v[k] + (1.0 - b2) * g * g
            m_hat = self.m[k] / (1.0 - b1 ** self.t)
            v_hat = self.v[k] / (1.0 - b2 ** self.t)
            self.params[k] = torch.clamp(p - self.lr * m_hat / (torch.sqrt(v_hat) + self.eps),
                                         min=0.0)
        return self.params

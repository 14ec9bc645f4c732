"""Emitters: area, constant, envmap, point, spot, directional,
directionalarea and projector, and scene-level NEE sampling.

PyTorch port of mitsuba_customization_tpu/render/emitters.py (mitsuba3
src/emitters/ and Scene::sample_emitter_direction / pdf_emitter_direction):
`EmitterTable`, `build_env_distribution`, `env_radiance`,
`sample_direction`, `pdf_hit_direction`, `pdf_hit_area`,
`pdf_miss_direction`, `eval_background` and `eval_hit`. Lanes pick an
emitter from one discrete distribution and each present emitter type
evaluates under a mask. The
JAX package's structural gates (an envmap image of more than one texel, a
projector index, the directionalarea prim owners) are host facts here:
`env_index`, `proj_index` and `em_prim_emitter is None`, and `present`
names the emitter types in the table, so absent types cost nothing.

Area emitters reference emissive primitives of the scene Geometry. All of
them live in one array `em_prims` (Q,); each area emitter owns a pmf row
over it (zero outside its own prims), so prim selection is one CDF
inversion whichever emitter a lane picked. The JAX package's rank trick
in `_q_of_prim` and its compact `em_geom` copy are TPU gather
workarounds; here `_q_of_prim` is a plain `prim_to_q` gather and plain
indexing computes the same. `pdf_hit_area` is bdpt's area density of a
hit emitter point, and `DirectionSample.p_area` its NEE counterpart.

Per-lane reads of the envmap and projector images gather from flat views
with index_select (its backward is one index_add_). The 3x3 rotations are
written out as sums of products, not matmuls (no TF32 on the card).

The emitter stage of a bounce (`hit_term`, `sample_nee`, `nee_term`, which
the integrators call) takes one of two routes a part (`route`): the CUDA
kernels of ops/emitter_shade.py, or the functions above ("plain"), which
are the reference and what every CPU call runs.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from mitsuba_customization_tpu_torch.core import math as m
from mitsuba_customization_tpu_torch.core.distr import DiscreteDistribution, Marginal2D
from mitsuba_customization_tpu_torch.core.frame import Frame
from mitsuba_customization_tpu_torch.core.sampler import IndependentSampler
from mitsuba_customization_tpu_torch.core.spectrum import luminance
from mitsuba_customization_tpu_torch.core.warp import (
    square_to_uniform_sphere,
    square_to_uniform_triangle,
)
from mitsuba_customization_tpu_torch.ops import emitter_shade
from mitsuba_customization_tpu_torch.render import geometry as geo
from mitsuba_customization_tpu_torch.render.records import DirectionSample
from mitsuba_customization_tpu_torch.utils import log

AREA = 0
CONSTANT = 1
ENVMAP = 2
POINT = 3
SPOT = 4
DIRECTIONAL = 5
DIRECTIONALAREA = 6  # collimated area source (mitsuba3 directionalarea.cpp)
PROJECTOR = 7  # textured perspective point source (projector.cpp)

DELTA_EMITTERS = (POINT, SPOT, DIRECTIONAL, DIRECTIONALAREA, PROJECTOR)

INV_FOUR_PI = 1.0 / (4.0 * math.pi)


class EmitterTable(NamedTuple):
    """All emitters of a scene (K emitters, Q emissive prims).

    radiance (K, 3) is area / constant radiance, the envmap's scale,
    point / spot / projector intensity, directional irradiance. position
    (K, 3) point / spot / projector; direction (K, 3) unit, spot /
    directional / directionalarea (pointing away from the emitter);
    cutoff_cos / beam_cos (K,) the spot's cones. The envmap: env_image
    (H, W, 3) (1x1 zeros without one), its luminance * sin(theta)
    Marginal2D env_dist, env_to_world (3, 3), env_index its emitter id or
    -1. The projector: proj_image (H, W, 3), proj_to_world (3, 3) (columns
    right, up, forward), proj_tan tan(fov_x / 2), proj_index its id or -1.
    em_prim_emitter (Q,) owner of each emissive prim, None without a
    directionalarea emitter. present: the emitter types of the table.
    """

    em_type: torch.Tensor  # (K,) int64
    select: DiscreteDistribution  # NEE selection over the K emitters
    radiance: torch.Tensor  # (K, 3)
    background_index: int  # constant emitter id, -1 if none
    prim_dist: DiscreteDistribution  # (K, Q) per-emitter pmf over em_prims
    em_prims: torch.Tensor  # (Q,) int64 prim ids (padded with 0)
    prim_area: torch.Tensor  # (Q,) surface areas
    prim_to_q: torch.Tensor  # (P,) int64 prim id -> q index or -1
    # whether any emissive prim exists (a host fact: without one the area
    # branches are not computed)
    has_area: bool = True
    position: Any = None
    direction: Any = None
    cutoff_cos: Any = None
    beam_cos: Any = None
    env_image: Any = None
    env_dist: Any = None
    env_to_world: Any = None
    env_index: int = -1
    em_prim_emitter: Any = None
    proj_image: Any = None
    proj_to_world: Any = None
    proj_tan: Any = None
    proj_index: int = -1
    present: frozenset = frozenset([AREA, CONSTANT])

    @property
    def n_emitters(self):
        return self.em_type.shape[0]


def prim_surface_area(geom: geo.Geometry, prim):
    """Surface area of primitives `prim`: a triangle's, a sphere's (radius
    e1.x) or a cylinder's side (height |e1|, radius e2.x)."""
    g = geo.Geometry(*(f[prim] for f in geom))
    tri = 0.5 * m.norm(m.cross(g.e1, g.e2))
    sph = 4.0 * math.pi * g.e1[..., 0] ** 2
    cyl = 2.0 * math.pi * g.e2[..., 0] * m.norm(g.e1)
    return torch.where(g.prim_type == geo.TRI, tri,
                       torch.where(g.prim_type == geo.CYLINDER, cyl, sph))


def _sample_position_on_prim(geom: geo.Geometry, prim, sample2):
    """Uniform-area point and outward normal on primitives `prim`."""
    g = geo.Geometry(*(f[prim] for f in geom))
    b = square_to_uniform_triangle(sample2)
    p_tri = g.p0 + b[..., 0:1] * g.e1 + b[..., 1:2] * g.e2
    n_tri = m.normalize(m.cross(g.e1, g.e2))
    d = square_to_uniform_sphere(sample2)
    p_sph = g.p0 + g.e1[..., 0:1] * d
    cyl_len = torch.clamp(m.norm(g.e1), min=1e-12)
    cyl_a = g.e1 / cyl_len[..., None]
    fr = Frame.from_normal(cyl_a)
    phi = 2.0 * math.pi * sample2[..., 0]
    n_cyl = torch.cos(phi)[..., None] * fr.s + torch.sin(phi)[..., None] * fr.t
    p_cyl = (g.p0 + (sample2[..., 1] * cyl_len)[..., None] * cyl_a
             + g.e2[..., 0:1] * n_cyl)
    is_tri = (g.prim_type == geo.TRI)[..., None]
    is_cyl = (g.prim_type == geo.CYLINDER)[..., None]
    p = torch.where(is_tri, p_tri, torch.where(is_cyl, p_cyl, p_sph))
    n = torch.where(is_tri, n_tri, torch.where(is_cyl, n_cyl, d))
    return p, n


# --------------------------------------------------------------------------
# Images: envmap and projector lookups
# --------------------------------------------------------------------------


def _texel(img, y, x):
    """img[y, x] for per-lane int64 y, x, from the flat (H * W, 3) view."""
    return m.gather_rows(img.reshape(-1, 3), y * img.shape[1] + x)


def _vec_mat(v, mat):
    """v @ mat for (..., 3) v and a (3, 3) mat, as sums of products."""
    return (v[..., 0:1] * mat[0] + v[..., 1:2] * mat[1] + v[..., 2:3] * mat[2])


def build_env_distribution(image):
    """Luminance * sin(theta) Marginal2D over a lat-long envmap (H, W, 3)."""
    h = image.shape[0]
    theta = (torch.arange(h, dtype=torch.float32, device=image.device) + 0.5) / h * math.pi
    return Marginal2D.build(luminance(image) * torch.sin(theta)[:, None])


def _env_dir_from_uv(uv, to_world):
    """uv (..., 2) = (y = theta, x = phi) on the unit square -> world
    direction."""
    theta = uv[..., 0] * math.pi
    phi = uv[..., 1] * 2.0 * math.pi - math.pi
    return _vec_mat(m.sph_to_dir(theta, phi), to_world.T)


def _env_uv_from_dir(d_world, to_world):
    theta, phi = m.dir_to_sph(_vec_mat(d_world, to_world))
    return torch.stack([theta / math.pi, (phi + math.pi) / (2.0 * math.pi)], -1)


def env_radiance(table: EmitterTable, d_world):
    """Bilinear lookup of the envmap in world direction d: rows clamped,
    columns wrapped."""
    img = table.env_image
    h, w = img.shape[0], img.shape[1]
    uv = _env_uv_from_dir(d_world, table.env_to_world)
    y = torch.clamp(uv[..., 0] * h - 0.5, 0.0, h - 1.0)
    x = uv[..., 1] * w - 0.5
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(x).to(torch.int64)
    fy = (y - y0)[..., None]
    fx = (x - x0)[..., None]
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    y0 = torch.clamp(y0, 0, h - 1)
    x0w = torch.remainder(x0, w)
    x1w = torch.remainder(x0 + 1, w)
    c00, c01 = _texel(img, y0, x0w), _texel(img, y0, x1w)
    c10, c11 = _texel(img, y1, x0w), _texel(img, y1, x1w)
    return (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy


def _env_pdf(table: EmitterTable, d_world):
    """Solid-angle pdf of envmap importance sampling in direction d."""
    uv = _env_uv_from_dir(d_world, table.env_to_world)
    p_sq = table.env_dist.eval_pdf(uv)
    sin_theta = torch.sin(uv[..., 0] * math.pi)
    # d(omega) = 2 pi^2 sin(theta) du dv  (u = theta / pi, v = phi / 2 pi)
    return m.safe_div(p_sq, 2.0 * math.pi * math.pi * sin_theta)


def _bilinear_lookup(img, uv):
    """uv (..., 2) = (row in [0, 1], col in [0, 1]), clamped bilinear."""
    h, w = img.shape[0], img.shape[1]
    y = torch.clamp(uv[..., 0] * h - 0.5, 0.0, h - 1.0)
    x = torch.clamp(uv[..., 1] * w - 0.5, 0.0, w - 1.0)
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(x).to(torch.int64)
    fy = (y - y0)[..., None]
    fx = (x - x0)[..., None]
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    c00, c01 = _texel(img, y0, x0), _texel(img, y0, x1)
    c10, c11 = _texel(img, y1, x0), _texel(img, y1, x1)
    return (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy


# --------------------------------------------------------------------------
# Scene-level emitter sampling (NEE)
# --------------------------------------------------------------------------


def sample_direction(table: EmitterTable, geom: geo.Geometry, p_ref,
                     sample3) -> DirectionSample:
    """Pick an emitter, sample a direction toward it; radiance and pdf in
    solid angle at p_ref (1 for the delta emitters, times the selection
    pmf). sample3 (..., 3): the emitter selection (reused for the prim
    choice and the sky and envmap directions) and a 2-D position sample."""
    k, u0 = table.select.sample_reuse(sample3[..., 0])
    u2 = torch.stack([u0, sample3[..., 1]], -1)
    et = table.em_type[k]
    sel_pmf = table.select.eval_pmf(k)
    shape, dev = p_ref.shape[:-1], p_ref.device
    # index_select: a cheap backward for emitter.radiance (see
    # models/bsdf._gather_params)
    rad_k = table.radiance.index_select(0, k)
    out = dict(d=torch.zeros_like(p_ref), dist=torch.full(shape, float("inf"), device=dev),
               pdf=torch.zeros(shape, device=dev), radiance=torch.zeros_like(p_ref),
               delta=torch.zeros(shape, dtype=torch.bool, device=dev))
    inf = torch.full(shape, float("inf"), device=dev)
    one = torch.ones(shape, device=dev)
    smooth = torch.zeros(shape, dtype=torch.bool, device=dev)
    dirac = ~smooth

    def put(etype, d, dist, pdf, rad, delta):
        mask = et == etype
        out["d"] = torch.where(mask[..., None], d, out["d"])
        out["dist"] = torch.where(mask, dist, out["dist"])
        out["pdf"] = torch.where(mask, pdf, out["pdf"])
        out["radiance"] = torch.where(mask[..., None], rad, out["radiance"])
        out["delta"] = torch.where(mask, delta, out["delta"])

    out_p_area = torch.zeros(shape, device=dev)
    if table.has_area and AREA in table.present:
        q, _ = table.prim_dist.sample_reuse(u2[..., 0], slice_=k)
        x, n_e = _sample_position_on_prim(geom, table.em_prims[q], sample3[..., 1:3])
        to_x = x - p_ref
        dist2 = (to_x * to_x).sum(-1)
        dist = torch.sqrt(torch.clamp(dist2, min=1e-12))
        d = to_x / dist[..., None]
        cos_e = m.dot(n_e, -d)
        p_area = m.safe_div(table.prim_dist.eval_pmf(q, slice_=k), table.prim_area[q])
        front = cos_e > 0.0
        put(AREA, d, dist, torch.where(front, m.safe_div(p_area * dist2, cos_e), 0.0),
            torch.where(front[..., None], rad_k, 0.0), smooth)
        out_p_area = torch.where((et == AREA) & front, p_area * sel_pmf, 0.0)

    if CONSTANT in table.present:
        put(CONSTANT, square_to_uniform_sphere(u2), inf, one * INV_FOUR_PI, rad_k,
            smooth)

    if table.env_index >= 0:
        uv_e, p_sq = table.env_dist.sample(u2)
        d_e = _env_dir_from_uv(uv_e, table.env_to_world)
        sin_t = torch.sin(uv_e[..., 0] * math.pi)
        put(ENVMAP, d_e, inf, m.safe_div(p_sq, 2.0 * math.pi * math.pi * sin_t),
            env_radiance(table, d_e) * rad_k, smooth)

    if table.present & {POINT, SPOT, PROJECTOR}:
        to_p = table.position.index_select(0, k) - p_ref
        pdist2 = (to_p * to_p).sum(-1)
        pdist = torch.sqrt(torch.clamp(pdist2, min=1e-12))
        d_p = to_p / pdist[..., None]
        rad_p = rad_k / pdist2[..., None]
        put(POINT, d_p, pdist, one, rad_p, dirac)
        if SPOT in table.present:
            cut = table.cutoff_cos[k]
            cos_spot = m.dot(table.direction[k], -d_p)
            falloff = torch.clamp(m.safe_div(cos_spot - cut, table.beam_cos[k] - cut),
                                  0.0, 1.0)
            put(SPOT, d_p, pdist, one, rad_p * falloff[..., None], dirac)
        if table.proj_index >= 0:
            dl = _vec_mat(-d_p, table.proj_to_world)  # x right, y up, z forward
            z = torch.clamp(dl[..., 2], min=1e-12)
            px = dl[..., 0] / z
            py = dl[..., 1] / z
            img = table.proj_image
            tx = table.proj_tan
            ty = tx / (img.shape[1] / img.shape[0])
            inside = (dl[..., 2] > 0) & (px.abs() <= tx) & (py.abs() <= ty)
            uv = torch.stack([0.5 - py / ty * 0.5, px / tx * 0.5 + 0.5], -1)
            tex = _bilinear_lookup(img, uv)
            put(PROJECTOR, d_p, pdist, one,
                tex * rad_k / pdist2[..., None] * inside[..., None], dirac)

    if DIRECTIONAL in table.present:
        d_d = -table.direction[k]
        put(DIRECTIONAL, d_d, inf, one, rad_k, dirac)

    if table.em_prim_emitter is not None:
        # Collimated: from p_ref the light arrives from -n_em iff p_ref
        # projects onto the emitter's own prims along its authored normal
        d_da = -table.direction[k]
        geom_q = geo.Geometry(*(f[table.em_prims] for f in geom))
        t_q, _, _ = geo._intersect_prims(geom_q, p_ref[..., None, :], d_da[..., None, :],
                                         cylinders=False)
        owned = table.em_prim_emitter[None, :] == k[..., None]
        t_hit = torch.where(owned, t_q, float("inf")).amin(-1)
        on_beam = torch.isfinite(t_hit)
        put(DIRECTIONALAREA, d_da, torch.where(on_beam, t_hit, inf),
            torch.where(on_beam, 1.0, 0.0), rad_k, dirac)

    return DirectionSample(d=out["d"], dist=out["dist"], pdf=out["pdf"] * sel_pmf,
                           radiance=out["radiance"], delta=out["delta"], p_area=out_p_area)


def _q_of_prim(table: EmitterTable, prim):
    """The row of a hit emissive prim in em_prims (valid where the hit is
    on an emitter; callers mask)."""
    return torch.clamp(table.prim_to_q[prim.clamp(min=0)], min=0)


def pdf_hit_direction(table: EmitterTable, geom: geo.Geometry, si, p_ref):
    """NEE density (solid angle at p_ref) of a BSDF ray that hit si: the
    MIS denominator for area lights; 0 off emissive prims."""
    if not table.has_area:
        return torch.zeros_like(si.t)
    qs = _q_of_prim(table, si.prim)
    valid = (si.prim >= 0) & (si.emitter >= 0)
    em = si.emitter.clamp(min=0)
    pmf_q = table.prim_dist.eval_pmf(qs, slice_=em)
    sel = table.select.eval_pmf(em)
    to_x = si.p - p_ref
    dist2 = (to_x * to_x).sum(-1)
    d = to_x * m.safe_rsqrt(dist2)[..., None]
    cos_e = m.dot(si.n, -d)
    pdf_sa = m.safe_div(
        pmf_q / torch.clamp(table.prim_area[qs], min=1e-12) * dist2, cos_e
    )
    return torch.where(valid & (cos_e > 0), sel * pdf_sa, 0.0)


def pdf_hit_area(table: EmitterTable, si):
    """Area density of NEE / light-path emission sampling picking the
    point si.p on the hit emissive prim: sel_pmf * prim_pmf / prim_area (0
    off emitters). bdpt's MIS compares strategies in the area measure."""
    if not table.has_area:
        return torch.zeros_like(si.t)
    qs = _q_of_prim(table, si.prim)
    valid = (si.prim >= 0) & (si.emitter >= 0)
    em = si.emitter.clamp(min=0)
    p = (table.select.eval_pmf(em) * table.prim_dist.eval_pmf(qs, slice_=em)
         / torch.clamp(table.prim_area[qs], min=1e-12))
    return torch.where(valid, p, 0.0)


def pdf_miss_direction(table: EmitterTable, d_world):
    """NEE density of a BSDF ray that escaped (the constant sky and the
    envmap)."""
    p = torch.zeros(d_world.shape[:-1], device=d_world.device)
    if table.background_index >= 0:
        p = p + table.select.pmf[table.background_index] * INV_FOUR_PI
    if table.env_index >= 0:
        p = p + table.select.pmf[table.env_index] * _env_pdf(table, d_world)
    return p


def eval_background(table: EmitterTable, d_world):
    """Radiance carried by escaped rays (constant and envmap emitters)."""
    rad = torch.zeros_like(d_world)
    if table.background_index >= 0:
        rad = rad + table.radiance[table.background_index]
    if table.env_index >= 0:
        rad = rad + env_radiance(table, d_world) * table.radiance[table.env_index]
    return rad


def eval_hit(table: EmitterTable, si):
    """Radiance emitted by a surface hit toward the ray origin (area
    emitters, front side only)."""
    valid = si.emitter >= 0
    em = si.emitter.clamp(min=0)
    front = (si.n * si.to_world(si.wi)).sum(-1) > 0.0
    is_area = table.em_type[em] == AREA
    return torch.where(
        (valid & front & is_area)[..., None], table.radiance.index_select(0, em), 0.0
    )


def mis_weight(pdf_a, pdf_b):
    """Power heuristic (beta = 2)."""
    a2 = pdf_a * pdf_a
    w = m.safe_div(a2, a2 + pdf_b * pdf_b)
    return torch.where(pdf_a > 0.0, w, 0.0)


# --------------------------------------------------------------------------
# The emitter stage of a bounce: its routes
# --------------------------------------------------------------------------

FUSED, PLAIN = "fused", "plain"
FUSED_TYPES = frozenset([AREA, CONSTANT])


def route(present, device_type, grad_enabled, requires_grad):
    """The route of one part of a bounce's emitter stage (hit, sample or
    nee), from what the call can observe: FUSED or PLAIN.

    present: the table's emitter types; device_type: the lanes' ("cuda" or
    not); grad_enabled: torch's grad mode; requires_grad: whether a tensor
    input of the part requires grad.

    FUSED (ops/emitter_shade's kernel for the part): CUDA lanes, a table of
    FUSED_TYPES only, and no input requiring grad under grad mode, since
    the kernels hand no gradient back. Everything else is PLAIN, the
    functions above: every CPU call, the envmap and the delta emitters,
    and an input that carries a graph (volpath's NEE point at a medium
    interaction under ad_mode).
    """
    if (device_type == "cuda" and present <= FUSED_TYPES
            and not (grad_enabled and requires_grad)):
        return FUSED
    return PLAIN


def _route(table, part, lanes, inputs):
    """route() for one call of a part, counted in log.Statistics as
    emitter.<route>/<part> (host counts)."""
    grad = torch.is_grad_enabled()
    r = route(table.present, lanes.device.type, grad,
              grad and any(t.requires_grad for t in inputs))
    log.Statistics.get().add(f"emitter.{r}/{part}")
    return r


def hit_term(table, geom, si, ray, L, thr, prev_pdf, prev_delta, mask):
    """L plus what the lanes under `mask` see at this bounce's end: the
    radiance of an area emitter hit (its front) or of the sky an escaped
    ray meets, times thr and the MIS weight against the previous bounce's
    NEE (power heuristic of prev_pdf over NEE's density; 1 after a delta
    lobe). The hit record, the ray origin and prev_pdf feed only that
    weight, which is detached, and the front test, so their graphs
    (volpath's, from a medium point) are cut first. The fused route reads
    no ray direction (an envmap's radiance does, on the plain route): it
    tests the radiance alone."""
    si = si._replace(p=si.p.detach(), n=si.n.detach(), wi=si.wi.detach(),
                     frame=Frame(*(v.detach() for v in si.frame)))
    ray = ray._replace(o=ray.o.detach())
    prev_pdf = prev_pdf.detach()
    if _route(table, "hit", si.p, [table.radiance]) == FUSED:
        e = emitter_shade.hit(table, geom, si, ray.o, prev_pdf, prev_delta, mask)
        return torch.addcmul(L, thr, e)
    return _hit_term_plain(table, geom, si, ray, L, thr, prev_pdf, prev_delta, mask)


def _hit_term_plain(table, geom, si, ray, L, thr, prev_pdf, prev_delta, mask):
    """hit_term's plain route."""
    hit_rad = eval_hit(table, si)
    hit_pdf = pdf_hit_direction(table, geom, si, ray.o)
    bg_rad = eval_background(table, ray.d)
    bg_pdf = pdf_miss_direction(table, ray.d)
    rad = torch.where(si.valid[..., None], hit_rad, bg_rad)
    em_pdf = torch.where(si.valid, hit_pdf, bg_pdf)
    w_mis = torch.where(prev_delta, 1.0, mis_weight(prev_pdf, em_pdf)).detach()
    return L + torch.where(mask[..., None], thr * rad * w_mis[..., None], 0.0)


def sample_nee(table, geom, si, p_ref, sampler, mask, depth_ok, refl_only):
    """The NEE sample of a bounce: (DirectionSample toward an emitter from
    p_ref, its direction in si's shading frame, nee_ok: the lanes whose
    shadow ray is traced, under `mask` with a positive pdf and depth_ok,
    and with refl_only above the horizon). `sampler` sits at the NEE
    draws (three: the emitter, reused for the prim and the sky direction,
    and the position); on the fused route an independent sampler's draws
    are made in the kernel."""
    rows = [table.radiance, table.select.pmf, table.select.cdf, table.prim_dist.pmf,
            table.prim_area, geom.p0, geom.e1, geom.e2]
    if _route(table, "sample", p_ref, rows + [p_ref, *si.frame]) == FUSED:
        if type(sampler) is IndependentSampler:
            draws = dict(lane_key=sampler._lane_key, dim=sampler.base_dim + sampler.dim)
        else:
            draws = dict(u3=torch.stack([sampler.next_1d() for _ in range(3)], -1))
        return emitter_shade.sample(table, geom, si.frame, p_ref, mask, depth_ok, refl_only,
                                    **draws)
    return _sample_nee_plain(table, geom, si, p_ref, sampler, mask, depth_ok, refl_only)


def _sample_nee_plain(table, geom, si, p_ref, sampler, mask, depth_ok, refl_only):
    """sample_nee's plain route."""
    u3 = torch.stack([sampler.next_1d(), sampler.next_1d(), sampler.next_1d()], -1)
    ds = sample_direction(table, geom, p_ref, u3)
    wo_local = si.to_local(ds.d)
    nee_ok = mask & (ds.pdf > 0.0) & depth_ok
    if refl_only:
        nee_ok = nee_ok & (m.cos_theta(wo_local) > 0.0)
    return ds, wo_local, nee_ok


def nee_term(table, ds, pdf_nee, vis, L, a):
    """L plus the NEE term where the shadow ray is clear (vis): a (thr *
    f_nee, or volpath's thr * f * transmittance) times the sample's
    radiance over its pdf, weighted against the BSDF's pdf_nee (power
    heuristic; 1 for a delta emitter). The weight over the pdf is
    detached, so the pdfs' graphs are cut before the route's test."""
    pdf = ds.pdf.detach()
    if _route(table, "nee", pdf, (ds.radiance, pdf, pdf_nee.detach())) == FUSED:
        e = emitter_shade.nee(ds.radiance, pdf, ds.delta, pdf_nee.detach(), vis)
        return torch.addcmul(L, a, e)
    return _nee_term_plain(table, ds, pdf_nee, vis, L, a)


def _nee_term_plain(table, ds, pdf_nee, vis, L, a):
    """nee_term's plain route (`table` unread: nee_term's signature)."""
    w_nee = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, pdf_nee))
    w = m.safe_div(w_nee, ds.pdf).detach()
    return L + torch.where(vis[..., None], a * ds.radiance * w[..., None], 0.0)

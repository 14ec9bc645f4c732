"""Plain versions of the port's kernels K1 and K2 against the JAX package.

K1 (ops/merl_sorted.eval_trilinear) against JAX `tabulated.eval_raw` and
the JAX sorted Pallas kernel in interpret mode; K2
(ops/marginal_sorted.cond_sample_pdf) against the JAX Pallas kernel in
interpret mode. The CUDA kernels themselves run only on a GPU
(tests/test_torch_cuda.py, chip_smoke.py); on CPU tensors the wrappers
run these plain versions and launch nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_customization_tpu.core.distr import Marginal2D
from mitsuba_customization_tpu.core.rusinkiewicz import half_diff_to_dirs
from mitsuba_customization_tpu.models import tabulated as jtab
from mitsuba_customization_tpu.ops import marginal_sorted as jk2
from mitsuba_customization_tpu.ops import merl_sorted as jk1
from mitsuba_customization_tpu_torch.core import distr as tdistr
from mitsuba_customization_tpu_torch.ops import marginal_sorted as tk2
from mitsuba_customization_tpu_torch.ops import merl_sorted as tk1


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run torch's CPU ops on one intra-op thread (the CPU parity tests
    import this fixture). torch's MKL-backed transcendentals (acos, sin,
    sqrt, ...) split their lanes into chunks of 2048 across threads, and now
    and then the first call in a process returns one chunk at reduced
    accuracy (errors ~3e-5 in acos on 3 of 96 fresh processes; none on 192
    processes with one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smooth_table(rng, shape=(16, 16, 32, 3)):
    """A table varying smoothly along all three axes. Its phi_d term
    scales with sin(theta_h)^2 sin(theta_d), as for an isotropic BRDF:
    phi_d is undefined at those poles, where acos/atan2 of two libraries
    may return angles far apart (and border clamping evaluates lanes with
    theta_h ~ 0 at the first theta_h node)."""
    n_th, n_td, n_pd, _ = shape
    th = ((np.arange(n_th) + 0.5) / n_th) ** 2 * (np.pi / 2)
    td = (np.arange(n_td) + 0.5) / n_td * (np.pi / 2)
    pd = (np.arange(n_pd) + 0.5) / n_pd * np.pi
    a = rng.random((3, 3)) * 0.12
    t = (
        0.3
        + a[0] * np.cos(3 * th)[:, None, None, None]
        * np.cos(2 * td)[None, :, None, None]
        + a[1] * np.sin(th)[:, None, None, None] ** 2
        * np.sin(td)[None, :, None, None]
        * np.cos(2 * pd[None, None, :, None] + 10 * a[2])
    )
    return t.astype(np.float32)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v[:, 2] = np.abs(v[:, 2]) + 1e-3
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def k1_lanes(rng, n=2400):
    """Random upper-hemisphere pairs plus border lanes: phi_d at its wrap
    (0 and pi), theta_h at 0 and near pi/2, theta_d near 0 and pi/2, and a
    few lanes below the horizon.

    Near theta_h = 0 the JAX package's two angle formulas part: h.z rounds
    near 1, and dirs_to_half_diff_fast (which K1 reproduces) takes
    sin(theta_h) from 1 - h.z^2. The theta_h = 0 lanes are therefore mirror
    pairs with cos(theta_i) a power of two, whose h is (0, 0, 1) exactly.
    """
    wi, wo = _unit(rng, n), _unit(rng, n)
    k = 64
    th = np.concatenate([rng.uniform(0.2, 0.6, 2 * k), np.full(k, 1.5),
                         rng.uniform(0.02, 0.06, k)])
    td = np.concatenate([rng.uniform(0.3, 0.8, 2 * k), np.full(k, 0.05),
                         np.full(k, 1.5)])
    pd = np.concatenate([rng.uniform(-1e-3, 1e-3, k),
                         np.pi - rng.uniform(0, 1e-3, k),
                         rng.uniform(-np.pi, np.pi, 2 * k)])
    ph = rng.uniform(-np.pi, np.pi, 4 * k)
    bwi, bwo = (np.asarray(x, np.float32) for x in half_diff_to_dirs(
        jnp.asarray(th, jnp.float32), jnp.asarray(ph, jnp.float32),
        jnp.asarray(td, jnp.float32), jnp.asarray(pd, jnp.float32),
    ))
    cz = 0.5 ** rng.integers(1, 5, k)
    phi = rng.uniform(-np.pi, np.pi, k)
    sz = np.sqrt(1.0 - cz * cz)
    pole = np.stack([sz * np.cos(phi), sz * np.sin(phi), cz], -1).astype(np.float32)
    mirror = pole * np.asarray([-1.0, -1.0, 1.0], np.float32)
    wi = np.concatenate([wi, bwi, pole])
    wo = np.concatenate([wo, bwo, mirror])
    wo[:16, 2] *= -1  # below the horizon: f = 0
    return wi, wo


@pytest.mark.parametrize("stacked", [False, True])
def test_k1_plain_matches_jax(stacked):
    rng = np.random.default_rng(1)
    if stacked:
        table = np.stack([smooth_table(rng) for _ in range(3)])
    else:
        table = smooth_table(rng)
    wi, wo = k1_lanes(rng)
    n = wi.shape[0]
    slot = rng.integers(0, 3, n).astype(np.int32) if stacked else None
    mask = rng.random(n) > 0.25

    def t(x):
        return None if x is None else torch.as_tensor(x)

    got = tk1.eval_trilinear_plain(t(table), t(wi), t(wo), t(slot), t(mask))
    assert got.shape == (n, 3) and got.dtype == torch.float32
    got = got.numpy()
    assert np.all(got[~mask] == 0.0) and np.all(got[:16] == 0.0)

    jt, jwi, jwo = jnp.asarray(table), jnp.asarray(wi), jnp.asarray(wo)
    jslot = None if slot is None else jnp.asarray(slot)
    raw = np.asarray(jtab.eval_raw(jt, jwi, jwo, slot=jslot))
    raw = np.where(mask[:, None], raw, 0.0)
    np.testing.assert_allclose(got, raw, rtol=1e-4, atol=1e-5)
    # the TPU kernel carries its fractions in 16-bit fixed point
    srt = np.asarray(jk1.eval_sorted(jt, jwi, jwo, slot=jslot,
                                     mask=jnp.asarray(mask), interpret=True))
    np.testing.assert_allclose(got, srt, rtol=2e-4, atol=1e-5)


def _k2_inputs(rng, n_sl=7, h=32, w=64, n=3000):
    weights = (rng.random((n_sl, h, w)) ** 2 + 1e-4).astype(np.float32)
    weights[0, :, 5:20] = 0.0  # flat CDF stretches
    cdf = np.array(Marginal2D.build(jnp.asarray(weights)).cdf_cond)
    d = dict(
        key=rng.integers(0, n_sl, n).astype(np.int32),
        u_col=rng.random(n).astype(np.float32),
        r_own=rng.integers(0, h, n).astype(np.int32),
        r_nee=rng.integers(0, h, n).astype(np.int32),
        c_nee=rng.integers(0, w, n).astype(np.int32),
        r_cos=rng.integers(0, h, n).astype(np.int32),
        c_cos=rng.integers(0, w, n).astype(np.int32),
        valid=rng.random(n) > 0.2,
    )
    # u at the edges and exactly on CDF values
    d["u_col"][:200] = np.where(np.arange(200) % 2, 0.0, 1.0 - 1e-7)
    d["u_col"][200:300] = cdf[d["key"][200:300], d["r_own"][200:300], 7]
    return cdf, d


_K2_ARGS = ("key", "u_col", "r_own", "r_nee", "c_nee", "r_cos", "c_cos", "valid")


def test_k2_plain_matches_jax_kernel():
    cdf, d = _k2_inputs(np.random.default_rng(2))
    h = cdf.shape[1]
    got = tk2.cond_sample_pdf_plain(
        torch.as_tensor(cdf), *(torch.as_tensor(d[k]) for k in _K2_ARGS)
    )
    want = jk2.cond_sample_pdf(
        jk2.pack_condT(jnp.asarray(cdf)), h,
        *(jnp.asarray(d[k]) for k in _K2_ARGS), interpret=True,
    )
    v = d["valid"]
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_allclose(g[v], w[v], rtol=1e-5, atol=1e-7)
        assert np.all(g[~v] == 0.0)
    x = got[0].numpy()
    assert x.min() >= 0.0 and x.max() <= 1.0  # (idx + dx) / W may round to 1


def test_wrappers_on_cpu_launch_nothing():
    rng = np.random.default_rng(3)
    table = torch.as_tensor(smooth_table(rng))
    wi, wo = (torch.as_tensor(x) for x in k1_lanes(rng, 100))
    cdf, d = _k2_inputs(rng, n=500)
    before = (tk1.LAUNCHES, tk2.LAUNCHES)
    out1 = tk1.eval_trilinear(table, wi, wo)
    out2 = tk2.cond_sample_pdf(
        torch.as_tensor(cdf), *(torch.as_tensor(d[k]) for k in _K2_ARGS)
    )
    assert (tk1.LAUNCHES, tk2.LAUNCHES) == before
    torch.testing.assert_close(out1, tk1.eval_trilinear_plain(table, wi, wo))
    assert len(out2) == 4 and all(o.shape == (500,) for o in out2)


# ---------------------------------------------------------------------------
# The premises of the CUDA designs, checked where the kernels cannot run:
# K2 finds the count of CDF values below u by a lower-bound search, which
# equals _invert_cdf's masked reductions only on nondecreasing rows; K1
# reads each phi_d bin of the natural table as two aligned float2 pairs,
# which must hold the bin and stay inside its sectors and the table.
# ---------------------------------------------------------------------------


def _k2_rows(kind, rng, n_sl=5, h=32, w=64):
    weights = rng.random((n_sl, h, w)).astype(np.float32) ** 2
    if kind == "zero_heavy":
        weights *= rng.random((n_sl, h, w)) < 0.1
        weights[0, :4] = 0.0  # rows of weight 1e-20 per cell
    cdf = tdistr.Marginal2D.build(torch.as_tensor(weights)).cdf_cond
    return cdf.reshape(-1, w)


def _k2_lanes(rows, rng, n=20_000):
    """Each lane's row and u: uniform, 0, 1 - 1e-7, 1, and exactly on a
    value of its row."""
    pick = torch.as_tensor(rng.integers(0, rows.shape[0], n))
    u = torch.as_tensor(rng.random(n).astype(np.float32))
    u[:500], u[500:1000], u[1000:1500] = 0.0, 1.0 - 1e-7, 1.0
    col = torch.as_tensor(rng.integers(0, rows.shape[1], n))
    u[1500:6000] = rows[pick, col][1500:6000]
    return rows[pick], u


def _search_kernel_steps(rows, u):
    """csrc/cond_sample.cu's search, all lanes at once: the lower bound of
    u in row[0 .. W-2], W-1 if every one of those is below u."""
    lane = torch.arange(rows.shape[0])
    c = torch.zeros_like(lane)
    length = torch.full_like(lane, rows.shape[1] - 1)
    while bool((length > 0).any()):
        half = length >> 1
        probe = rows[lane, (c + half).clamp(max=rows.shape[1] - 1)]
        go = (length > 0) & (probe < u)
        c = torch.where(go, c + half + 1, c)
        length = torch.where(go, length - half - 1, torch.where(length > 0, half, 0))
    hi = rows[lane, c]
    below = torch.where(c > 0, rows[lane, (c - 1).clamp(min=0)], 0.0)
    lo = torch.minimum(torch.where(hi < u, hi, below), hi)
    return c, lo, hi - lo


@pytest.mark.parametrize("kind", ["random", "zero_heavy"])
@pytest.mark.parametrize("search", ["searchsorted", "kernel_steps"])
def test_invert_cdf_is_a_lower_bound(kind, search):
    """On Marginal2D rows, _invert_cdf's (idx, lo, mass) equal a
    lower-bound search with lo and hi read at cnt - 1 and cnt, bit for
    bit, flat runs and u on a value included."""
    rng = np.random.default_rng(11)
    rows = _k2_rows(kind, rng)
    assert bool((rows[:, 1:] >= rows[:, :-1]).all())  # nondecreasing
    if kind == "zero_heavy":
        assert bool((rows[:, 1:] == rows[:, :-1]).any())  # flat runs
    lane_rows, u = _k2_lanes(rows, rng)
    idx, lo, mass = tdistr._invert_cdf(lane_rows, u)
    w = rows.shape[1]
    if search == "searchsorted":
        cnt = torch.searchsorted(lane_rows, u[:, None], right=False)[:, 0]
        lane = torch.arange(u.shape[0])
        hi = lane_rows[lane, cnt.clamp(max=w - 1)]
        lo_s = torch.where(cnt > 0, lane_rows[lane, (cnt - 1).clamp(min=0)], 0.0)
        lo_s = torch.minimum(lo_s, hi)
        got = (cnt.clamp(max=w - 1), lo_s, hi - lo_s)
    else:
        got = _search_kernel_steps(lane_rows, u)
    for g, want in zip(got, (idx, lo, mass)):
        assert torch.equal(g, want)


def _bin_reads(table):
    """What csrc/merl_eval.cu's bin_rgb reads for every phi_d bin of the
    flat table: off = 3 * bin; e = off rounded down to even; the float2
    pairs [e, e + 2) and [e + 2, e + 4), or three scalars where e + 4 would
    pass the end. Returns (the 3 floats it keeps, the float indices of
    both pairs, -1 where scalars were read)."""
    flat = table.reshape(-1)
    off = torch.arange(0, flat.numel(), 3)
    e = off & ~1
    paired = e + 4 <= flat.numel()
    idx = torch.where(paired[:, None], e[:, None] + torch.arange(4), -1)
    window = flat[idx.clamp(min=0)]
    odd = (off != e)[:, None]
    kept = torch.where(odd, window[:, 1:4], window[:, 0:3])
    kept = torch.where(paired[:, None], kept, flat[off[:, None] + torch.arange(3)])
    return kept, idx, off


@pytest.mark.parametrize("shape", [(16, 16, 32, 3), (3, 5, 3, 7, 3), (2, 3, 2, 3, 3)])
def test_k1_bin_reads_hold_the_bin(shape):
    """The kernel's float2 reads of the natural table give every bin's 3
    floats, touch only 8-byte pairs that hold one of them (so no sector
    beyond the bin's own), and read past the end of the table nowhere.
    Only a table of an odd number of floats (the kernel's kOddTotal
    instance; here 3 x 5 x 3 x 7 x 3) has its last bin at an even offset,
    read by scalars; elsewhere every bin takes the branch-free path."""
    table = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    kept, idx, off = _bin_reads(table)
    assert torch.equal(kept, table.reshape(-1, 3))
    paired = idx[:, 0] >= 0
    assert bool((idx[paired] < table.numel()).all())
    pair_of = idx[paired] // 2  # the 8-byte pair each read float lies in
    needed = (off[paired, None] + torch.arange(3)) // 2
    assert bool((pair_of[..., None] == needed[:, None, :]).any(-1).all())
    assert bool(paired[:-1].all())
    assert bool(paired[-1]) == bool(off[-1] % 2 == 1)  # table.numel() even


def test_k1_halves_on_cpu_are_the_joined_lanes():
    """With wo_b, the CPU wrapper evaluates [wi ; wi] x [wo ; wo_b] with the
    slot repeated and the masks joined (a missing one all set)."""
    rng = np.random.default_rng(13)
    table = torch.as_tensor(np.stack([smooth_table(rng) for _ in range(2)]))
    wi, wo = (torch.as_tensor(x) for x in k1_lanes(rng, 300))
    wo_b = torch.as_tensor(k1_lanes(rng, 300)[1])
    n = wi.shape[0]
    slot = torch.as_tensor(rng.integers(0, 2, n))
    mask = torch.as_tensor(rng.random(n) > 0.3)
    before = tk1.LAUNCHES
    got = tk1.eval_trilinear(table, wi, wo, slot, None, wo_b, mask)
    assert tk1.LAUNCHES == before and got.shape == (2 * n, 3)
    want = tk1.eval_trilinear_plain(
        table, torch.cat([wi, wi]), torch.cat([wo, wo_b]), torch.cat([slot, slot]),
        torch.cat([torch.ones(n, dtype=torch.bool), mask]))
    assert torch.equal(got, want)


def test_k1_bound_counts_a_call_as_made():
    """chip_smoke's K1 bound on a call of two halves: wi and the slot once
    for the lanes where either half is live, wo of live lanes only, the
    masks and the output of every lane, and table bins only for lanes that
    evaluate (live, both cosines > 0), at most the table."""
    import chip_smoke as cs

    n = 1000
    wi = torch.zeros((n, 3))
    wi[:, 2] = 1.0
    wo, wo_b = wi.clone(), wi.clone()
    wo_b[:60, 2] = -1.0  # live but below the horizon: no bins
    table = torch.zeros((2, 4, 4, 8, 3))
    slot = torch.zeros(n, dtype=torch.int64)
    none = torch.zeros(n, dtype=torch.bool)
    mask, mask_b = none.clone(), none.clone()
    mask[:100] = True
    mask_b[50:150] = True
    per_ms = cs.HBM_BYTES_PER_S / 1e3
    lane_io = 2 * n * (1 + 12)  # the two masks and outputs
    assert cs.k1_bound(table, wi, wo, slot, none, wo_b, none)[0] * per_ms \
        == pytest.approx(lane_io)
    # 150 lanes live in either half, 200 live, 190 evaluate
    bins = min(table.numel() * 4, 190 * cs.K1_CELL_BYTES)
    want = bins + 150 * (12 + 8) + 200 * 12 + lane_io
    ms, by = cs.k1_bound(table, wi, wo, slot, mask, wo_b, mask_b)
    assert by == "bytes" and ms * per_ms == pytest.approx(want)
    big = torch.zeros((2, 40, 40, 80, 3))
    assert cs.k1_bound(big, wi, wo, slot, mask, wo_b, mask_b)[0] * per_ms \
        == pytest.approx(want - bins + 190 * cs.K1_CELL_BYTES)
    # one lane set, no slot, no mask: every lane live, wi once
    assert cs.k1_bound(big, wi, wo)[0] * per_ms \
        == pytest.approx(n * (cs.K1_CELL_BYTES + 12 + 12 + 12))


def test_k1_bwd_bound_counts_a_call_as_made():
    """chip_smoke's K1-backward bound: K1's lane inputs as the K1 bound
    counts them, the cotangent of the live lanes, and the clamp test's
    bins of the lanes that evaluate with a nonzero cotangent; with K1's
    output, that output of those lanes and the bins only where it is 0 in
    a channel whose cotangent is not; the dense gradient written once, or,
    into a given buffer, the bins the call adds to read and written once.
    No per-lane output."""
    import chip_smoke as cs

    n = 1000
    wi = torch.zeros((n, 3))
    wi[:, 2] = 1.0
    wo, wo_b = wi.clone(), wi.clone()
    wo_b[:60, 2] = -1.0  # live but below the horizon: no bins
    table = torch.zeros((2, 4, 4, 8, 3))
    dense = table.numel() * 4
    slot = torch.zeros(n, dtype=torch.int64)
    none = torch.zeros(n, dtype=torch.bool)
    mask, mask_b = none.clone(), none.clone()
    mask[:100] = True
    mask_b[50:150] = True
    g = torch.ones((2 * n, 3))
    per_ms = cs.HBM_BYTES_PER_S / 1e3
    assert cs.k1_bwd_bound(table, g, wi, wo, slot, none, wo_b, none)[0] * per_ms \
        == pytest.approx(2 * n + dense)
    # 150 lanes live in either half, 200 live, 190 evaluate
    lane_io = 150 * (12 + 8) + 200 * (12 + 12) + 2 * n
    want = min(dense, 190 * cs.K1_CELL_BYTES) + lane_io + dense
    ms, by = cs.k1_bwd_bound(table, g, wi, wo, slot, mask, wo_b, mask_b)
    assert by == "bytes" and ms * per_ms == pytest.approx(want)
    # on a table past 190 lanes' bins: a lane with no cotangent reads none
    big = torch.zeros((2, 40, 40, 80, 3))
    dense = big.numel() * 4
    g0 = g.clone()
    g0[:30] = 0.0
    assert cs.k1_bwd_bound(big, g0, wi, wo, slot, mask, wo_b, mask_b)[0] * per_ms \
        == pytest.approx(160 * cs.K1_CELL_BYTES + lane_io + dense)
    # K1's output: 0 in a channel on 60 evaluating lanes, whose cotangent
    # there is 0 on 20 of them: 40 read their bins
    value = torch.ones((2 * n, 3))
    value[:60, 1] = 0.0
    g[40:60, 1] = 0.0
    with_value = lane_io + 190 * 12 + 40 * cs.K1_CELL_BYTES
    assert cs.k1_bwd_bound(big, g, wi, wo, slot, mask, wo_b, mask_b, value=value)[0] \
        * per_ms == pytest.approx(with_value + dense)
    # into a buffer: every lane is in one cell (theta_h = theta_d = 0), whose
    # 8 bins are read and written once in place of the dense gradient
    ms = cs.k1_bwd_bound(big, g, wi, wo, slot, mask, wo_b, mask_b, value=value,
                         out=torch.zeros_like(big))[0]
    assert ms * per_ms == pytest.approx(with_value + 8 * 2 * cs.K1_BIN_BYTES)


@pytest.mark.parametrize("index_dtype", [torch.int64, torch.int32])
def test_k2_bound_counts_a_call_as_made(index_dtype):
    """chip_smoke's K2 bound: the indices (at their width) and u of live
    lanes, the mask and four outputs of every lane, a CDF row a live lane
    (at most the stack)."""
    import chip_smoke as cs

    n = 1000
    idx = torch.zeros(n, dtype=index_dtype)
    u = torch.zeros((n, 2))[:, 1]
    valid = torch.zeros(n, dtype=torch.bool)
    valid[:300] = True
    per_ms = cs.HBM_BYTES_PER_S / 1e3
    lanes = (idx, u, idx, idx, idx, idx, idx, valid)
    for cdf in (torch.zeros((2, 4, 64)), torch.zeros((64, 32, 64))):
        want = (min(cdf.numel() * 4, 300 * cs.K2_ROW_BYTES)
                + 300 * (6 * idx.element_size() + 4) + n * (1 + 16))
        assert cs.k2_bound(cdf, *lanes)[0] * per_ms == pytest.approx(want)

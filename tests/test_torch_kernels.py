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

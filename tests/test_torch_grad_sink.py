"""The table's gradient in one buffer per backward pass (ops/merl_sorted
GradSink), on the CPU, where K1's backward is its plain version
(index_add_ into the same buffer).

A render's K1 calls take the sink's token as their differentiable input
and add their backward into one table-shaped buffer, which the sink hands
to the table once. Held here: the step's table gradient against the sum of
the standalone backward over the K1 calls it made, the one buffer, the two
ways of asking autograd, two renders in one loss, the primal render, and
the accumulating and saved-output forms of the backward. Inputs come from
seeds; every tolerance is stated where it is used.
"""

import numpy as np
import pytest
import torch

import mitsuba_customization_tpu_torch as mt
from mitsuba_customization_tpu_torch.models import bsdf as tbsdf
from mitsuba_customization_tpu_torch.ops import merl_sorted as tk1
from mitsuba_customization_tpu_torch.render import ad
from mitsuba_customization_tpu_torch.render import params as tparams
from mitsuba_customization_tpu_torch.scenes import matpreview_dict
from test_torch_kernels import k1_lanes, one_torch_thread  # noqa: F401

TABLE = "bsdf.tabulated.table"
ALPHA = "bsdf.roughconductor.alpha_u"


def _scene(compact):
    """Three MERL bands on a small blob and a GGX floor under the area
    light, 16x16, depth 3; compaction on (caps above the live counts, so
    it re-sorts lanes, out of place under AD) or off."""
    d = matpreview_dict(16, 2, 3, n_sub=3, n_materials=3,
                        compact=(1.0, 1.0, 1.0) if compact else None)
    return mt.load_dict(d, "cpu")


def _params(scene):
    full = tparams.traverse(scene)
    return {k: full[k] for k in (TABLE, ALPHA)}


def _rel_l2(got, want):
    return float((got - want).double().norm() / want.double().norm())


@pytest.mark.parametrize("compact", [False, True])
def test_one_buffer_holds_the_sum_of_the_calls(monkeypatch, compact):
    """grad_render allocates one table-shaped buffer, and its table
    gradient is the sum of the standalone backward (no K1 output, a
    gradient of its own) over the K1 calls the backward made, within 1e-6
    relative L2 (the same addends summed in another order)."""
    scene = _scene(compact)
    calls = []
    orig = tk1.eval_trilinear_bwd

    def recording(table, g, *lanes, **kw):
        calls.append((table, g.clone(), lanes))
        return orig(table, g, *lanes, **kw)

    monkeypatch.setattr(tk1, "eval_trilinear_bwd", recording)
    before = tk1.GRAD_BUFFERS
    _, grads = ad.grad_render(scene, _params(scene), torch.full((16, 16, 3), 0.05),
                              spp=2, seed=3)
    assert tk1.GRAD_BUFFERS == before + 1
    assert len(calls) >= 2
    summed = sum(tk1.eval_trilinear_bwd_plain(t, g, *tk1.concat_halves(*lanes))
                 for t, g, lanes in calls)
    assert bool((summed != 0).any())
    assert _rel_l2(grads[TABLE], summed) <= 1e-6


def test_backward_and_autograd_grad_agree():
    """The same loss through loss.backward() (the buffer lands in the
    leaf's .grad) and torch.autograd.grad, table and alpha: equal within
    rtol 1e-6 (both run the same backward)."""
    scene = _scene(True)
    target = torch.full((16, 16, 3), 0.05)

    def loss_of(p):
        return torch.mean((ad.render_ad(scene, p, spp=2, seed=4) - target) ** 2)

    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in _params(scene).items()}
    loss_of(leaves).backward()
    again = {k: v.detach().clone().requires_grad_(True) for k, v in _params(scene).items()}
    grads = torch.autograd.grad(loss_of(again), list(again.values()))
    for (k, leaf), gr in zip(leaves.items(), grads):
        assert bool((gr != 0).any()), k
        torch.testing.assert_close(leaf.grad, gr, rtol=1e-6, atol=0)


def test_two_renders_in_one_loss_sum():
    """Two render_ad calls on one table leaf in one loss: each has its own
    sink and buffer (two buffers), and autograd sums their two gradients
    at the leaf: within 1e-6 relative L2 of the sum of the two renders'
    gradients taken apart."""
    scene = _scene(False)
    target = torch.full((16, 16, 3), 0.05)
    table = _params(scene)[TABLE]

    def loss_of(leaf, seed):
        img = ad.render_ad(scene, {TABLE: leaf}, spp=2, seed=seed)
        return torch.mean((img - target) ** 2)

    apart = []
    for seed in (5, 6):
        leaf = table.detach().clone().requires_grad_(True)
        apart.append(torch.autograd.grad(loss_of(leaf, seed), leaf)[0])
    leaf = table.detach().clone().requires_grad_(True)
    before = tk1.GRAD_BUFFERS
    (both,) = torch.autograd.grad(loss_of(leaf, 5) + loss_of(leaf, 6), leaf)
    assert tk1.GRAD_BUFFERS == before + 2
    assert _rel_l2(both, apart[0] + apart[1]) <= 1e-6


def test_primal_render_makes_no_sink():
    """No sink where no gradient is wanted: a loaded scene, a table that
    does not require grad, or update under no_grad. The primal render then
    allocates no buffer and builds no graph; a table that requires grad
    gets a sink whose token carries the graph."""
    scene = _scene(False)
    assert scene.bsdfs.stacks[tbsdf.TABULATED].sink is None
    table = _params(scene)[TABLE]
    leaf = table.detach().clone().requires_grad_(True)
    assert tparams.update(scene, {TABLE: table}).bsdfs.stacks[tbsdf.TABULATED].sink is None
    with torch.no_grad():
        quiet = tparams.update(scene, {TABLE: leaf})
    assert quiet.bsdfs.stacks[tbsdf.TABULATED].sink is None
    sink = tparams.update(scene, {TABLE: leaf}).bsdfs.stacks[tbsdf.TABULATED].sink
    assert sink is not None and sink.token.requires_grad and sink.token.dim() == 0
    before = tk1.GRAD_BUFFERS
    img = mt.render(scene, spp=2, seed=0)
    assert img.grad_fn is None and not img.requires_grad
    assert tk1.GRAD_BUFFERS == before


def _k1_case(rng, n=500):
    """A stacked table with negative entries (K1's clamp matters), two
    halves of lanes sharing wi and the slot, masks and a cotangent."""
    table = torch.as_tensor((rng.random((3, 6, 5, 8, 3)) - 0.2).astype(np.float32))
    wi, wo = k1_lanes(rng, n)
    wo_b = k1_lanes(rng, n)[1]
    m = wi.shape[0]
    lanes = (torch.as_tensor(wi), torch.as_tensor(wo), torch.as_tensor(rng.integers(0, 3, m)),
             torch.as_tensor(rng.random(m) > 0.25), torch.as_tensor(wo_b),
             torch.as_tensor(rng.random(m) > 0.4))
    return table, lanes, torch.as_tensor(rng.normal(size=(2 * m, 3)).astype(np.float32))


def test_backward_forms_on_cpu():
    """eval_trilinear_bwd's forms on CPU tensors (its plain version):
    handed K1's output, bit-equal to reading the bins for the clamp test
    (on a table with negative entries, where some outputs are 0); two
    calls into one `out` equal the sum of the two standalone gradients,
    each bin within 1e-5 of the sum of its terms' magnitudes (the same
    float32 terms in another order, where signed terms cancel); `out` is
    returned, and a wrong `out` raises."""
    rng = np.random.default_rng(31)
    table, lanes, g = _k1_case(rng)
    value = tk1.eval_trilinear(table, *lanes)
    assert bool((value == 0).any()) and bool((value > 0).any())
    plain = tk1.eval_trilinear_bwd(table, g, *lanes)
    assert torch.equal(tk1.eval_trilinear_bwd(table, g, *lanes, value=value), plain)
    g2 = torch.as_tensor(rng.normal(size=g.shape).astype(np.float32))
    out = torch.zeros_like(table)
    before = tk1.GRAD_BUFFERS
    got = tk1.eval_trilinear_bwd(table, g, *lanes, value=value, out=out)
    got = tk1.eval_trilinear_bwd(table, g2, *lanes, value=value, out=got)
    assert got is out and tk1.GRAD_BUFFERS == before
    want = plain + tk1.eval_trilinear_bwd(table, g2, *lanes)
    absum = (tk1.eval_trilinear_bwd(table, g.abs(), *lanes)
             + tk1.eval_trilinear_bwd(table, g2.abs(), *lanes))
    assert bool(((out - want).abs() <= 1e-5 * absum).all())
    for bad in (torch.zeros(table.shape[1:]), torch.zeros_like(table).transpose(1, 2)):
        with pytest.raises(ValueError):
            tk1.eval_trilinear_bwd(table, g, *lanes, out=bad)


def test_sink_gradient_reaches_a_computed_table():
    """A table computed from a parameter (here the whole table scaled by
    s, as the finite-difference test of the table does) gets the sink's
    buffer as its gradient, and autograd carries it on to s: dL/ds equals
    <dL/dtable, table0> within rtol 1e-5."""
    scene = _scene(False)
    table0 = _params(scene)[TABLE]
    target = torch.full((16, 16, 3), 0.05)
    s = torch.tensor(1.0, requires_grad=True)
    scaled = table0 * s
    scaled.retain_grad()
    img = ad.render_ad(scene, {TABLE: scaled}, spp=2, seed=7)
    torch.mean((img - target) ** 2).backward()
    torch.testing.assert_close(s.grad, (scaled.grad * table0).sum(), rtol=1e-5, atol=0)

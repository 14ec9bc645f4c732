"""Checkpoints (utils/checkpoint.py) and the optimiser choice of
render/ad.Optimizer.

A round trip of parameters and a torch Adam state_dict, resumed into a new
Optimizer, takes the same next step as the run that never stopped; a
params checkpoint written by the JAX package's save_checkpoint (with and
without an optax state) loads into the port with equal values, and one
written by the port loads into the JAX package; latest_step; Optimizer
with torch.optim.SGD (one step is p - lr g), a factory, and the optax-
default Adam with clip_nonneg.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mitsuba_customization_tpu.utils import checkpoint as jckpt
from mitsuba_customization_tpu_torch.render.ad import Optimizer
from mitsuba_customization_tpu_torch.utils import checkpoint as tckpt
from test_torch_kernels import one_torch_thread  # noqa: F401


def _params(rng):
    return {"bsdf.tabulated.table": torch.as_tensor(rng.random((2, 3, 4, 3), np.float32)),
            "bsdf.roughconductor.alpha_u": torch.as_tensor(rng.random(1, np.float32)),
            "emitter.radiance": torch.as_tensor(rng.random((2, 3), np.float32))}


def _grads(rng, params):
    return {k: torch.as_tensor(rng.normal(size=v.shape).astype(np.float32))
            for k, v in params.items()}


def test_round_trip_resumes_the_same_step(tmp_path):
    rng = np.random.default_rng(0)
    params = _params(rng)
    g1, g2 = _grads(rng, params), _grads(rng, params)
    keys = list(params)
    run = Optimizer(params, 0.05, None, keys)
    run.step(g1)
    assert tckpt.latest_step(tmp_path / "ck") == -1
    tckpt.save_checkpoint(tmp_path / "ck", 1, run.params, run.opt.state_dict(), seed=7,
                          extra={"note": "x"})
    assert tckpt.latest_step(tmp_path / "ck") == 1
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["meta.json", "state.npz"]
    step, p2, opt_state, seed = tckpt.load_checkpoint(tmp_path / "ck", params)
    assert (step, seed) == (1, 7)
    for k in keys:
        assert torch.equal(p2[k], run.params[k]) and p2[k].dtype == params[k].dtype
    resumed = Optimizer(p2, 0.05, None, keys)
    resumed.opt.load_state_dict(opt_state)
    want = run.step(g2)
    got = resumed.step(g2)
    for k in keys:
        assert torch.equal(got[k], want[k]), k


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    """JAX flattens {"opt_state", "params"} in sorted-key order, so the
    params are the file's last leaves: they load with equal values, with
    or without the optax state in front of them."""
    rng = np.random.default_rng(1)
    params = _params(rng)
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    like = {k: torch.zeros_like(v) for k, v in params.items()}
    opt = optax.adam(0.01)
    for name, state in (("bare", None), ("optax", opt.init(jparams))):
        jckpt.save_checkpoint(tmp_path / name, 3, jparams, state, seed=2)
        step, got, opt_state, seed = tckpt.load_checkpoint(tmp_path / name, like)
        assert (step, seed, opt_state) == (3, 2, None)
        for k in params:
            np.testing.assert_array_equal(got[k].numpy(), params[k].numpy())


def test_port_checkpoint_loads_into_jax(tmp_path):
    rng = np.random.default_rng(2)
    params = _params(rng)
    tckpt.save_checkpoint(tmp_path / "ck", 5, params, seed=4)
    like = {k: jnp.zeros(v.shape) for k, v in params.items()}
    step, got, _, seed = jckpt.load_checkpoint(tmp_path / "ck", like)
    assert (step, seed) == (5, 4)
    for k in params:
        np.testing.assert_array_equal(np.asarray(got[k]), params[k].numpy())


def test_latest_step_of_nothing(tmp_path):
    assert tckpt.latest_step(tmp_path) == -1
    (tmp_path / "meta.json").write_text("{")
    assert tckpt.latest_step(tmp_path) == -1


@pytest.mark.parametrize("form", ["class", "factory"])
def test_optimizer_choice(form):
    """Optimizer(optimizer=torch.optim.SGD) builds SGD(params, lr=lr); a
    factory receives the parameter list. One SGD step is p - lr g (as
    torch forms it, p.add(g, alpha=-lr): one rounding), then clip_nonneg
    clamps its keys at 0."""
    rng = np.random.default_rng(3)
    params = _params(rng)
    grads = _grads(rng, params)
    lr = 0.3
    optimizer = (torch.optim.SGD if form == "class"
                 else lambda ps: torch.optim.SGD(ps, lr=lr))
    opt = Optimizer(params, lr, optimizer, ["emitter.radiance"])
    assert isinstance(opt.opt, torch.optim.SGD)
    got = opt.step(grads)
    for k, p in params.items():
        want = p.add(grads[k], alpha=-lr)
        if k == "emitter.radiance":
            want = want.clamp(min=0.0)
        assert torch.equal(got[k].detach(), want), k


def test_optimizer_default_is_adam_and_rejects_others():
    opt = Optimizer({"x": torch.ones(2)}, 0.5)
    assert isinstance(opt.opt, torch.optim.Adam)
    with pytest.raises(TypeError, match="optimizer"):
        Optimizer({"x": torch.ones(2)}, 0.5, "sgd")

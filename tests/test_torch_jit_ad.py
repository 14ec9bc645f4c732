"""The port's compiled AD step (render/ad._loss_and_grad behind
grad_render, parallel/mesh.loss_and_grad_sharded_jit) on the CPU, where
the step's plan and body run with no graph.

- grad_render (the captured step) equals the eager step bit for bit on
  the flagship, the matpreview scene with its probed schedule, the camera
  scene (thin lens, multijitter, gaussian splat), the blend scene, a mesh
  scene on the BVH, the volpath scene with a density grid (the four
  medium keys: the 48-step masked tracking scan), a homogeneous medium
  under the path integrator and an SDF scene (S1's march), at two seeds;
- _loss_and_grad agrees with the JAX package's jitted _loss_and_grad
  within test_torch_ad.py::test_frame_gradients_match_jax's tolerances;
- the step's body, forward and backward, passes the capture-safety guard
  of tests/test_torch_jit.py (the kernels' plain versions, K1's backward
  among them, run outside it), on those scenes and on an envmap scene
  differentiated in emitter.env_image;
- the step cache: new values in the same keys and shapes plan nothing new
  and are read; another key set or a changed config plans a new step;
- loss_and_grad_sharded_jit on 2 gloo ranks equals loss_and_grad_sharded
  (box and gaussian), and on one rank grad_render (the JAX package's
  tests/test_parallel.py::test_sharded_grads_match_single and
  ::test_sharded_grads_gaussian_matches_single, mirrored).

Inputs are made from a seed (numpy, the scene dicts); one torch thread.
The gloo ranks are subprocesses of this file (`__main__`), which import
no JAX.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mitsuba_customization_tpu_torch as mt
from mitsuba_customization_tpu_torch import scenes
from mitsuba_customization_tpu_torch.parallel import mesh as pm
from mitsuba_customization_tpu_torch.render import ad, frame_graph
from mitsuba_customization_tpu_torch.render import params as tparams
from test_torch_kernels import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TABLE = "bsdf.tabulated.table"
ALPHA = "bsdf.roughconductor.alpha_u"

MEDIUM_KEYS = ("medium.sigma_t", "medium.albedo", "medium.phase_g", "medium.density")
# the parameters each test scene differentiates
KEYS = {"flagship": (TABLE, ALPHA, "emitter.radiance"),
        "matpreview_probed": (TABLE, ALPHA),
        "camera": (TABLE,),
        "blend": (TABLE,),
        "bvh": (TABLE, ALPHA),
        "volpath": MEDIUM_KEYS,
        "media": ("medium.sigma_t", "medium.albedo"),
        "sdf": ("emitter.radiance",)}


def _params(scene, keys):
    full = mt.traverse(scene)
    return {k: full[k] for k in keys}


def _target(scene, value=0.0):
    cfg = scene.config
    return torch.full((cfg.height, cfg.width, 3), value)


def _assert_steps_equal(got, want):
    (gl, gg), (wl, wg) = got, want
    assert torch.equal(gl, wl), (float(gl), float(wl))
    assert list(gg) == list(wg)
    for k in wg:
        assert torch.equal(gg[k], wg[k]), k


@pytest.fixture
def jit_scene(monkeypatch, root_on_path):
    from test_torch_jit import _scene

    return lambda name: _scene(name, monkeypatch)


@pytest.fixture
def root_on_path(monkeypatch):
    monkeypatch.syspath_prepend(ROOT)


@pytest.mark.parametrize("name", list(KEYS))
def test_grad_render_equals_the_eager_step(name, jit_scene):
    """The captured step's plan and body on the CPU: the same passes as the
    eager step, a seed tensor in place of the int, the parameters and the
    target copied into the step's buffers; loss and every gradient bit for
    bit at two seeds, one step planned for both."""
    scene, spp = jit_scene(name)
    params = _params(scene, KEYS[name])
    target = _target(scene, 0.1)
    plans = frame_graph.PLANS
    for seed in (0, 7):
        want = ad._eager_loss_and_grad(scene, params, target, spp, seed)
        got = ad.grad_render(scene, params, target, spp, seed)
        _assert_steps_equal(got, want)
        assert any(bool((g != 0).any()) for g in got[1].values())
    assert frame_graph.PLANS == plans + 1


def test_loss_and_grad_matches_jax_loss_and_grad():
    """The port's _loss_and_grad against the JAX package's jitted
    _loss_and_grad (through its grad_render) on the scene of
    test_torch_ad.py::test_frame_gradients_match_jax (the flagship at res
    16, spp 2, depth 2), with that test's tolerances: loss rtol 1e-5;
    table relative L2 error <= 2e-3 with the same nonzero cells; alpha
    rtol 1e-3."""
    import jax.numpy as jnp
    from __graft_entry__ import _flagship_scene
    from mitsuba_customization_tpu.render import ad as jad
    from mitsuba_customization_tpu.render import params as jparams
    from mitsuba_customization_tpu_torch.render.params import scene_from_numpy
    from test_torch_render import _arrays

    js = _flagship_scene(res=16, spp=2, depth=2)
    keys = (TABLE, ALPHA, "bsdf.roughconductor.alpha_v")
    full = jparams.traverse(js)
    jl, jg = jad.grad_render(js, {k: full[k] for k in keys}, jnp.zeros((16, 16, 3)), spp=2,
                             seed=0)
    ts = scene_from_numpy(_arrays(js), js.config, "cpu")
    p = tparams.params_from_numpy({k: np.asarray(full[k]) for k in keys}, "cpu")
    tl, tg = ad._loss_and_grad(ts, p, 2, 0, torch.zeros((16, 16, 3)))

    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    got, want = tg[TABLE].numpy(), np.asarray(jg[TABLE])
    assert np.isfinite(got).all() and (want != 0).any()
    assert np.linalg.norm(got - want) <= 2e-3 * np.linalg.norm(want)
    np.testing.assert_array_equal(got != 0, want != 0)
    for k in keys[1:]:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), rtol=1e-3)


def _envmap_scene():
    from test_torch_emitters import _envmap_sphere

    d = _envmap_sphere()
    d["sensor"]["film"].update(width=12, height=12)
    d["sensor"]["sampler"]["sample_count"] = 2
    return mt.load_dict(d, "cpu"), 2


GUARDED = list(KEYS) + ["env_image"]


@pytest.mark.parametrize("name", GUARDED)
def test_step_body_is_capture_safe(name, jit_scene, monkeypatch):
    """The captured step's body, forward and backward (params.update with
    its CDF rebuild and GradSink, rows_body in ad_mode with its
    checkpointed bounces and their replay, develop, the MSE,
    torch.autograd.grad), runs no host operator under
    test_torch_jit._Guard: nothing of its _HOST_OPS, no bool-mask index,
    no Tensor.tolist / item / numpy, no torch.as_tensor or from_numpy. The
    kernels' plain versions (K1, K1's backward, K2, K3 / K4, B1 / B2, S1)
    run outside the guard: on the card the kernels launch in their place.
    The guard sees the backward's operators."""
    from test_torch_jit import PLAINS, _Guard, _outside_the_guard

    from mitsuba_customization_tpu_torch.ops import merl_sorted

    if name == "env_image":
        scene, spp = _envmap_scene()
        keys = ("emitter.env_image", ALPHA)
    else:
        scene, spp = jit_scene(name)
        keys = KEYS[name]
    ad.grad_render(scene, _params(scene, keys), _target(scene), spp, 0)  # plans the step
    step = frame_graph.latest()
    assert step.grad and len(step.inputs) == 1 + len(keys)
    for mod, fns in PLAINS + ((merl_sorted, ("eval_trilinear_bwd_plain",)),):
        for fn in fns:
            monkeypatch.setattr(mod, fn, _outside_the_guard(getattr(mod, fn)))

    class Guard(_Guard):
        backward_ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if torch._C._current_graph_task_id() != -1:
                self.backward_ops += 1
            return super().__torch_dispatch__(func, types, args, kwargs)

    guard = Guard()

    def recorded(what, fn):
        def run(*args, **kwargs):
            from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

            if guard in _get_current_dispatch_mode_stack():  # not in a plain version
                guard.found.append(what)
            return fn(*args, **kwargs)

        return run

    for obj, fn in ((torch.Tensor, "tolist"), (torch.Tensor, "item"), (torch.Tensor, "numpy"),
                    (torch, "as_tensor"), (torch, "from_numpy")):
        monkeypatch.setattr(obj, fn, recorded(fn, getattr(obj, fn)))
    with torch.enable_grad(), guard:
        (loss, *grads), _ = step.body(step.seed, *step.inputs)
    assert guard.found == [], sorted(set(guard.found))
    assert guard.backward_ops > 0
    assert bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all()) for g in grads)
    assert all(bool((g != 0).any()) for g in grads)


def test_a_new_step_is_planned_for_new_keys_or_config_not_new_values():
    """The step key: new values in the same keys and shapes plan nothing
    new, and the step reads them (it equals the eager step on them);
    another key set plans a new step, and so does a changed scene.config;
    the target's values are read too."""
    scene = mt.load_dict(scenes.flagship_dict(12, 2, 2), "cpu")
    params = _params(scene, (TABLE, ALPHA))
    target = _target(scene)
    frame_graph.clear()
    first = ad.grad_render(scene, params, target, 2, 1)
    plans = frame_graph.PLANS
    new = {TABLE: params[TABLE] * 0.5, ALPHA: params[ALPHA] + 0.1}
    got = ad.grad_render(scene, new, target + 0.2, 2, 1)
    assert frame_graph.PLANS == plans
    _assert_steps_equal(got, ad._eager_loss_and_grad(scene, new, target + 0.2, 2, 1))
    assert not torch.equal(got[0], first[0])
    ad.grad_render(scene, {ALPHA: params[ALPHA]}, target, 2, 1)
    assert frame_graph.PLANS == plans + 1
    scene.config.rfilter = "gaussian"
    got = ad.grad_render(scene, params, target, 2, 1)
    assert frame_graph.PLANS == plans + 2
    _assert_steps_equal(got, ad._eager_loss_and_grad(scene, params, target, 2, 1))
    # the step shares the frames' cache
    assert len(frame_graph._FRAMES) <= frame_graph.CACHE_SIZE
    frame_graph.clear()


def test_optimize_runs_through_the_captured_step():
    """optimize's steps go through grad_render's captured step: one step
    planned for all of them, and the losses those of the eager step on the
    same parameters (the optimiser's update eager, as optax's in the JAX
    package)."""
    scene = mt.load_dict(scenes.flagship_dict(8, 2, 2), "cpu")
    target = mt.render(scene, 2, 0)
    start = tparams.update(scene, {ALPHA: torch.full_like(mt.traverse(scene)[ALPHA], 0.4)})
    frame_graph.clear()
    plans = frame_graph.PLANS
    seen = []
    p, losses = ad.optimize(start, target, [ALPHA], n_steps=3, lr=0.05, spp=2,
                            callback=lambda it, loss, params: seen.append(
                                params[ALPHA].detach().clone()))
    assert frame_graph.PLANS == plans + 1
    alphas = [torch.full_like(seen[0], 0.4)] + seen[:-1]
    for it, (alpha, loss) in enumerate(zip(alphas, losses)):
        want, _ = ad._eager_loss_and_grad(start, {ALPHA: alpha}, target, 2, it + 1)
        assert float(want) == loss, it
    assert not torch.equal(p[ALPHA], alphas[0])
    frame_graph.clear()


def _sharded_dict(rfilter):
    d = scenes.variant_dict(16, 4, 3, rfilter=rfilter)
    d["integrator"] = {"type": "path", "max_depth": 3}
    return d


def _worker(rfilter, rank, world, store, out):
    """One gloo rank: loss_and_grad_sharded and loss_and_grad_sharded_jit
    (at two seeds, the second a replay of the step the first planned) of
    the filter's scene, saved to out/rank<r>.npz."""
    torch.set_num_threads(1)
    pm.initialize_distributed(f"file://{store}", world, rank, device="cpu", timeout=60)
    scene = mt.load_dict(_sharded_dict(rfilter), "cpu")
    mesh = pm.make_mesh()
    params = _params(scene, (TABLE, ALPHA))
    target = _target(scene, 0.1)
    res = {}
    for seed in (0, 3):
        for what, fn in (("eager", pm.loss_and_grad_sharded),
                         ("jit", pm.loss_and_grad_sharded_jit)):
            loss, grads = fn(scene, params, target, mesh, 4, seed)
            res[f"{what}{seed}_loss"] = loss.numpy()
            for k, g in grads.items():
                res[f"{what}{seed}_{k}"] = g.numpy()
    res["plans"] = frame_graph.PLANS
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    torch.distributed.destroy_process_group()


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("rfilter", ["box", "gaussian"])
def test_loss_and_grad_sharded_jit_equals_loss_and_grad_sharded(tmp_path, rfilter, world):
    """On 2 gloo ranks (subprocesses of this file meeting through a file://
    store; 60 s group timeout, 120 s wait) every rank's
    loss_and_grad_sharded_jit loss and gradients equal its
    loss_and_grad_sharded ones bit for bit at two seeds, one step planned
    (box: the slab step in one body; gaussian: the split step, the halo
    exchange between its forward and backward); on one rank (no process
    group) loss_and_grad_sharded_jit equals grad_render and
    loss_and_grad_sharded bit for bit."""
    keys = (TABLE, ALPHA)
    if world == 1:
        scene = mt.load_dict(_sharded_dict(rfilter), "cpu")
        params, target = _params(scene, keys), _target(scene, 0.1)
        for seed in (0, 3):
            got = pm.loss_and_grad_sharded_jit(scene, params, target, None, 4, seed)
            _assert_steps_equal(got, ad.grad_render(scene, params, target, 4, seed))
            _assert_steps_equal(got, pm.loss_and_grad_sharded(scene, params, target, None, 4,
                                                              seed))
        return
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, HERE, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, __file__, rfilter, str(r), str(world), str(tmp_path / "store"),
         str(tmp_path)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    outs = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]
    for o in outs:
        assert int(o["plans"]) == 1
        for seed in (0, 3):
            for what in ("loss",) + keys:
                np.testing.assert_array_equal(o[f"jit{seed}_{what}"], o[f"eager{seed}_{what}"])
                np.testing.assert_array_equal(o[f"jit{seed}_{what}"],
                                              outs[0][f"jit{seed}_{what}"])
    assert outs[0]["jit0_loss"] != outs[0]["jit3_loss"]
    assert (outs[0][f"jit0_{TABLE}"] != 0).any()


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:6])

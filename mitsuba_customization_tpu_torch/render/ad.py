"""Differentiable rendering: path-replay gradients and the
inverse-rendering loop.

PyTorch port of mitsuba_customization_tpu/render/ad.py (mitsuba3's
python/ad/integrators/prb.py and ad/optimizers.py). The reference's `prb`
replays each path during the backward with the same random numbers; here
that follows from the integrator (render/integrator.trace_paths,
ad_mode=True): the sampler is a pure function of (seed, lane, dimension),
the estimator detaches sampling decisions, pdfs and MIS weights, and each
bounce runs under torch.utils.checkpoint, so the backward runs it forward
again instead of keeping its graph. The MERL table's gradient is K1's
backward kernel (ops/merl_sorted.eval_trilinear_bwd).

`render_ad` is the differentiable entry, `grad_render` one (loss,
gradients) evaluation of the MSE against a target, `Optimizer` Adam (or
any torch.optim optimiser, in place of optax's) over a parameter dict and
`optimize` the
loop of BASELINE configs[3]: recover MERL tables or GGX roughness from a
reference render by pixel-gradient descent, rebuilding the sampling CDFs
from the new table at every step.

`grad_render` runs the JAX package's jitted `_loss_and_grad` for every
integrator: on the card one CUDA graph of the forward and the backward
(`captured_step`, render/frame_graph.py), captured once per scene, spp,
parameter keys and shapes and target shape, and replayed with the seed,
the parameters and the target copied into its buffers. `params.update`
runs inside it, so the table's sampling CDFs are rebuilt and its GradSink
made in the step, as in the JAX jit. A step's phases are spans (update,
forward, backward; utils/log.py), in the captured and the eager step
alike; `Optimizer.step` is the span optimizer.
"""

from __future__ import annotations

import torch

from mitsuba_customization_tpu_torch.render import frame_graph
from mitsuba_customization_tpu_torch.render import params as params_mod
from mitsuba_customization_tpu_torch.render.integrator import (
    TRACERS,
    _integrator_kind,
    develop,
    plan_rows,
    render,
    rows_body,
    rows_inputs,
    tracer,
)
from mitsuba_customization_tpu_torch.utils import log


def render_ad(scene, params, spp=None, seed=0, max_depth=None):
    """The image as a differentiable function of the parameter dict
    (keys of params.traverse): gradients reach `params`' tensors."""
    with log.span("update"):
        scene_p = params_mod.update(scene, params)
    return render(scene_p, spp=spp, seed=seed, max_depth=max_depth,
                  ad_mode=True)


def gradients(out, leaves, g=None):
    """torch.autograd.grad of `out` (cotangent g) with respect to the
    tensors `leaves`; zeros for a leaf `out` does not depend on. The span
    backward, which the checkpoint's recompute on autograd's device thread
    nests under."""
    with log.span("backward", shared=True):
        grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
        return tuple(torch.zeros_like(v) if gr is None else gr for v, gr in zip(leaves, grads))


def _eager_loss_and_grad(scene, params, target, spp, seed):
    """grad_render's step run eagerly (render_ad, the MSE, autograd): the
    captured step's counterpart, which the checks of the eager kernels'
    calls take and chip_smoke times beside its replay."""
    leaves = {k: v if v.requires_grad else v.detach().requires_grad_(True)
              for k, v in params.items()}
    with log.span("update"):
        scene_p = params_mod.update(scene, leaves)
    with log.span("forward"):
        img = render(scene_p, spp=spp, seed=seed, ad_mode=True)
        loss = torch.mean((img - target) ** 2)
    return loss.detach(), dict(zip(leaves, gradients(loss, list(leaves.values()))))


def captured_step(key, scene, params, seed, target, make_loss):
    """(loss, {key: gradient}) of a loss of params.update(scene, params) as
    a captured step (render/frame_graph.py): one leaf a parameter and a
    target buffer, the caller's values copied in at each call; on the card
    the update, the forward, the loss and torch.autograd.grad are one CUDA
    graph. make_loss() -> (what the loss reads besides the scene, kept
    with the step; loss(scene_p, seed_t, target_t) -> (the loss, its bounce
    counters or None: Frame.counters)), called when the step
    is planned. The step is kept per `key` (which holds the plan), each
    parameter's key, shape, type and device, and the target's shape and
    type (and the scene's part)."""
    keys = tuple(params)

    def make():
        keep, loss_of = make_loss()
        statics = (frame_graph.buffers([target])
                   + frame_graph.buffers(params.values(), requires_grad=True))

        def body(seed_t, target_t, *leaves):
            with log.span("update"):
                scene_p = params_mod.update(scene, dict(zip(keys, leaves)))
            with log.span("forward"):
                loss, counters = loss_of(scene_p, seed_t, target_t)
            return (loss.detach(),) + gradients(loss, leaves), counters

        return {"body": body, "keep": keep, "inputs": statics, "grad": True}

    step = frame_graph.frame((key, keys, frame_graph.input_key(params.values()),
                              frame_graph.input_key([target])), scene, make)
    loss, *grads = step(seed, target, *params.values())
    return loss, dict(zip(keys, grads))


def rows_loss(scene, plan, loss_of):
    """captured_step's make_loss for a RowsPlan of `scene`: loss_of(out,
    target) of rows_body's out of the plan in ad_mode, its inputs made
    and kept with the step."""
    def make():
        inputs = rows_inputs(scene, plan)
        def loss(scene_p, seed_t, target_t):
            out, counters = rows_body(scene_p, plan, inputs, seed_t, True)
            return loss_of(out, target_t), counters

        return inputs, loss

    return make


def _loss_and_grad(scene, params, spp, seed, target):
    """The JAX package's jitted step (its arguments, in its order): the MSE
    between render_ad(scene, params, spp, seed) and `target` and its
    gradients, as a captured step (captured_step) of render's passes over
    the whole image, developed, or of a light tracer's body. Bit for bit
    the eager step's on the CPU; on the card equal to it up to the order
    of K1-bwd's and a splat's atomic adds."""
    cfg = scene.config
    spp = int(spp or cfg.spp)
    kind = _integrator_kind(scene, None)
    with log.span("frame.plan"):
        plan = (tracer(kind).plan(scene, spp) if kind in TRACERS
                else plan_rows(scene, spp, None, None, 0, cfg.height))
    if kind in TRACERS:
        mod = tracer(kind)

        def make_loss():
            return None, lambda scene_p, seed_t, target_t: (torch.mean(
                (mod.body(scene_p, plan, seed_t)[0] - target_t) ** 2), None)
    else:
        make_loss = rows_loss(scene, plan,
                              lambda out, t: torch.mean((develop(cfg, out) - t) ** 2))
    return captured_step(("loss_and_grad", plan), scene, params, seed, target, make_loss)


def grad_render(scene, params, target, spp=16, seed=0):
    """One evaluation of the MSE between render_ad(scene, params) and
    `target` (H, W, 3): returns (loss, {key: gradient}); a parameter the
    image does not depend on gets zeros. Runs _loss_and_grad, the
    captured step, for every integrator and scene (the span frame.call)."""
    with log.span("frame.call"):
        return _loss_and_grad(scene, params, spp, seed, target)


class Optimizer:
    """mi.ad.Adam over a scene-parameter dict, on copies of the given
    tensors: `optimizer` None is torch.optim.Adam(lr), as optax.adam(lr)
    in the JAX package; otherwise a torch.optim.Optimizer subclass (built
    as optimizer(params, lr=lr)) or a factory taking the list of parameter
    tensors and returning an optimiser (the torch counterparts of "any
    optax optimiser"). The keys in clip_nonneg are clamped to >= 0 after
    each step (BRDF tables, albedos, roughness)."""

    def __init__(self, params, lr=0.01, optimizer=None, clip_nonneg=None):
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in params.items()}
        tensors = list(self.params.values())
        if optimizer is None:
            self.opt = torch.optim.Adam(tensors, lr=lr)
        elif isinstance(optimizer, type) and issubclass(optimizer, torch.optim.Optimizer):
            self.opt = optimizer(tensors, lr=lr)
        elif callable(optimizer):
            self.opt = optimizer(tensors)
        else:
            raise TypeError(f"optimizer must be None, a torch.optim.Optimizer class or a "
                            f"factory of the parameter list, not {optimizer!r}")
        self.clip_nonneg = set(clip_nonneg or [])

    def step(self, grads):
        """One optimiser step with the gradients {key: tensor}; returns the
        parameter dict (the span optimizer)."""
        with log.span("optimizer"):
            for k, p in self.params.items():
                p.grad = grads[k]
            self.opt.step()
            self.opt.zero_grad(set_to_none=True)
            with torch.no_grad():
                for k in self.clip_nonneg & set(self.params):
                    self.params[k].clamp_(min=0.0)
            return self.params


def optimize(scene, target, param_keys, n_steps=50, lr=0.02, spp=16, seed0=0,
             callback=None):
    """Inverse-rendering loop: recover the parameters `param_keys` by
    pixel-gradient descent against `target`, starting from the scene's
    own values.

    Returns (params, losses). Step `it` renders with seed seed0 + it + 1
    (decorrelated Monte Carlo gradients) and rebuilds the sampling CDFs
    from the current table (params.update), through grad_render's
    captured step (the optimiser's update runs eagerly, as optax's runs
    outside the JAX package's jit). callback(it, loss, params) is
    called after each step.
    """
    full = params_mod.traverse(scene)
    opt = Optimizer({k: full[k] for k in param_keys}, lr=lr,
                    clip_nonneg=param_keys)
    losses = []
    for it in range(n_steps):
        loss, grads = grad_render(scene, opt.params, target, spp=spp,
                                  seed=seed0 + it + 1)
        opt.step(grads)
        losses.append(float(loss))
        if callback is not None:
            callback(it, losses[-1], opt.params)
    return opt.params, losses

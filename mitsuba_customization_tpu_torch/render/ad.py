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
"""

from __future__ import annotations

import torch

from mitsuba_customization_tpu_torch.render import params as params_mod
from mitsuba_customization_tpu_torch.render.integrator import render


def render_ad(scene, params, spp=None, seed=0, max_depth=None):
    """The image as a differentiable function of the parameter dict
    (keys of params.traverse): gradients reach `params`' tensors."""
    scene_p = params_mod.update(scene, params)
    return render(scene_p, spp=spp, seed=seed, max_depth=max_depth,
                  ad_mode=True)


def grad_render(scene, params, target, spp=16, seed=0):
    """One evaluation of the MSE between render_ad(scene, params) and
    `target` (H, W, 3): returns (loss, {key: gradient}); a parameter the
    image does not depend on gets zeros."""
    leaves = {k: v if v.requires_grad else v.detach().requires_grad_(True)
              for k, v in params.items()}
    img = render_ad(scene, leaves, spp=spp, seed=seed)
    loss = torch.mean((img - target) ** 2)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {
        k: torch.zeros_like(v) if gr is None else gr
        for (k, v), gr in zip(leaves.items(), grads)
    }


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
        parameter dict."""
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
    from the current table (params.update). callback(it, loss, params) is
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

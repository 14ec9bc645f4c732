"""Top-level user API: load_dict / render / traverse.

PyTorch port of mitsuba_customization_tpu/api.py, mitsuba3's Python layer:
mi.load_dict -> load_dict, mi.render -> render, mi.traverse -> traverse.
"""

from __future__ import annotations


def load_dict(d, device="cuda"):
    """Build a Scene from a nested dict description (mi.load_dict schema)
    on `device`: the card unless the caller names another."""
    from mitsuba_customization_tpu_torch.render.scene import load_dict as _load

    return _load(d, device)


def render(scene, spp=None, seed=0, integrator=None, max_depth=None, ad_mode=False,
           return_stats=False):
    """Render a scene; returns an (H, W, 3) image tensor (mi.render), with
    render/integrator.render's arguments in its order.

    spp=None uses the scene sampler's sample_count (mi.render semantics)."""
    from mitsuba_customization_tpu_torch.render.integrator import render as _render

    return _render(scene, spp, seed, integrator, max_depth, ad_mode, return_stats)


def traverse(scene):
    """Return the dict of differentiable scene parameters (mi.traverse)."""
    from mitsuba_customization_tpu_torch.render.params import traverse as _traverse

    return _traverse(scene)

"""The port's top-level API (api.py, the package exports) against the JAX
package's: load_dict / render / traverse / look_at exported; `render`
still renders after `import mitsuba_customization_tpu_torch.render.xml`
rebinds the package attribute to the render module (the callable module
of the JAX package's render/__init__.py), with render's arguments in its
order; traverse equals render/params.traverse.
"""

import importlib

import torch

import mitsuba_customization_tpu as mct
import mitsuba_customization_tpu_torch as mt
from mitsuba_customization_tpu_torch.render import integrator as tint
from mitsuba_customization_tpu_torch.render import params as tparams
from mitsuba_customization_tpu_torch.scenes import flagship_dict
from test_torch_kernels import one_torch_thread  # noqa: F401


def test_exports_match_the_reference():
    assert {"load_dict", "render", "traverse"} <= set(mt.__all__)
    for name in ("load_dict", "render", "traverse"):
        assert callable(getattr(mt, name)) and callable(getattr(mct, name))
    assert callable(mt.look_at)


def test_render_module_is_callable_after_a_submodule_import():
    importlib.import_module("mitsuba_customization_tpu_torch.render.xml")
    assert callable(mt.render)
    scene = mt.load_dict(flagship_dict(8, 2, 3), "cpu")
    want = tint.render(scene, 2, 1, "path", 2)
    assert torch.equal(mt.render(scene, 2, 1, "path", 2), want)
    assert torch.equal(mt.render(scene, spp=2, seed=1, max_depth=2), want)
    img, stats = mt.render(scene, 2, 1, None, 2, False, True)
    assert torch.equal(img, want) and stats["rays_traced"] > 0
    from mitsuba_customization_tpu_torch import api

    assert torch.equal(api.render(scene, 2, 1, "path", 2), want)


def test_traverse_is_params_traverse():
    scene = mt.load_dict(flagship_dict(8, 2, 3), "cpu")
    got, want = mt.traverse(scene), tparams.traverse(scene)
    assert list(got) == list(want)
    for k in want:
        assert got[k] is want[k] or torch.equal(got[k], want[k]), k

"""Rendering: rays and hits, camera, film, emitters, scene, integrator.

`render_jit` (integrator.render_jit, the captured frame) is exported
here too, imported at first use."""

# `import mitsuba_customization_tpu_torch.render.x` rebinds the package
# attribute `render` from api.render (the function) to this module; making
# the module callable keeps the mi.render-style entry `mt.render(scene,
# ...)` working either way.
import sys as _sys
import types as _types


class _CallableRenderModule(_types.ModuleType):
    def __call__(self, *args, **kwargs):
        from mitsuba_customization_tpu_torch.api import render as _render

        return _render(*args, **kwargs)


_sys.modules[__name__].__class__ = _CallableRenderModule


def __getattr__(name):
    if name == "render_jit":
        from mitsuba_customization_tpu_torch.render.integrator import render_jit

        return render_jit
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

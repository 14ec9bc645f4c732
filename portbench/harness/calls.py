"""Recording the calls of the port's hand-written kernels at their Python
wrappers, on an eager call outside the window: a captured replay calls no
wrapper, and launches the same kernels as the eager call it was captured
from."""

from __future__ import annotations

import contextlib
import importlib


@contextlib.contextmanager
def recording(kernels, facts):
    """Within the block every wrapper named by a kernel module's WRAPPER
    records each call as kernel.record(args, kwargs, out), with `facts`
    (the scene's prim count) added, unless record returns None (a wrapper
    that launches more than one kernel); yields {kernel name: [record,
    ...]}."""
    calls = {name: [] for name in kernels}
    saved = []
    try:
        for name, k in kernels.items():
            mod = importlib.import_module(k.WRAPPER[0])
            fn = getattr(mod, k.WRAPPER[1])

            def wrapped(*args, _fn=fn, _k=k, _name=name, **kwargs):
                out = _fn(*args, **kwargs)
                rec = _k.record(args, kwargs, out)
                if rec is not None:  # a call of another kernel behind one wrapper
                    calls[_name].append(dict(rec, **facts))
                return out

            saved.append((mod, k.WRAPPER[1], fn))
            setattr(mod, k.WRAPPER[1], wrapped)
        yield calls
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)

"""Normal mapping. The port carries only the no-op path of
mitsuba_customization_tpu/models/normalmap.apply_normal_maps: the scene
loader rejects normal and bump maps, so no material binds one."""

from __future__ import annotations


def apply_normal_maps(bsdfs, si):
    """Return si unchanged: no material of a ported scene binds a normal
    map."""
    return si

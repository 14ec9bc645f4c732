"""Mitsuba-XML scene loader: scene.xml -> load_dict schema -> Scene.

PyTorch port of mitsuba_customization_tpu/render/xml.py (mitsuba3
src/core/xml.cpp's xml::load_file and the 0.6 SceneHandler). It parses the
Mitsuba scene XML dialect:

* <default name="spp" value="64"/> declarations and $var substitution,
  overridable by caller-supplied parameters (the CLI's -D flag);
* property tags: integer/float/boolean/string/rgb/spectrum/point/vector;
* <transform> blocks (translate/rotate/scale/lookat/matrix, composed in
  document order);
* <ref id=.../> material references and id'd top-level <bsdf> declarations;
* "filename" strings resolved against the XML file's directory, <rfilter>
  flattened to its type string, and <include filename=.../>.

The output is a load_dict-schema dict, so both entry points share one
compilation path (render/scene.py).
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np


def load_file(path, *, device="cuda", **defines):
    """mi.load_file: parse a Mitsuba XML scene and compile it on `device`
    (the card unless the caller names another)."""
    from mitsuba_customization_tpu_torch.render.scene import load_dict

    return load_dict(parse_file(path, **defines), device)


def parse_file(path, **defines):
    """Parse scene XML into the load_dict schema (no compilation)."""
    path = Path(path)
    root = ET.parse(path).getroot()
    if root.tag != "scene":
        raise ValueError(f"{path}: root element must be <scene>")
    ctx = _Context(path.parent, defines)
    for el in root:
        if el.tag == "default":
            name = el.get("name")
            ctx.vars.setdefault(name, el.get("value"))
    return _parse_scene(root, ctx)


class _Context:
    def __init__(self, base_dir, defines):
        self.base_dir = Path(base_dir)
        self.vars = {k: str(v) for k, v in defines.items()}
        self.counter = 0

    def subst(self, value):
        if value is None:
            return None

        def repl(mo):
            key = mo.group(1)
            if key not in self.vars:
                raise ValueError(f"undefined scene variable ${key}")
            return self.vars[key]

        return re.sub(r"\$(\w+)", repl, value)

    def unique(self, prefix):
        self.counter += 1
        return f"{prefix}_{self.counter}"


def _floats(s):
    return [float(x) for x in re.split(r"[ ,]+", s.strip()) if x]


def _parse_value(el, ctx):
    """Property tag -> python value."""
    tag = el.tag
    v = ctx.subst(el.get("value"))
    if tag == "integer":
        return int(v)
    if tag == "float":
        return float(v)
    if tag == "boolean":
        return v.lower() == "true"
    if tag == "string":
        return v
    if tag in ("rgb", "spectrum"):
        vals = _floats(v)
        if len(vals) == 1:
            vals = vals * 3
        return vals
    if tag in ("point", "vector"):
        if v is not None:
            return _floats(v)
        return [
            float(ctx.subst(el.get(a, "0"))) for a in ("x", "y", "z")
        ]
    if tag == "transform":
        return _parse_transform(el, ctx)
    raise ValueError(f"unsupported property tag <{tag}>")


def _parse_transform(el, ctx):
    mat = np.eye(4)
    for child in el:
        t = child.tag
        if t == "translate":
            m_ = np.eye(4)
            m_[:3, 3] = [
                float(ctx.subst(child.get(a, "0"))) for a in ("x", "y", "z")
            ]
        elif t == "scale":
            m_ = np.eye(4)
            if child.get("value") is not None:
                s = float(ctx.subst(child.get("value")))
                sc = [s, s, s]
            else:
                sc = [
                    float(ctx.subst(child.get(a, "1")))
                    for a in ("x", "y", "z")
                ]
            m_[:3, :3] = np.diag(sc)
        elif t == "rotate":
            axis = np.asarray(
                [float(ctx.subst(child.get(a, "0"))) for a in ("x", "y", "z")]
            )
            if np.linalg.norm(axis) == 0:
                axis = np.asarray([0.0, 0.0, 1.0])
            axis = axis / np.linalg.norm(axis)
            ang = np.deg2rad(float(ctx.subst(child.get("angle", "0"))))
            x, y, z = axis
            c, s = np.cos(ang), np.sin(ang)
            m_ = np.eye(4)
            m_[:3, :3] = [
                [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
                [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
                [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
            ]
        elif t == "lookat":
            from mitsuba_customization_tpu_torch.render.sensors import look_at

            m_ = look_at(
                _floats(ctx.subst(child.get("origin"))),
                _floats(ctx.subst(child.get("target"))),
                _floats(ctx.subst(child.get("up", "0, 1, 0"))),
            ).astype(np.float64)
        elif t == "matrix":
            vals = _floats(ctx.subst(child.get("value")))
            m_ = np.asarray(vals).reshape(4, 4)
        else:
            raise ValueError(f"unsupported transform op <{t}>")
        mat = m_ @ mat
    return mat.astype(np.float32)


def _parse_object(el, ctx):
    """Plugin element (<bsdf>, <shape>, <emitter>, ...) -> nested dict."""
    out = {"type": el.get("type")}
    for child in el:
        tag = child.tag
        name = child.get("name")
        if tag in ("integer", "float", "boolean", "string", "rgb",
                   "spectrum", "point", "vector", "transform"):
            value = _parse_value(child, ctx)
            if tag == "string" and name == "filename":
                value = str((ctx.base_dir / value).resolve())
            out[name] = value
        elif tag == "ref":
            out[child.get("name") or "bsdf"] = child.get("id")
        elif tag in ("bsdf", "emitter", "film", "sampler", "rfilter",
                     "shape", "sensor", "integrator", "texture"):
            key = child.get("name") or tag
            obj = _parse_object(child, ctx)
            if tag == "rfilter":
                out[key] = obj.get("type", "box")
            else:
                out[key] = obj
        elif tag == "default":
            ctx.vars.setdefault(child.get("name"), child.get("value"))
        else:
            raise ValueError(f"unsupported element <{tag}> in <{el.tag}>")
    return out


def _parse_scene(root, ctx):
    d = {"type": "scene"}
    for el in root:
        tag = el.tag
        if tag == "default":
            continue
        if tag in ("integrator", "sensor", "emitter", "shape", "bsdf"):
            obj = _parse_object(el, ctx)
            if tag == "integrator":
                d["integrator"] = obj
                continue
            key = el.get("id") or ctx.unique(tag)
            d[key] = obj
        elif tag == "include":
            sub = parse_file(
                ctx.base_dir / ctx.subst(el.get("filename")), **ctx.vars
            )
            for k, v in sub.items():
                if k != "type":
                    d[ctx.unique("inc_" + k)] = v
        else:
            raise ValueError(f"unsupported top-level element <{tag}>")
    return d

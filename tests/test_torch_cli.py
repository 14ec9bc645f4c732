"""The port's command line (cli.py) on the CPU.

main() on the three scene formats (.xml with -D, .json, and .py with
`scene_dict` or `make_scene(**defines)`), with -o .npy / .exr,
--integrator, --depth, --spp, --seed and --device cpu: the written image
equals the port's render of the same scene with the same arguments, bit
for bit. --sharded at a world of one (no process group) writes the same
image. The output-extension gap with the JAX CLI is recorded: the port
writes by extension (EXR float-exact), the JAX CLI hands every extension
but .npy to its PNG writer, which refuses .exr.
"""

import json
import logging

import numpy as np
import pytest
import torch

import mitsuba_customization_tpu_torch as mt
from mitsuba_customization_tpu_torch import cli
from mitsuba_customization_tpu_torch.render import xml as txml
from mitsuba_customization_tpu_torch.utils.io import read_image
from test_torch_kernels import one_torch_thread  # noqa: F401
from test_xml import XML


def scene_dict(res=8, spp=4):
    """A JSON-serialisable scene: a diffuse and a GGX sphere over a floor
    under an area light and a sky."""
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 4},
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": {"look_at": {"origin": [0, 1, -4], "target": [0, 0, 0]}},
                   "film": {"width": res, "height": res},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "a": {"type": "sphere", "center": [-0.7, 0, 0], "radius": 0.6,
              "bsdf": {"type": "diffuse", "reflectance": [0.7, 0.4, 0.3]}},
        "b": {"type": "sphere", "center": [0.7, 0, 0], "radius": 0.6,
              "bsdf": {"type": "roughconductor", "alpha": 0.2}},
        "floor": {"type": "rectangle", "bsdf": {"type": "diffuse"},
                  "to_world": {"rotate": {"axis": [1, 0, 0], "angle": -90}, "scale": 5.0,
                               "translate": [0, -0.6, 0]}},
        "light": {"type": "rectangle", "emitter": {"type": "area", "radiance": 6.0},
                  "to_world": {"rotate": {"axis": [1, 0, 0], "angle": 90},
                               "translate": [0.5, 3, -1]}},
        "sky": {"type": "constant", "radiance": 0.2},
    }


PY_DICT = "from test_torch_cli import scene_dict\nscene_dict = scene_dict(8, 4)\n"
PY_MAKE = ("from test_torch_cli import scene_dict\n\n\ndef make_scene(res='8', spp='4'):\n"
           "    return scene_dict(int(res), int(spp))\n")


def _run(*argv):
    assert cli.main([str(a) for a in argv] + ["--device", "cpu"]) == 0


def test_xml_with_defines(tmp_path):
    """-D spp=6 reaches the sampler; --seed and --depth reach render."""
    p = tmp_path / "s.xml"
    p.write_text(XML)
    out = tmp_path / "img.npy"
    _run(p, "-D", "spp=6", "-o", out, "--seed", 3, "--depth", 2)
    scene = txml.load_file(p, device="cpu", spp=6)
    assert scene.config.spp == 6
    assert np.array_equal(np.load(out), mt.render(scene, None, 3, None, 2).numpy())


def test_json_integrator_spp(tmp_path):
    p = tmp_path / "s.json"
    p.write_text(json.dumps(scene_dict()))
    out = tmp_path / "img.npy"
    _run(p, "-o", out, "--integrator", "direct", "--spp", 2)
    want = mt.render(mt.load_dict(scene_dict(), "cpu"), 2, 0, "direct")
    assert np.array_equal(np.load(out), want.numpy())


@pytest.mark.parametrize("form", ["scene_dict", "make_scene"])
def test_python_scene(tmp_path, form):
    p = tmp_path / "s.py"
    p.write_text(PY_DICT if form == "scene_dict" else PY_MAKE)
    out = tmp_path / "img.npy"
    defines = ["-D", "res=12", "-D", "spp=2"] if form == "make_scene" else []
    _run(p, "-o", out, *defines)
    want = mt.render(mt.load_dict(scene_dict(*((12, 2) if defines else (8, 4))), "cpu"))
    assert np.load(out).shape == tuple(want.shape)
    assert np.array_equal(np.load(out), want.numpy())


def test_sharded_at_a_world_of_one(tmp_path):
    """--sharded without a process group: one slab, the whole image."""
    p = tmp_path / "s.json"
    p.write_text(json.dumps(scene_dict()))
    out = tmp_path / "img.npy"
    _run(p, "-o", out, "--sharded", "--seed", 1)
    assert not torch.distributed.is_initialized()
    want = mt.render(mt.load_dict(scene_dict(), "cpu"), None, 1)
    assert np.array_equal(np.load(out), want.numpy())


def test_output_by_extension_and_the_jax_cli_gap(tmp_path, caplog):
    """The port writes -o x.exr as OpenEXR, float-exact; the JAX CLI hands
    every extension but .npy to its PNG writer, which raises for .exr
    (Pillow has no EXR writer). The port logs the load and render lines
    the JAX CLI logs."""
    from mitsuba_customization_tpu import cli as jcli

    p = tmp_path / "s.json"
    p.write_text(json.dumps(scene_dict(4, 1)))
    ours, theirs = tmp_path / "port.exr", tmp_path / "jax.exr"
    with caplog.at_level(logging.INFO, logger="mitsuba_customization_tpu_torch"):
        _run(p, "-o", ours)
    assert any("rendered 4x4 @ 1 spp" in r.getMessage() for r in caplog.records)
    assert ours.read_bytes()[:4] == b"\x76\x2f\x31\x01"  # OpenEXR magic
    want = mt.render(mt.load_dict(scene_dict(4, 1), "cpu")).numpy()
    assert np.array_equal(read_image(ours), want)
    with pytest.raises(ValueError, match="extension"):
        jcli.main([str(p), "-o", str(theirs)])
    assert not theirs.exists()


def test_bad_define_and_format(tmp_path):
    with pytest.raises(SystemExit):
        cli.main([str(tmp_path / "s.xml"), "-D", "spp"])
    p = tmp_path / "s.yaml"
    p.write_text("")
    with pytest.raises(ValueError, match="unsupported scene format"):
        _run(p)

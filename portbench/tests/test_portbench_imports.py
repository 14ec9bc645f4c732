"""What the benchmark loads: never JAX or the JAX package (top-level names
compared whole, since the port's name begins with the JAX package's), and
nothing of the port in the plain reference."""

import json
import subprocess
import sys

from portbench.harness import files

FORBIDDEN = {"jax", "jaxlib", "flax", "mitsuba_customization_tpu"}


def _modules(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, cwd=files.ROOT, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(files.ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_small_run_loads_no_jax():
    loaded = _modules(
        "from portbench import run\n"
        "from portbench.tests.test_portbench_run_cpu import SMALL\n"
        "out, _ = run.run_cell('matpreview-frame', 7, 0.5, False, 'cpu', overrides=SMALL)\n"
        "assert out['correct']")
    assert "mitsuba_customization_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    loaded = _modules(
        "from portbench.harness import files\n"
        "ref = files.reference('path_tracer')\n"
        "d = files.load_module(files.PKG / 'configs' / 'matpreview.py').build(8, 1, 2, n_sub=1)\n"
        "import torch\n"
        "ref.render_pixels(ref.Scene(d, 'cpu'), 3, torch.arange(4))")
    assert not loaded & (FORBIDDEN | {"mitsuba_customization_tpu_torch"})

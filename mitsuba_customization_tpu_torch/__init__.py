"""PyTorch + CUDA port of mitsuba_customization_tpu for NVIDIA Hopper.

A differentiable path tracer for measured (MERL) BRDFs beside analytic,
transmissive and blended materials, participating media, and light and
bidirectional tracers: `load_dict(d, device="cuda")` compiles a scene dict
onto the card (or the device named; without a card it raises),
`render/xml.load_file` does the same for a Mitsuba XML file, `render(scene,
spp, seed, integrator)` returns an (H, W, 3) image ((H, W, 6) for
`moment`) and `traverse(scene)` its differentiable parameters; `cli.py` is
the command line and `parallel/mesh.py` shards a frame's rows over the
ranks of torch.distributed. The hot kernels
(MERL eval and its backward, CDF sampling, cluster traversal) are
hand-written CUDA (csrc/), built at first use; on CPU tensors their plain
PyTorch versions run instead. This package imports neither JAX nor the JAX
package, which stays in the repository as the reference.
"""

from mitsuba_customization_tpu_torch.api import load_dict, render, traverse
from mitsuba_customization_tpu_torch.render.sensors import look_at

__all__ = ["load_dict", "render", "traverse", "look_at"]

"""PyTorch + CUDA port of mitsuba_customization_tpu for NVIDIA Hopper.

A differentiable path tracer for measured (MERL) BRDFs beside analytic,
transmissive and blended materials, participating media, and light and
bidirectional tracers: `load_dict(d, device="cuda")` compiles a scene dict
onto the card (or the device named; without a card it raises) and
`render(scene, spp, seed, integrator)` returns an (H, W, 3) image ((H, W,
6) for `moment`). The hot kernels
(MERL eval and its backward, CDF sampling, cluster traversal) are
hand-written CUDA (csrc/), built at first use; on CPU tensors their plain
PyTorch versions run instead. This package imports neither JAX nor the JAX
package, which stays in the repository as the reference.
"""

from mitsuba_customization_tpu_torch.render.integrator import render
from mitsuba_customization_tpu_torch.render.scene import load_dict
from mitsuba_customization_tpu_torch.render.sensors import look_at

__all__ = ["load_dict", "render", "look_at"]

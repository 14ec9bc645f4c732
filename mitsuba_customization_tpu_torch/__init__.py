"""PyTorch + CUDA port of mitsuba_customization_tpu for NVIDIA Hopper.

A forward path tracer for measured (MERL) BRDFs: `load_dict(d, device)`
compiles a scene dict onto a device and `render(scene, spp, seed)` returns
an (H, W, 3) image. The tabulated BRDF's two hot kernels are hand-written
CUDA (csrc/), built at first use; on CPU tensors their plain PyTorch
versions run instead. This package imports neither JAX nor the JAX
package, which stays in the repository as the reference.
"""

from mitsuba_customization_tpu_torch.render.integrator import render
from mitsuba_customization_tpu_torch.render.scene import load_dict
from mitsuba_customization_tpu_torch.render.sensors import look_at

__all__ = ["load_dict", "render", "look_at"]

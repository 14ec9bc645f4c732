"""Captured frames and steps: the port's counterpart of the JAX package's
jitted entry points (render/integrator.render_jit,
parallel/mesh.render_sharded_jit, render/ad._loss_and_grad,
parallel/mesh.loss_and_grad_sharded_jit).

`jax.jit` over a frame traces it once and runs it as one program. In
PyTorch the counterpart is a CUDA graph: the frame's kernels are recorded
once and replayed with no host work per kernel. A frame is split in two:
a plan, made on the host, that resolves every host fact (sensor types,
pass layout, compaction capacities, the BVH's packed storage, a light
tracer's passes and checks) and allocates the inputs; and a body that
does device work only (the loops that run to a condition per lane are
kernels that check nothing on the host: the media's tracking, the SDF
march, the BVH walks). On the card
a Frame warms the body up once on a side stream, captures it into a
`torch.cuda.CUDAGraph`, and replays that graph at every call, the seed
written first into the frame's 0-d int64 seed buffer (the sampler reads
its seed from it, as the JAX package's jit takes `jnp.uint32(seed)` as a
traced argument). A capture that fails raises; nothing falls back to the
eager frame. On the CPU the body runs as it is, with the same plan and
seed buffer.

A step (a loss and its gradients) is a Frame with grad on: besides the
seed it holds static input buffers, one leaf (requires_grad) a parameter
and one for the target, into which each call copies the caller's values
(values passed as arguments, as `jax.jit` takes `params` and `target`).
Its warm-up runs a whole forward and backward with grad enabled (which
starts autograd's device thread and settles the checkpoint's hooks and
the allocator), and its graph holds the forward and `torch.autograd.grad`
together. A step whose loss needs an eager operation between its forward
and its backward (the halo exchange of a sharded splat) is split: the
forward and the backward are two graphs in one memory pool, the caller
runs the operation on the forward's output and hands the gradient of the
loss with respect to it to `Frame.backward`, as
`torch.cuda.make_graphed_callables` does.

A frame is kept per key: the entry point's plan (for a step, each
parameter's key, shape, type and device and the target's shape and type
too), the scene's identity, a snapshot of its host values (scene.config,
every host fact of its tables) and the address, shape, strides and type
of every tensor it holds, with the BVH's packs. A mutated config or a
replaced tensor therefore makes a new frame, and the frame it replaces
(same plan, same scene) is dropped with its graph's memory; an in-place
edit of a tensor's values is read by the next replay, as JAX's jit reads
new array values. The entry holds the scene, the plan's inputs and the
packs, so no address it recorded is freed or reused while it lives; at
most CACHE_SIZE frames and steps are kept together (least recently used
first out), each with its graph's memory pool.

The kernel wrappers count their launches when they are called: the
warm-up's launches and the capture's recorded ones count, a replay calls
no wrapper and counts nothing. A replay's launches are read from its
trace (chip_smoke.py phases 33 and 34), and put down to the spans of the
body by the frame's GraphTables (utils/log.py): at its capture each graph
keeps its node count (`nodes`) and which nodes each span of the body
recorded; its kernel nodes' names are read from the graph when first
asked for, or as the frame is dropped where a profiler has run. A frame
keeps its body's bounce counters (`counters`: lanes run, live lanes,
shadow rays a bounce), which every replay rewrites. A call's host work is in spans: frame.key (the
cache lookup), frame.inputs (the seed and the input copies), frame.capture
(a first call on the card), frame.replay (the graph, or the body on the
CPU) and frame.outputs (the copies returned); Statistics counts
frame.captures, frame.replays (on the CPU: body runs) and
frame.evictions (frames dropped by the cache or replaced).
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict

import numpy as np
import torch

from mitsuba_customization_tpu_torch.core.qmc import MASK32
from mitsuba_customization_tpu_torch.render import bvh
from mitsuba_customization_tpu_torch.utils import log

CACHE_SIZE = 4
_FRAMES: OrderedDict = OrderedDict()
# frames planned (on the card: captured) since the process started
PLANS = 0


def _leaves(obj, out, seen):
    """Append obj's host values and its tensors' (address, shape, strides,
    type, device) to out, walking containers, dataclasses and objects."""
    if torch.is_tensor(obj):
        out.append((obj.data_ptr(), tuple(obj.shape), obj.stride(), obj.dtype, obj.device))
        return
    if obj is None or isinstance(obj, (bool, int, float, str, np.generic)):
        out.append(obj)
        return
    if isinstance(obj, np.ndarray):
        out.append((obj.shape, obj.dtype.str, obj.tobytes()))
        return
    if id(obj) in seen:
        out.append(("seen", id(obj)))
        return
    seen.add(id(obj))
    out.append(type(obj).__name__)
    if isinstance(obj, dict):
        items = sorted(obj.items(), key=lambda kv: repr(kv[0]))
    elif isinstance(obj, (set, frozenset)):
        items = enumerate(sorted(obj, key=repr))
    elif isinstance(obj, (tuple, list)):
        items = enumerate(obj)
    elif dataclasses.is_dataclass(obj):
        items = ((f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj))
    elif hasattr(obj, "__dict__"):
        items = sorted(vars(obj).items())
    else:
        out.append(repr(obj))
        return
    for k, v in items:
        out.append(k)
        _leaves(v, out, seen)


def bvh_packs(scene):
    """The BVH's packed storage a frame of `scene` reads (render/bvh.packed,
    made here on the host when missing): B1's over the geometry, B2's over
    the shadow geometry. None off the BVH."""
    if scene.config.intersector != "bvh" or scene.bvh is None:
        return None
    shadow = scene.geometry if scene.shadow_geometry is None else scene.shadow_geometry
    return bvh.packed(scene.bvh, scene.geometry), bvh.packed(scene.bvh, shadow)


def scene_key(scene, packs=None):
    """The scene's part of a frame's key: its identity, host values and
    tensors, and the packs a frame of it reads."""
    out = [id(scene)]
    _leaves(scene, out, set())
    _leaves(packs, out, set())
    return tuple(out)


def input_key(tensors):
    """The part of a step's key for the tensors a call copies into its
    static inputs: each one's shape, type and device."""
    return tuple((tuple(t.shape), t.dtype, t.device) for t in tensors)


def buffers(tensors, requires_grad=False):
    """A step's static inputs: zeroed tensors of `tensors`' shapes, types
    and devices (leaves that require grad)."""
    return tuple(torch.zeros(t.shape, dtype=t.dtype, device=t.device,
                             requires_grad=requires_grad) for t in tensors)


def _clone(out):
    if isinstance(out, tuple):
        return tuple(t.detach().clone() for t in out)
    return out.detach().clone()


class Frame:
    """A planned frame or step: its body, what the body reads besides the
    scene (held), the seed buffer and the static `inputs` a call copies its
    tensors into (body(seed, *inputs) -> (out, counters)), whether it runs
    with grad enabled, and for a split step its `backward` (backward(out,
    g) -> the gradients, g the loss's gradient with respect to out). On
    the card: the captured graph (its cudaGraph_t kept) with its static
    output, the backward's graph and its static g, the capture's seconds
    and each graph's GraphTable (`tables`, the forward's first; None on
    the CPU, or where libcuda could not count the nodes). `counters`: the
    body's bounce counters (integrator.rows_body's; None for a body that
    keeps none), of the capture, which replays rewrite, or on the CPU of
    the last call."""

    def __init__(self, scene, body, keep, inputs=(), grad=False, backward=None):
        self.scene, self.body, self.keep = scene, body, keep
        self.inputs, self.grad, self.backward_body = tuple(inputs), grad, backward
        self.seed = torch.zeros((), dtype=torch.int64, device=scene.device)
        self.graph = self.out = self.capture_s = self.tables = self.counters = None
        self.bwd_graph = self.g = self.bwd_out = None

    @property
    def nodes(self):
        """The forward graph's nodes (None: nothing captured)."""
        return None if self.tables is None else self.tables[0].nodes

    def _mode(self):
        return torch.enable_grad() if self.grad else torch.no_grad()

    def _capture(self):
        dev = self.seed.device
        args = (self.seed,) + self.inputs
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        # the warm-up loads the kernels and sets their attributes, and warms
        # torch's allocator and libraries (and for a step autograd's device
        # thread and the checkpoint's hooks, by a whole backward), none of
        # which a capture may do
        with torch.cuda.stream(side), self._mode():
            out = self.body(*args)[0]
            if self.backward_body is not None:
                self.backward_body(out, torch.ones_like(out))
        del out
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with self._mode(), torch.cuda.graph(graph), log.capture() as cap:
            out, counters = self.body(*args)
        graph.instantiate()
        bwd_cap = None
        if self.backward_body is not None:
            self.g = torch.zeros_like(out)
            bwd = torch.cuda.CUDAGraph(keep_graph=True)
            with self._mode(), torch.cuda.graph(bwd, pool=graph.pool()), log.capture() as bwd_cap:
                self.bwd_out = self.backward_body(out, self.g)
            bwd.instantiate()
            self.bwd_graph = bwd
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        self.graph, self.out, self.counters = graph, out, counters
        log.Statistics.get().add("frame.captures")
        tables = [cap.table("forward", graph, counters)]
        if bwd_cap is not None:
            tables.append(bwd_cap.table("backward", bwd))
        self.tables = None if None in tables else tables

    def release(self):
        """Before the frame is dropped: where a profiler has run in this
        process (spans kept records), read its tables' kernel names from
        the graphs while they live, for a reader of the trace."""
        if log.RECORDS:
            for table in self.tables or ():
                table.resolve()

    def __call__(self, seed, *values):
        """The frame at `seed` with `values` copied into its inputs: a fresh
        tensor, or tuple of tensors (for a split step its forward's output,
        detached, whose gradient `backward` takes next)."""
        with log.span("frame.inputs"):
            self.seed.fill_(int(seed) & MASK32)
            with torch.no_grad():
                for buf, v in zip(self.inputs, values, strict=True):
                    buf.copy_(v)
        stats = log.Statistics.get()
        if self.seed.is_cuda:
            if self.graph is None:
                with log.span("frame.capture"):
                    self._capture()
            with log.span("frame.replay"):
                self.graph.replay()
            stats.add("frame.replays")
            with log.span("frame.outputs"):
                return _clone(self.out)
        with log.span("frame.replay"), self._mode():
            out, self.counters = self.body(self.seed, *self.inputs)
        stats.add("frame.replays")
        if self.backward_body is None:
            return out
        self.out = out
        return out.detach()

    def backward(self, g):
        """A split step's gradients after its forward (the last call), g the
        loss's gradient with respect to that call's output."""
        if self.bwd_graph is None:
            out, self.out = self.out, None
            with log.span("frame.replay"), self._mode():
                return self.backward_body(out, g)
        with log.span("frame.inputs"), torch.no_grad():
            self.g.copy_(g)
        with log.span("frame.replay"):
            self.bwd_graph.replay()
        with log.span("frame.outputs"):
            return _clone(self.bwd_out)


def frame(key, scene, make):
    """The frame of `key` (scene's part added here), planned with make()
    -> Frame's arguments after the scene ({"body": ..., "keep": what the
    body reads besides the scene, and for a step "inputs", "grad",
    "backward"}) on a miss."""
    global PLANS
    with log.span("frame.key"):
        packs = bvh_packs(scene)
        key = (key, scene_key(scene, packs))
        hit = _FRAMES.get(key)
        if hit is not None:
            _FRAMES.move_to_end(key)
    if hit is not None:
        return hit
    stats = log.Statistics.get()
    # the frame this one replaces (same plan, same scene, older state)
    for old in [k for k, f in _FRAMES.items() if k[0] == key[0] and f.scene is scene]:
        _FRAMES.pop(old).release()
        stats.add("frame.evictions")
    kw = make()
    kw["keep"] = (kw["keep"], packs)
    hit = Frame(scene, **kw)
    PLANS += 1
    _FRAMES[key] = hit
    while len(_FRAMES) > CACHE_SIZE:
        _FRAMES.popitem(last=False)[1].release()
        stats.add("frame.evictions")
    return hit


def latest():
    """The frame used last (None: none kept), for its capture's numbers."""
    return next(reversed(_FRAMES.values()), None)


def clear():
    """Drop every kept frame (and with them their graphs' memory)."""
    for f in _FRAMES.values():
        f.release()
    _FRAMES.clear()

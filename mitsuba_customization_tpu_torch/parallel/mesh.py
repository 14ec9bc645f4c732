"""Row-sharded rendering and the gradient all-reduce over torch.distributed.

PyTorch port of mitsuba_customization_tpu/parallel/mesh.py (the reference's
distributed layer: the Mitsuba 0.6 scheduler sends tiles to remote
workers). The frame's rows split into equal contiguous slabs, one for each
rank of a process group; every rank holds the whole scene and renders its
slab's lanes in render's own passes (render/integrator.render_rows); the
image is gathered, and a loss's gradients all-reduce over the ranks.
render_sharded_jit captures a rank's passes as a frame
(render/frame_graph.py) and keeps the collectives outside it;
loss_and_grad_sharded_jit captures a rank's slab step (its forward and
backward) and keeps the halo exchange and the all-reduce outside it.

A layout is a torch.distributed DeviceMesh that covers every rank of the
world: `make_mesh` a 1-D one, `make_mesh_2level` the ("dcn", "ici") one
(hosts outermost, the ranks of a host inside). Slabs go to the mesh's
ranks in their flattened order, hosts outermost, so neighbouring slabs sit
on one host. A process without a group (no mesh) is a world of one and
needs no collective.

The box filter averages each pixel's own lanes, so a slab depends on its
own lanes only. The other filters splat a sample into its 3x3 neighbours,
which reach HALO rows past the slab: each rank splats into its slab plus
HALO rows above and below, and sends those rows to the neighbour that owns
them (_halo_exchange; its backward sends the gradient back).

Wavefront compaction (cfg.compact) thins the live lanes of a render pass;
a rank's pass holds its slab's lanes only, so with more than one rank the
thinning picks other lanes than one process does: the frame and the
gradients are then another unbiased estimate, not render's numbers.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from mitsuba_customization_tpu_torch.render import frame_graph
from mitsuba_customization_tpu_torch.render import params as params_mod
from mitsuba_customization_tpu_torch.render.ad import captured_step, gradients, rows_loss
from mitsuba_customization_tpu_torch.render.integrator import (
    captured_rows,
    plan_rows,
    rows_body,
    rows_inputs,
)
from mitsuba_customization_tpu_torch.utils import log

AXIS = "shards"

# Halo rows exchanged between neighbouring slabs for splat filters: the
# 3x3 splat footprint (render/film.splat) reaches at most 2 rows past a
# sample's own row.
HALO = 2


def _device_type():
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(devices=None):
    """A 1-D layout over the world's ranks (init_device_mesh), in rank
    order. None without a process group (a world of one). `devices` is the
    JAX package's argument and must be None: the ranks are the world's."""
    from torch.distributed.device_mesh import init_device_mesh

    if devices is not None:
        raise ValueError("make_mesh lays out the world's ranks; pass devices=None")
    if not dist.is_initialized():
        return None
    return init_device_mesh(_device_type(), (dist.get_world_size(),), mesh_dim_names=(AXIS,))


def make_mesh_2level(devices=None, n_hosts=None):
    """The ("dcn", "ici") layout: n_hosts rows of the world's ranks
    (init_device_mesh(device_type, (n_hosts, per_host))), hosts outermost.
    n_hosts defaults to the number of hosts: the world size over
    LOCAL_WORLD_SIZE (as torch.distributed.run sets it), else 1. `devices`
    is the JAX package's argument and must be None: the ranks are the
    world's."""
    from torch.distributed.device_mesh import init_device_mesh

    if devices is not None:
        raise ValueError("make_mesh_2level lays out the world's ranks; pass devices=None")
    world = dist.get_world_size()
    n_hosts = n_hosts or world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % n_hosts != 0:
        raise ValueError(f"{world} ranks do not split over {n_hosts} hosts")
    return init_device_mesh(_device_type(), (n_hosts, world // n_hosts),
                            mesh_dim_names=("dcn", "ici"))


def _layout(mesh):
    """(the ranks in slab order, this rank's slab)."""
    if mesh is None:
        if dist.is_initialized() and dist.get_world_size() > 1:
            raise ValueError("a process group of more than one rank needs a mesh")
        return [0], 0
    ranks = mesh.mesh.flatten().tolist()
    if sorted(ranks) != list(range(dist.get_world_size())):
        raise ValueError(f"the mesh's ranks {ranks} must be the world's")
    return ranks, ranks.index(dist.get_rank())


def _check_divisible(height, n_dev, need_halo=False):
    if height % n_dev != 0:
        raise ValueError(
            f"image height {height} must divide by the mesh size {n_dev}"
        )
    if need_halo and height // n_dev < HALO:
        # the halo rows of one slab must fall within its neighbours' slabs
        raise ValueError(
            f"splat filters need >= {HALO} rows per shard; "
            f"{height} rows / {n_dev} devices leaves {height // n_dev}"
        )


def _swap(to_prev, to_next, ranks, shard):
    """Send `to_prev` to the previous slab's rank and `to_next` to the
    next's; return (what the previous sent us, what the next sent us),
    None at the ends."""
    ops, from_prev, from_next = [], None, None
    if shard > 0:
        from_prev = torch.empty_like(to_next)
        ops += [dist.P2POp(dist.isend, to_prev.contiguous(), ranks[shard - 1]),
                dist.P2POp(dist.irecv, from_prev, ranks[shard - 1])]
    if shard < len(ranks) - 1:
        from_next = torch.empty_like(to_prev)
        ops += [dist.P2POp(dist.isend, to_next.contiguous(), ranks[shard + 1]),
                dist.P2POp(dist.irecv, from_next, ranks[shard + 1])]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_prev, from_next


class _HaloExchange(torch.autograd.Function):
    """(rows + 2 HALO, W, C) slab -> its (rows, W, C) core with the
    neighbours' halo rows added: the top HALO rows belong to the previous
    slab's last rows, the bottom HALO to the next slab's first. The
    backward sends each core edge's gradient back to the halo it came
    from."""

    @staticmethod
    def forward(ctx, slab, ranks, shard):
        ctx.ranks, ctx.shard = ranks, shard
        rows = slab.shape[0] - 2 * HALO
        core = slab[HALO:HALO + rows].clone()
        from_prev, from_next = _swap(slab[:HALO], slab[HALO + rows:], ranks, shard)
        if from_prev is not None:
            core[:HALO] += from_prev
        if from_next is not None:
            core[rows - HALO:] += from_next
        return core

    @staticmethod
    def backward(ctx, g):
        g_top, g_bot = _swap(g[:HALO], g[g.shape[0] - HALO:], ctx.ranks, ctx.shard)
        zeros = g.new_zeros((HALO,) + g.shape[1:])
        return torch.cat([zeros if g_top is None else g_top, g,
                          zeros if g_bot is None else g_bot]), None, None


def _halo_exchange(slab, ranks, shard):
    """Sum halo rows into the owning slabs' cores (differentiable)."""
    return _HaloExchange.apply(slab, ranks, shard)


def _slab_plan(scene, spp, ranks, shard):
    """The RowsPlan of this rank's rows (H / n of them, with HALO rows each
    side for a splat filter) under the scene's integrator."""
    cfg = scene.config
    _check_divisible(cfg.height, len(ranks), need_halo=cfg.rfilter != "box")
    rows = cfg.height // len(ranks)
    return plan_rows(scene, spp, None, None, shard * rows, rows, HALO)


def _joined(out):
    """A splat's (img, wsum) slab as one (rows + 2 HALO, W, C + 1) tensor."""
    return torch.cat([out[0], out[1][..., None]], -1)


def _develop_joined(cfg, both, ranks, shard):
    """A joined splat slab -> its (H / n, W, C) rows: the halo rows
    exchanged with the neighbours and divided by the weights; times the
    sensor's scale."""
    both = _halo_exchange(both, ranks, shard)
    out = both[..., :-1] / torch.clamp(both[..., -1], min=1e-12)[..., None]
    return out * cfg.sensor_scale if cfg.sensor_scale != 1.0 else out


def _develop_slab(cfg, out, ranks, shard):
    """A slab's render_rows out -> its (H / n, W, C) rows: a splat's halo
    rows exchanged with the neighbours and divided by the weights; times
    the sensor's scale."""
    if cfg.rfilter != "box":
        return _develop_joined(cfg, _joined(out), ranks, shard)
    return out * cfg.sensor_scale if cfg.sensor_scale != 1.0 else out


def _slab(scene, spp, seed, ranks, shard, ad_mode):
    """This rank's rows of the frame, (H / n, W, C), in render's passes
    (render/integrator.render_rows: a world of one renders render's very
    lanes): box-averaged, or splatted with the halo rows and exchanged."""
    plan = _slab_plan(scene, spp, ranks, shard)
    out, _ = rows_body(scene, plan, rows_inputs(scene, plan), seed, ad_mode)
    return _develop_slab(scene.config, out, ranks, shard)


def render_slab(scene, mesh=None, spp=None, seed=0):
    """This rank's slab of the frame: (rows [row0, row0 + H / n), W, C)
    and row0, with n the mesh's size. Without compaction the rows equal
    those of render/integrator.render's frame (the box filter bit for bit).
    Under a compaction schedule (cfg.compact) a rank thins its own slab's
    live lanes, so more than one rank gives another unbiased estimate than
    render's (a world of one renders render's very lanes)."""
    ranks, shard = _layout(mesh)
    spp = spp or scene.config.spp
    slab = _slab(scene, spp, seed, ranks, shard, False)
    return slab, shard * slab.shape[0]


def _gather(slab, mesh):
    """Every rank's slab, in slab order: the whole (H, W, C) image."""
    if not dist.is_initialized():
        return slab
    ranks, _ = _layout(mesh)
    parts = [torch.empty_like(slab) for _ in ranks]
    dist.all_gather(parts, slab.contiguous())
    return torch.cat([parts[r] for r in ranks])


def render_sharded(scene, mesh=None, spp=None, seed=0):
    """Render with the image rows sharded over the mesh (1-D or ("dcn",
    "ici")): each rank renders its slab, and the slabs are gathered, so
    every rank returns the whole (H, W, C) image.

    The JAX package's docstring says the same, but its function returns a
    row-sharded array (ROADMAP's reference faults)."""
    slab, _ = render_slab(scene, mesh, spp, seed)
    return _gather(slab, mesh)


def render_sharded_jit(scene, mesh=None, spp=None, seed=0):
    """render_sharded with each rank's slab passes a captured frame
    (render/frame_graph.py), the JAX package's render_sharded_jit (its
    arguments, in its order). The rank's render_rows passes are captured
    on the card and replayed (run as they are on the CPU); the halo
    exchange of a splat filter and the gathering all_gather stay outside,
    as eager collectives. The image is render_sharded's bit for bit (a
    splat's atomic adds on the card aside). Host spans as render_jit's."""
    with log.span("frame.call"):
        ranks, shard = _layout(mesh)
        cfg = scene.config
        with log.span("frame.plan"):
            plan = _slab_plan(scene, int(spp or cfg.spp), ranks, shard)
        out = captured_rows(scene, plan, seed, False)
        return _gather(_develop_slab(cfg, out, ranks, shard), mesh)


def loss_and_grad_sharded(scene, params, target, mesh=None, spp=None, seed=0):
    """Distributed MSE loss against `target` (the whole (H, W, C) image on
    every rank) and its gradients with respect to `params` ({key: tensor},
    keys of params.traverse), any filter.

    Each rank renders its slab in ad_mode (path replay) and differentiates
    its share of the loss, sum((slab - target rows)^2) / (H W C); the
    losses and every gradient then all-reduce (sum) over the ranks, so each
    rank holds render/ad.grad_render's (loss, {key: gradient}). A MERL
    table's gradient accumulates in the one GradSink buffer of its rank's
    step (ops/merl_sorted), which the all-reduce sums in place."""
    ranks, shard = _layout(mesh)
    cfg = scene.config
    spp = spp or cfg.spp
    leaves = {k: v if v.requires_grad else v.detach().requires_grad_(True)
              for k, v in params.items()}
    with log.span("update"):
        scene_p = params_mod.update(scene, leaves)
    with log.span("forward"):
        slab = _slab(scene_p, spp, seed, ranks, shard, True)
        rows = slab.shape[0]
        ref = target[shard * rows:(shard + 1) * rows]
        loss = torch.sum((slab - ref) ** 2) / target.numel()
    grads = dict(zip(leaves, gradients(loss, list(leaves.values()))))
    return _all_reduce(loss.detach(), grads)


def _all_reduce(loss, grads):
    """Sum the loss and every gradient over the ranks, in place (the span
    allreduce: the collectives' enqueue)."""
    with log.span("allreduce"):
        if dist.is_initialized():
            for t in (loss, *grads.values()):
                dist.all_reduce(t)
        return loss, grads


def _split_slab_step(scene, plan, params, seed, ref, n, ranks, shard):
    """A splat slab's step with the halo exchange between its two graphs:
    the forward (update, the slab's passes in ad_mode, joined) and the
    backward of a split captured step (render/frame_graph.py), the
    exchange, the division and the slab loss eager between them, with the
    loss's gradient with respect to the joined slab handed back."""
    keys = tuple(params)

    def make():
        inputs = rows_inputs(scene, plan)
        leaves = frame_graph.buffers(params.values(), requires_grad=True)

        def body(seed_t, *leaves):
            with log.span("update"):
                scene_p = params_mod.update(scene, dict(zip(keys, leaves)))
            with log.span("forward"):
                out, counters = rows_body(scene_p, plan, inputs, seed_t, True)
                return _joined(out), counters

        return {"body": body, "keep": inputs, "inputs": leaves, "grad": True,
                "backward": lambda both, g: gradients(both, leaves, g)}

    step = frame_graph.frame(("split_slab_step", plan, tuple(ranks), keys,
                              frame_graph.input_key(params.values())), scene, make)
    both = step(seed, *params.values()).requires_grad_(True)
    slab = _develop_joined(scene.config, both, ranks, shard)
    loss = torch.sum((slab - ref) ** 2) / n
    (g,) = torch.autograd.grad(loss, both)
    return loss.detach(), dict(zip(keys, step.backward(g)))


def loss_and_grad_sharded_jit(scene, params, target, mesh, spp, seed):
    """loss_and_grad_sharded with each rank's slab step captured
    (render/frame_graph.py), the JAX package's loss_and_grad_sharded_jit
    (its arguments, in its order; `mesh` and `spp` positional, as its jit
    takes them static). Under the box filter the rank's update, slab
    passes in ad_mode, slab loss and backward are one captured step
    (render/ad.captured_step); under a splat filter the halo exchange,
    point to point in the forward and the backward, sits between the
    step's forward and backward graphs (two graphs in one pool, the
    exchange, the division and the slab loss eager between them). The loss
    and gradient all-reduce run eager after the replay. Equal to
    loss_and_grad_sharded on the CPU (up to K1-bwd's and a splat's atomic
    adds on the card); on the CPU the bodies run as they are. Host spans
    as grad_render's, and allreduce."""
    with log.span("frame.call"):
        ranks, shard = _layout(mesh)
        cfg = scene.config
        with log.span("frame.plan"):
            plan = _slab_plan(scene, int(spp or cfg.spp), ranks, shard)
        ref = target[shard * plan.n_rows:(shard + 1) * plan.n_rows]
        n = target.numel()
        if plan.box:
            loss, grads = captured_step(
                ("slab_step", plan, tuple(ranks)), scene, params, seed, ref,
                rows_loss(scene, plan, lambda out, r: torch.sum(
                    (_develop_slab(scene.config, out, ranks, shard) - r) ** 2) / n))
        else:
            loss, grads = _split_slab_step(scene, plan, params, seed, ref, n, ranks, shard)
        return _all_reduce(loss, grads)


def initialize_distributed(coordinator=None, num_processes=None, process_id=None, *,
                           device="cuda", timeout=None):
    """Join this process to a process group: NCCL when `device` is CUDA
    (the rank's card is set first: LOCAL_RANK, else process_id modulo the
    cards), gloo on the CPU. `coordinator` is the group's address
    ("tcp://host:port", "host:port" or "file://path"); without one the
    environment torch.distributed.run sets (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK) is read. A no-op for a single process with no
    coordinator, or when a group already exists. timeout: seconds a
    collective may wait (torch's default when None)."""
    if dist.is_initialized():
        return
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    num_processes, process_id = num_processes or 1, process_id or 0
    if coordinator is None and num_processes <= 1:
        return
    if coordinator is None:
        coordinator = "env://"
    elif "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK",
                                                 process_id % torch.cuda.device_count())))
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group("nccl" if on_card else "gloo", init_method=coordinator,
                            world_size=num_processes, rank=process_id, **kw)

"""Row-sharded rendering over torch.distributed (parallel/mesh.py) on CPU
processes.

Each case starts 2 or 4 gloo ranks, each a subprocess running this file
(`if __name__ == "__main__"`, no JAX imported), which meet through a
file:// store under tmp_path; every process group has a 60 s timeout and
every process a 120 s wait, so a hung collective fails its test. Each rank
writes its slab (render_slab), the gathered image (render_sharded) and,
for the gradient cases, loss_and_grad_sharded's loss, table gradient and
table-gradient buffer count; the test holds them to the single-process
port on the same scene (tests/test_parallel.py's MERL sphere under a sky,
which the reference renders): each slab equals the matching rows of
`render` (bit for bit under the box filter, within 1e-6 under the gaussian
filter's halo exchange) and so does the gathered image on every rank; the
sharded loss and table gradient match render/ad.grad_render's. Layouts: the
1-D mesh over 2 and 4 ranks and the 2x2 ("dcn", "ici") one; _check_divisible
refuses heights that do not split; the production scene
(scenes.production_dict: volpath, a MERL mesh on clusters, a medium, the
gaussian filter) on 2 ranks; under a compaction schedule, where each rank
thins its own lanes, 2 and 4 ranks against one process by means and
Z-test. One small box frame agrees with the JAX
package's render_sharded on conftest.py's 8 virtual devices by mean and
Z-test. The JAX counterparts of the 1-D gaussian render and of the
gradient cases are `slow` (tests/test_parallel.py); these are cheap here
and stay in the default run.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
RES, SPP, SEED, GRAD_SEED = 16, 4, 0, 3
TABLE_KEY = "bsdf.tabulated.table"
COMPACT = (1.0, 0.25)


def scene_dict(res=RES, spp=SPP, rfilter="box", compact=None):
    """tests/test_parallel.py's scene: a MERL sphere under a constant sky
    (the table: scenes.synthetic_merl_table, numpy only); `compact`: the
    integrator's compaction schedule."""
    from mitsuba_customization_tpu_torch.scenes import synthetic_merl_table
    from mitsuba_customization_tpu_torch.render.sensors import look_at

    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 3, "compact": compact},
        "sensor": {"type": "perspective", "fov": 40,
                   "to_world": look_at([0, 0, -4], [0, 0, 0], [0, 1, 0]),
                   "film": {"width": res, "height": res, "rfilter": rfilter},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "sphere": {"type": "sphere",
                   "bsdf": {"type": "merl", "table": synthetic_merl_table(0.15, [1, 0.7, 0.4])}},
        "light": {"type": "constant", "radiance": [1.0, 1.0, 1.0]},
    }


def case_scene(case, spp=SPP):
    """(scene dict, spp) of a case: "box", "gaussian", "production" or
    "compact" (the box scene at 32x32, 16 spp under the compaction
    schedule COMPACT: 16,384 lanes, of which the second bounce thins the
    live ones on one process, on both of 2 ranks and on the middle two of
    4, whose slabs hold most of the sphere)."""
    if case == "production":
        from mitsuba_customization_tpu_torch.scenes import production_dict

        return production_dict(32, 2, 3), 2
    if case == "compact":
        return scene_dict(res=32, spp=16, compact=COMPACT), 16
    return scene_dict(spp=spp, rfilter=case), spp


def _worker(case, layout, rank, world, store, out, spp):
    """One rank: render (and differentiate) the case's scene sharded, save
    what the test checks to out/rank<r>.npz."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.ops import merl_sorted
    from mitsuba_customization_tpu_torch.parallel import mesh as pm

    torch.set_num_threads(1)
    pm.initialize_distributed(f"file://{store}", world, rank, device="cpu", timeout=60)
    d, spp = case_scene(case, spp)
    scene = mt.load_dict(d, "cpu")
    mesh = pm.make_mesh_2level(n_hosts=2) if layout == "2level" else pm.make_mesh()
    res = {"dims": np.array(mesh.mesh_dim_names), "ranks": mesh.mesh.flatten().numpy()}
    res["slab"], res["row0"] = (x.numpy() if torch.is_tensor(x) else x
                                for x in pm.render_slab(scene, mesh, spp, SEED))
    res["image"] = pm.render_sharded(scene, mesh, spp, SEED).numpy()
    if case != "production":
        params = {TABLE_KEY: mt.traverse(scene)[TABLE_KEY]}
        merl_sorted.GRAD_BUFFERS = 0
        loss, grads = pm.loss_and_grad_sharded(scene, params, torch.zeros(res["image"].shape),
                                               mesh, spp, GRAD_SEED)
        res.update(loss=loss.numpy(), grad=grads[TABLE_KEY].numpy(),
                   buffers=merl_sorted.GRAD_BUFFERS)
    if case in ("box", "gaussian"):
        try:  # a height that does not split over the ranks
            pm.render_sharded(mt.load_dict(scene_dict(res=RES - 1), "cpu"), mesh, 1, 0)
        except ValueError as e:
            res["refused"] = str(e)
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    torch.distributed.destroy_process_group()


def _spawn(tmp_path, case, layout, world, spp=SPP):
    """Run `world` ranks of _worker; return their outputs by rank."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, HERE, os.environ.get("PYTHONPATH", "")]))
    store = tmp_path / "store"
    procs = [subprocess.Popen(
        [sys.executable, __file__, case, layout, str(r), str(world), str(store), str(tmp_path),
         str(spp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def single():
    """The single-process port: frames of each case and the box and
    gaussian scenes' grad_render."""
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu_torch.render.ad import grad_render

    torch.set_num_threads(1)
    out = {}
    for case in ("box", "gaussian", "production", "compact"):
        d, spp = case_scene(case)
        scene = mt.load_dict(d, "cpu")
        img = mt.render(scene, spp, SEED)
        out[case] = {"image": img.numpy()}
        if case != "production":
            params = {TABLE_KEY: mt.traverse(scene)[TABLE_KEY]}
            loss, grads = grad_render(scene, params, torch.zeros_like(img), spp, GRAD_SEED)
            out[case].update(loss=float(loss), grad=grads[TABLE_KEY].numpy())
        if case == "compact":  # per-pixel variances (moment: no compaction)
            mom = mt.render(scene, spp, SEED + 1, "moment").numpy()
            out[case]["var"] = np.maximum(mom[..., 3:] - mom[..., :3] ** 2, 0.0) + 1e-4
    return out


CASES = [("box", "1d", 2), ("box", "1d", 4), ("box", "2level", 4), ("gaussian", "1d", 2),
         ("gaussian", "2level", 4), ("production", "1d", 2)]


@pytest.mark.parametrize("case, layout, world", CASES,
                         ids=[f"{c}-{lay}-{w}" for c, lay, w in CASES])
def test_slabs_and_gradients_match_single_process(tmp_path, single, case, layout, world):
    outs = _spawn(tmp_path, case, layout, world)
    want = single[case]["image"]
    exact = case == "box"
    rows = want.shape[0] // world
    for r, o in enumerate(outs):
        ranks = list(o["ranks"])
        assert sorted(ranks) == list(range(world))
        assert tuple(o["dims"]) == (("dcn", "ici") if layout == "2level" else ("shards",))
        shard = ranks.index(r)
        assert int(o["row0"]) == shard * rows and o["slab"].shape == (rows,) + want.shape[1:]
        for got, ref in ((o["slab"], want[shard * rows:(shard + 1) * rows]), (o["image"], want)):
            if exact:
                np.testing.assert_array_equal(got, ref)
            else:
                np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
        if case == "production":
            continue
        # the loss and the table gradient, summed over the ranks
        assert abs(float(o["loss"]) - single[case]["loss"]) <= 1e-6 * single[case]["loss"]
        g, g1 = o["grad"], single[case]["grad"]
        assert np.linalg.norm(g - g1) <= 1e-5 * np.linalg.norm(g1)
        assert int(o["buffers"]) == 1  # one GradSink buffer on each rank
        assert "must divide" in str(o["refused"])


@pytest.mark.parametrize("world", [2, 4])
def test_compacted_frames_agree_with_single_process(tmp_path, single, world):
    """Under a compaction schedule each rank thins its own slab's live
    lanes, so the sharded frame and AD step are another unbiased estimate
    than one process's, not the same numbers: held by means (2 %), the
    per-pixel Z-test and the loss (4 %: the loss is quadratic in the image).
    Each rank's slab still equals its rows of the gathered image, which is
    the same on every rank."""
    from reference_renderer import ztest_images

    outs = _spawn(tmp_path, "compact", "1d", world)
    ref = single["compact"]
    want, var = ref["image"], ref["var"]
    rows = want.shape[0] // world
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["image"], outs[0]["image"])
        np.testing.assert_array_equal(o["slab"], o["image"][r * rows:(r + 1) * rows])
        assert abs(float(o["loss"]) - ref["loss"]) <= 0.04 * ref["loss"]
        assert int(o["buffers"]) == 1
    got = outs[0]["image"]
    assert not np.array_equal(got, want)  # the ranks thinned other lanes
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)), rtol=0.02)
    ok, z = ztest_images(got, var, want, var, 16, 16)
    assert ok, z


def test_mesh_takes_the_worlds_ranks():
    """make_mesh / make_mesh_2level lay out the world's ranks: the JAX
    package's `devices` argument is refused."""
    from mitsuba_customization_tpu_torch.parallel import mesh as pm

    for make in (pm.make_mesh, pm.make_mesh_2level):
        with pytest.raises(ValueError, match="devices=None"):
            make([0, 1])


def test_check_divisible():
    from mitsuba_customization_tpu_torch.parallel import mesh as pm

    pm._check_divisible(16, 4, need_halo=True)
    with pytest.raises(ValueError, match="must divide"):
        pm._check_divisible(16, 3)
    with pytest.raises(ValueError, match="rows per shard"):
        pm._check_divisible(8, 8, need_halo=True)
    pm._check_divisible(8, 8)  # the box filter needs no halo


def test_box_frame_matches_jax_render_sharded(tmp_path):
    """The port's 2-rank sharded box frame against the JAX package's
    render_sharded on conftest.py's 8 virtual CPU devices: image means
    within 2 % and the per-pixel Z-test (variances from the port's moment
    integrator)."""
    import jax

    import mitsuba_customization_tpu as mct
    import mitsuba_customization_tpu_torch as mt
    from mitsuba_customization_tpu.parallel import mesh as jmesh
    from reference_renderer import ztest_images

    if len(jax.devices()) < 8:
        pytest.skip("needs conftest.py's 8 virtual devices")
    spp = 16
    d = scene_dict(res=16, spp=spp)
    want = np.asarray(jmesh.render_sharded_jit(mct.load_dict(d), jmesh.make_mesh(
        jax.devices()[:8]), spp=spp, seed=0))
    got = _spawn(tmp_path, "box", "1d", 2, spp)[0]["image"]
    mom = mt.render(mt.load_dict(d, "cpu"), spp, 1, "moment").numpy()
    var = np.maximum(mom[..., 3:] - mom[..., :3] ** 2, 0.0) + 1e-4
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)), rtol=0.02)
    ok, z = ztest_images(got, var, want, var, spp, spp)
    assert ok, z


if __name__ == "__main__":
    _worker(*sys.argv[1:3], *map(int, sys.argv[3:5]), *sys.argv[5:7], int(sys.argv[7]))

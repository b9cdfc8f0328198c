"""Rank worker of the port's multi-rank tests (``test_torch_parallel.py``,
``test_torch_parallel_engine.py``, ``test_torch_parallel_particles.py``,
``test_torch_spatial.py``); it defines no tests.

Run as a script, one process per rank of a gloo world on the CPU:

    python tests/test_torch_parallel_ranks.py SCENARIO WORLD RANK DIR

It reads ``DIR/SCENARIO_job.pkl`` (written by the test), joins the
process group through the file store ``DIR/SCENARIO_store``, runs the
scenario (``halo``, ``step``, ``engine``, ``keyframes`` or ``spatial``)
and writes what this rank computed to ``DIR/SCENARIO_RANK.pkl``. It
imports the port and never JAX, so the ranks start quickly and need no
accelerator.
"""

import datetime
import os
import pickle
import sys

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.abspath(__file__)


def toy_loss_frames(n_views: int, target: torch.Tensor):
    """The JAX parallel tests' toy loss over a batch of local frames:
    per frame, the squared error of d + param (and of its advection
    through the window's centre velocity) to a target, scaled per view by
    1 + 0.1 * theta, divided by n_views so that the view shards' partial
    losses sum to the frame's loss."""
    from nfs_tpu_torch.ops.advect import advect

    def loss_frames(params, d, vels_pad, views, aux):
        L = d.shape[0]
        W = 0 if vels_pad is None else (vels_pad.shape[0] - L) // 2
        total = torch.zeros(())
        for i in range(L):
            d_star = d[i] + params[i]
            base = torch.mean((d_star - target) ** 2)
            if vels_pad is not None:
                d_f = advect(d_star, vels_pad[i + W])
                base = base + torch.mean((d_f - target) ** 2)
            per_view = base * (1.0 + 0.1 * views[i, :, 0])
            total = total + torch.sum(per_view) / n_views
        return total

    return loss_frames


def _halo(job):
    from nfs_tpu_torch.parallel import halo_exchange, make_mesh

    mesh = make_mesh(4, 1)
    out = {}
    for T, halo, clamp in job["cases"]:
        x = torch.arange(2 * T, dtype=torch.float32).reshape(T, 2)
        L = T // 4
        local = x[mesh.frame_idx * L:(mesh.frame_idx + 1) * L]
        counts = {"send": 0, "recv": 0, "all_gather": 0}
        left, right = halo_exchange(local, halo, mesh, clamp_edges=clamp,
                                    counts=counts)
        out[(T, halo, clamp)] = (torch.cat([left, local, right]).numpy(),
                                 counts)
    return out


def _step(job):
    from nfs_tpu_torch.parallel import make_mesh, make_sharded_window_step
    from nfs_tpu_torch.styler.octave import Adam

    inp = {k: torch.from_numpy(v) for k, v in job["inputs"].items()}
    T = inp["d"].shape[0]
    out = {}
    for frames, views, window, n_iters in job["cases"]:
        mesh = make_mesh(frames, views)
        if not mesh.has_shard:
            continue
        L = T // frames
        sl = slice(mesh.frame_idx * L, (mesh.frame_idx + 1) * L)
        opt = Adam(0.05)
        step = make_sharded_window_step(
            mesh, toy_loss_frames(job["n_views"], inp["target"]), opt,
            window=window, n_views=job["n_views"], n_iters=n_iters)
        params = inp["params"][sl]
        p, _, losses = step(params, opt.init(params), inp["d"][sl],
                            inp["vels"][sl], inp["pool"],
                            inp["view_idx"][sl], None, 0)
        out[(frames, views, window, n_iters)] = {
            "frame_idx": mesh.frame_idx, "view_idx": mesh.view_idx,
            "params": p.numpy(), "losses": losses.numpy(),
            "collectives": dict(step.collectives)}
    return out


def _engine(job):
    from nfs_tpu_torch.core.config import StyleConfig, replace
    from nfs_tpu_torch.parallel import ParallelSequenceStyler, make_mesh
    from nfs_tpu_torch.styler.grid import GridStyler

    out = []
    for run in job["runs"]:
        styler = GridStyler(replace(StyleConfig(), **run["over"]),
                            style_image=run["style"], device="cpu")
        engine = ParallelSequenceStyler(styler, make_mesh(*run["mesh"]))
        d, p, info = engine.stylize(run["d"], run.get("v"),
                                    view_schedule=run.get("schedule"))
        out.append({"d": d.numpy(), "params": p.numpy(),
                    "losses": [l.numpy() for l in info["octave_losses"]],
                    "collectives": dict(engine.last_collectives)})
    return out


def _keyframes(job):
    from nfs_tpu_torch.core.config import StyleConfig, replace
    from nfs_tpu_torch.core.pytrees import ParticleSet
    from nfs_tpu_torch.parallel import ParallelKeyframeStyler, make_mesh
    from nfs_tpu_torch.styler.particle import ParticleStyler

    out = []
    for run in job["runs"]:
        styler = ParticleStyler(replace(StyleConfig(), **run["over"]),
                                grid_shape=run["shape"],
                                style_image=run["style"], device="cpu")
        engine = ParallelKeyframeStyler(styler, make_mesh(*run["mesh"]))
        psets = [ParticleSet(x=x, dens=d, color=c)
                 for x, d, c in run["frames"]]
        outs = [(t, p.x.numpy(), p.dens.numpy(), None)
                for t, p in engine.stylize_keyframes(psets)]
        out.append({"outs": outs,
                    "collectives": dict(engine.last_collectives)})
    return out


def _spatial(job):
    """Spatial sharding: each case of ``job['cases']`` is a dict with a
    'kind': 'mesh' (``make_mesh(*mesh)``'s place of this rank),
    'roundtrip' (``shard_volume`` then ``gather_volume`` over a (1, 4)
    mesh's views), 'advect' (one slab ``advect`` on ``spatial_mesh(n)``
    with the gradients of a cotangent, each gathered whole), 'gather'
    (the gradient of ``(w * SpaceSlabs.gather(x)).sum()``, replicated and
    summed), 'frame' (``stylize_frame_spatial`` on ``spatial_mesh(n)``)
    'ckpt' (``stylize_frame_spatial`` with an in-frame checkpoint:
    uninterrupted, stopped and resumed, resumed from an unsharded run's
    file; ``_spatial_frame_ckpt``) or 'engine' (the composed engine on
    ``make_mesh(*mesh)``). Each
    result lists the warnings the case raised; 'owns' says of the slabs a
    case holds whether each has storage of its own (``_owns``)."""
    import warnings

    out = []
    for case in job["cases"]:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = _SPATIAL_KINDS[case["kind"]](case)
        res["warnings"] = [str(w.message) for w in caught]
        out.append(res)
    return out


def _owns(*xs):
    """Whether every tensor has storage of its own: a slab that is a
    view of the whole volume keeps all of it allocated."""
    return all(x.untyped_storage().nbytes() == x.numel() * x.element_size()
               for x in xs if x is not None)


def _spatial_mesh_case(case):
    from nfs_tpu_torch.parallel import make_mesh

    mesh = make_mesh(*case["mesh"])
    return {"place": (mesh.frame_idx, mesh.view_idx, mesh.space_idx),
            "shape": dict(mesh.shape),
            "ranks": {a: mesh.axis_ranks(a) if mesh.has_shard else None
                      for a in ("frames", "views", "space")}}


def _spatial_roundtrip(case):
    from nfs_tpu_torch.parallel import make_mesh, shard_volume
    from nfs_tpu_torch.parallel.sharding import gather_volume

    mesh = make_mesh(1, 4)
    d = torch.from_numpy(case["d"])
    part = shard_volume(d, mesh, axis=-1, mesh_axis="views")
    whole = gather_volume(part * 2 + 1, mesh, axis=-1, mesh_axis="views")
    return {"part": part.numpy(), "whole": whole.numpy(),
            "owns": _owns(part)}


def _spatial_advect(case):
    from nfs_tpu_torch.ops.advect import advect
    from nfs_tpu_torch.parallel import spatial_mesh
    from nfs_tpu_torch.parallel.spatial import SpaceSlabs, gather_spatial

    axis = case["axis"]
    mesh = spatial_mesh(case["n"])
    f, v, g = (torch.from_numpy(case[k]) for k in ("f", "v", "g"))
    space = SpaceSlabs(mesh, f.shape, axis=axis)
    fs = space.slab(f).requires_grad_()
    vs = space.slab(v).requires_grad_()
    y = space.advect(fs, vs, max_disp=case["max_disp"])
    gf, gv = torch.autograd.grad((y * space.slab(g)).sum(), (fs, vs))
    return {"y": gather_spatial(y.detach(), mesh, axis).numpy(),
            "gf": gather_spatial(gf, mesh, axis).numpy(),
            "gv": gather_spatial(gv, mesh, axis).numpy(),
            "owns": _owns(fs, vs, y, gf, gv),
            "collectives": dict(space.counts)}


def _spatial_gather(case):
    from nfs_tpu_torch.parallel import spatial_mesh
    from nfs_tpu_torch.parallel.spatial import SpaceSlabs

    x, w = (torch.from_numpy(case[k]) for k in ("x", "w"))
    space = SpaceSlabs(spatial_mesh(case["n"]), x.shape)
    xs = space.slab(x).requires_grad_()
    out = {}
    for name, replicated in (("replicated", True), ("summed", False)):
        (out[name],) = torch.autograd.grad(
            (w * space.gather(xs, replicated=replicated)).sum(), xs)
    return {"grads": {k: g.numpy() for k, g in out.items()},
            "owns": _owns(xs, *out.values()),
            "collectives": dict(space.counts)}


def _spatial_styler(case):
    from nfs_tpu_torch.core.config import StyleConfig, replace
    from nfs_tpu_torch.styler.grid import GridStyler

    return GridStyler(replace(StyleConfig(), **case["over"]),
                      style_image=case["style"], device="cpu")


def _spatial_frame(case):
    from nfs_tpu_torch.parallel import spatial_mesh, stylize_frame_spatial
    from nfs_tpu_torch.parallel.spatial import gather_spatial

    mesh = spatial_mesh(case["n"])
    styler = _spatial_styler(case)
    inner, held = styler.stylize_frame, []

    def spy(d, vels=None, init_param=None, **kw):
        # the slabs the octave loop holds through the frame
        held.append(_owns(d, vels, init_param))
        return inner(d, vels=vels, init_param=init_param, **kw)

    styler.stylize_frame = spy
    d, p, info = stylize_frame_spatial(styler, case["d"], mesh,
                                       vels=case.get("v"))
    return {"slab_shape": tuple(p.shape),
            "owns": held == [True] and _owns(d, p),
            "d": gather_spatial(d, mesh).numpy(),
            "params": gather_spatial(p, mesh).numpy(),
            "losses": [l.numpy() for l in info["octave_losses"]],
            "collectives": info["collectives"]}


class _Interrupt(Exception):
    pass


def _spatial_frame_ckpt(case):
    """``stylize_frame_spatial`` with ``checkpoint_path`` on
    ``spatial_mesh(n)``, every run's d* and param gathered whole with its
    losses and whether it left its file: 'full', uninterrupted; for each
    (octave, done) of ``case['stops']``, the frame stopped by a callback
    raising after that chunk, then resumed (rank 0 first copies the file
    of the stop ``case['keep']`` to ``case['slab_file']``, which the test
    resumes unsharded); 'from_unsharded', a frame resumed from
    ``case['unsharded_file']``, which an unsharded run wrote. 'exists'
    says, after each chunk of every run, whether the file was there."""
    import shutil

    from nfs_tpu_torch.parallel import spatial_mesh, stylize_frame_spatial
    from nfs_tpu_torch.parallel.spatial import gather_spatial

    mesh = spatial_mesh(case["n"])
    styler = _spatial_styler(case)
    own_file = os.path.join(case["dir"], "inframe_ckpt.npz")
    seen = []

    def run(stop=None, path=own_file):
        def cb(done, loss, octave):
            seen.append(os.path.exists(path))
            if (octave, done) == stop:
                raise _Interrupt
        try:
            d, p, info = stylize_frame_spatial(
                styler, case["d"], mesh, vels=case.get("v"),
                checkpoint_path=path, callback=cb)
        except _Interrupt:
            return None
        return {"d": gather_spatial(d, mesh).numpy(),
                "params": gather_spatial(p, mesh).numpy(),
                "losses": [l.numpy() for l in info["octave_losses"]],
                "left": os.path.exists(path)}

    out = {"full": run()}
    for stop in case["stops"]:
        assert run(stop) is None
        if stop == case["keep"]:
            if mesh.space_idx == 0:
                shutil.copy(own_file, case["slab_file"])
            dist.barrier()
        out[stop] = run()
    out["from_unsharded"] = run(path=case["unsharded_file"])
    out["exists"] = seen
    return out


def _spatial_engine(case):
    from nfs_tpu_torch.parallel import ParallelSequenceStyler, make_mesh

    engine = ParallelSequenceStyler(_spatial_styler(case),
                                    make_mesh(*case["mesh"]))
    make_loss, held = engine._loss_frames, []

    def spy(*args):
        loss = make_loss(*args)

        def loss_frames(params, d, vels_pad, views, aux):
            # the slabs (or replicated volumes) each octave's step holds
            held.append(_owns(params, d, vels_pad))
            return loss(params, d, vels_pad, views, aux)

        return loss_frames

    engine._loss_frames = spy
    d, p, info = engine.stylize(case["d"], case.get("v"),
                                view_schedule=case.get("schedule"))
    return {"d": d.numpy(), "params": p.numpy(),
            "owns": bool(held) and all(held),
            "losses": [l.numpy() for l in info["octave_losses"]],
            "collectives": dict(engine.last_collectives)}


_SPATIAL_KINDS = {"mesh": _spatial_mesh_case,
                  "roundtrip": _spatial_roundtrip,
                  "advect": _spatial_advect, "gather": _spatial_gather,
                  "frame": _spatial_frame, "ckpt": _spatial_frame_ckpt,
                  "engine": _spatial_engine}


SCENARIOS = {"halo": _halo, "step": _step, "engine": _engine,
             "keyframes": _keyframes, "spatial": _spatial}


def run_ranks(scenario: str, job, world: int, tmp_dir, timeout=240):
    """Run ``scenario`` on ``world`` gloo ranks in fresh processes and
    return each rank's result, in rank order."""
    import subprocess

    tmp_dir = str(tmp_dir)
    with open(os.path.join(tmp_dir, f"{scenario}_job.pkl"), "wb") as f:
        pickle.dump(job, f)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, WORKER, scenario, str(world), str(r), tmp_dir],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, process_group=0) for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:     # a rank stuck in a collective of a failed one
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    out = []
    for r in range(world):
        with open(os.path.join(tmp_dir, f"{scenario}_{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def main(argv):
    scenario, world, rank, tmp_dir = argv[0], int(argv[1]), int(argv[2]), \
        argv[3]
    torch.set_num_threads(1)
    with open(os.path.join(tmp_dir, f"{scenario}_job.pkl"), "rb") as f:
        job = pickle.load(f)
    dist.init_process_group(
        "gloo",
        init_method=f"file://{os.path.join(tmp_dir, scenario + '_store')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=120))
    try:
        result = SCENARIOS[scenario](job)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp_dir, f"{scenario}_{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    assert "jax" not in sys.modules


if __name__ == "__main__":
    main(sys.argv[1:])

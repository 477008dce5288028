"""Spawned gloo ranks on the CPU for the port's sharded tests.

``spawn(fn, world, *args)`` starts ``world`` processes, each of which
starts its rank (``repro_torch.launch.mesh.start`` on the CPU, gloo, a
``file://`` rendezvous in a fresh temporary directory, so parallel test
workers never share a port) on one torch thread, calls ``fn(rank, world,
*args)`` and hands its return value back (pickled). Any rank that raises
fails the call with that rank's traceback. ``fn`` must be importable by
name: a module-level function of this package or of a test module's
helpers.

The rank bodies of ``tests/test_torch_mesh.py`` and
``tests/test_torch_sharded_round.py`` live here, so that a child imports
torch and the port only, never JAX.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import traceback

import multiprocessing as mp


def _entry(fn, rank, world, tmp, args, env):
    os.environ.update(env)
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch import mesh
    try:
        mesh.start("cpu", init_method=f"file://{tmp}/rendezvous", rank=rank,
                   world=world, timeout_s=300)
        out = fn(rank, world, *args)
        with open(os.path.join(tmp, f"{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        torch.distributed.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def spawn(fn, world, *args, timeout=300, env=None):
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each in
    its own gloo rank."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_entry,
                             args=(fn, r, world, tmp, args, env or {}))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errs = []
        for r, p in enumerate(procs):
            err = os.path.join(tmp, f"{r}.err")
            if os.path.exists(err):
                errs.append(f"rank {r}:\n" + open(err).read())
            elif p.exitcode != 0:
                errs.append(f"rank {r}: exit code {p.exitcode}")
        if errs:
            raise AssertionError("\n".join(errs))
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


# ---------------------------------------------------------------------------
# the quickstart MLP's sharded rounds (tests/test_torch_sharded_round.py)
# ---------------------------------------------------------------------------

DIM, NCLS, WIDTH = 16, 4, 8
MKEYS = ("consensus_dist", "pre_dist", "pull_force", "push_force",
         "train_loss", "lam_t")


def mlp_batches(rounds, tau, M, seed=0):
    """``rounds`` numpy batches ``(x (tau, M, 8, DIM), y (tau, M, 8))``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((tau, M, 8, DIM)).astype(np.float32),
             rng.integers(0, NCLS, size=(tau, M, 8)))
            for _ in range(rounds)]


def dcfg_of(case):
    """The case's DPPFConfig keywords (the same for both packages)."""
    kw = dict(alpha=0.2, lam=0.4, tau=case["tau"],
              consensus=case["method"], engine="flat")
    kw.update(case.get("dcfg", {}))
    return kw


def make_mesh(shape):
    """``"RxC"`` -> a flat (data, model) mesh; ``"WxFxM"`` ->
    hierarchical. Returns ``(mesh, plan)``."""
    from repro_torch.configs.base import MeshPlan
    from repro_torch.launch import mesh as mm
    dims = tuple(int(d) for d in shape.split("x"))
    if len(dims) == 3:
        return mm.make_hier_engine_mesh(*dims, device="cpu")
    return mm.Mesh(mm.FLAT_AXES, dims, device="cpu"), \
        MeshPlan(worker_axes=("data",), model_axes=("model",))


def _port_state(p0, dkw, M, mode):
    import dataclasses
    import torch
    from repro_torch.configs import DPPFConfig
    from repro_torch.optim import make_optimizer
    from repro_torch.train import init_train_state
    opt = make_optimizer("sgd", momentum=0.9)
    init = lambda gen, device: {l: {k: torch.tensor(v) for k, v in d.items()}
                                for l, d in p0.items()}
    dcfg = DPPFConfig(**dkw)
    st = init_train_state(init, opt, dcfg, M, None, device="cpu")
    if st.engine is None:        # ddp: the simple_avg layout (no aux rows)
        st = init_train_state(
            init, opt, dataclasses.replace(dcfg, consensus="simple_avg"),
            M, None, device="cpu")
    st.engine = dataclasses.replace(st.engine, use_kernel=mode == "kernel",
                                    precise=mode == "precise")
    return st, opt, dcfg


def sharded_cases(rank, world, p0, cases, meshes):
    """Every case on its mesh: ``rounds`` sharded rounds of the MLP from
    ``p0`` (numpy), batches from ``mlp_batches``. A case with ``warm``
    starts from one single-device ``staleness1`` round. Returns, per case,
    the whole (R, n) view and the snapshot (numpy) after the last round
    and each round's metrics."""
    import dataclasses

    import torch
    from repro_torch.benchmarks.common import mlp_loss
    from repro_torch.configs import DPPFConfig
    from repro_torch.train import (
        make_round_step, make_sharded_round_step, shard_train_state,
        unshard_params,
    )
    built = {shape: make_mesh(shape) for shape in meshes}
    out = {}
    for case in cases:
        mesh, plan = built[case["mesh"]]
        M, tau = case["M"], case["tau"]
        dkw = dcfg_of(case)
        st, opt, dcfg = _port_state(p0, dkw, M, case["mode"])
        data = mlp_batches(case["rounds"] + 1, tau, M)
        tb = lambda x, y: {"x": torch.tensor(x),
                           "y": torch.tensor(y, dtype=torch.int64)}
        first = 0
        if case.get("warm"):
            warm = DPPFConfig(**dict(dkw, overlap="staleness1"))
            st, _ = make_round_step(mlp_loss, opt, warm, base_lr=0.05,
                                    total_steps=40)(st, tb(*data[0]))
            first = 1
        sst = shard_train_state(st, mesh, plan, dcfg=dcfg)
        step = make_sharded_round_step(mlp_loss, opt, dcfg, mesh=mesh,
                                       plan=plan, base_lr=0.05,
                                       total_steps=40)
        m_loc = M // mesh.axis_size(plan.worker_axes)
        own = slice(mesh.lin_index(plan.worker_axes) * m_loc,
                    (mesh.lin_index(plan.worker_axes) + 1) * m_loc)
        metrics = []
        for r in range(first, first + case["rounds"]):
            b = {k: v[:, own] for k, v in tb(*data[r]).items()}
            sst, m = step(sst, b)
            metrics.append({k: float(m[k]) for k in MKEYS}
                           | {"staleness": int(m["staleness"])})
        full = unshard_params(sst, mesh, plan)
        res = {"params": full.numpy().copy(), "metrics": metrics}
        if not case.get("warm"):
            res["single"] = _single(p0, dkw, case, data, tb)
        if sst.snap is not None:
            x = sst.snap["x"]
            if dcfg.overlap == "doublebuf":      # this rank's rows valid
                L = sst.engine.layout
                x = unshard_params(dataclasses.replace(
                    sst, params=torch.cat([x[own], x[L.M:]])), mesh, plan)
            else:
                x = _cols(x, mesh, plan, sst.engine)
            res["snap"] = x.numpy().copy()
        out[case["name"]] = res
    return out if rank == 0 else None


def _cols(x, mesh, plan, engine):
    """A row-replicated (R, n_local) snapshot gathered over the columns."""
    from repro_torch.launch.mesh import all_gather, flat_col_axes
    return all_gather(x, mesh.group(flat_col_axes(mesh, engine.layout.n,
                                                  plan)), dim=1)


def _single(p0, dkw, case, data, tb):
    """The port's single-device rounds of a case."""
    from repro_torch.benchmarks.common import mlp_loss
    from repro_torch.train import make_round_step
    st, opt, dcfg = _port_state(p0, dkw, case["M"], case["mode"])
    step = make_round_step(mlp_loss, opt, dcfg, base_lr=0.05,
                           total_steps=40)
    metrics = []
    for r in range(case["rounds"]):
        st, m = step(st, tb(*data[r]))
        metrics.append({k: float(m[k]) for k in MKEYS}
                       | {"staleness": int(m["staleness"])})
    return {"params": st.params.numpy().copy(), "metrics": metrics,
            "snap": None if st.snap is None
            else st.snap["x"].numpy().copy()}


# ---------------------------------------------------------------------------
# the launcher (tests/test_torch_sharded_round.py)
# ---------------------------------------------------------------------------

def launcher_runs(rank, world, runs):
    """``launch.train.main(argv, device="cpu")`` for each argv in
    ``runs`` in this rank; returns each run's eval loss and what it
    printed."""
    import contextlib
    import io
    from repro_torch.launch.train import main
    out = []
    for argv in runs:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            loss = main(argv, device="cpu")
        out.append((loss, buf.getvalue()))
    return out


# ---------------------------------------------------------------------------
# the mesh and its collectives (tests/test_torch_mesh.py)
# ---------------------------------------------------------------------------

def mesh_checks(rank, world):
    """On a world of 4: each mesh's coordinates and groups, the gathers'
    concatenation order (dims 0 and 1, blocking and asynchronous), the
    all-reduce, and ``fused_round_sharded`` (its plain version on CPU
    tensors) on 2 and 4 column shards against ``fused_round`` on the
    whole view. Returns what rank 0 saw."""
    import numpy as np
    import torch
    from repro_torch.kernels.pullpush import pullpush as pk
    from repro_torch.launch import mesh as mm
    seen = {"transport": mm.transport("cpu")}
    for names, sizes in ((mm.FLAT_AXES, (2, 2)), (mm.FLAT_AXES, (1, 4)),
                         (mm.FLAT_AXES, (4, 1)), (mm.HIER_AXES, (2, 1, 2)),
                         (mm.HIER_AXES, (1, 2, 2))):
        mesh = mm.Mesh(names, sizes, device="cpu")
        key = "x".join(map(str, sizes))
        seen[key] = {"coords": dict(mesh.coords)}
        for axes in ([names[0]], list(names[1:]), [names[-1]]):
            axes = tuple(axes)
            g = mesh.group(axes)
            assert g.index == mesh.lin_index(axes)
            x = torch.full((2, 3), float(rank))
            rows = mm.all_gather(x, g)
            cols = mm.all_gather(x, g, dim=1, async_op=True).wait()
            tot = mm.all_reduce(torch.tensor([float(rank), 1.0]), g)
            seen[key][axes] = (rows[:, 0].tolist(), cols[0].tolist(),
                               tot.tolist(), g.size)
    # a blocking gather in column pieces (as staged on a card) equals the
    # whole gather
    mesh = mm.Mesh(mm.FLAT_AXES, (2, 2), device="cpu")
    x = torch.arange(3 * 50, dtype=torch.float32).reshape(3, 50) + rank
    for axes, dim in ((("data",), 0), (("model",), 1), (("data",), 1)):
        g = mesh.group(axes)
        old, mm.STAGE_BYTES = mm.STAGE_BYTES, 3 * 7 * 4
        try:
            pieces = mm._gather_in_pieces(x, g, dim)
        finally:
            mm.STAGE_BYTES = old
        seen[f"pieces{axes}{dim}"] = bool(torch.equal(
            pieces, mm.all_gather(x, g, dim)))
    # fused_round_sharded over 1, 2 and 4 column shards of one view
    gen = np.random.default_rng(0)
    x = torch.tensor(gen.standard_normal((5, 4000)).astype(np.float32)
                     * 2.0 + 1.0)
    T = torch.softmax(torch.tensor(gen.standard_normal((5, 5))
                                   .astype(np.float32)), dim=1)
    c0 = torch.linspace(0.1, 0.5, 5)
    c1 = torch.linspace(-0.4, -0.1, 5)
    want, want_r, _ = pk.fused_round(x.clone(), T, c0, c1)
    for cols in (1, 2, 4):
        mesh = mm.Mesh(mm.FLAT_AXES, (4 // cols, cols), device="cpu")
        g = mesh.group(("model",))
        n_loc = 4000 // cols
        a = g.index * n_loc
        shard = x[:, a:a + n_loc].contiguous()
        out, r, G = pk.fused_round_sharded(shard, T, c0, c1, group=g)
        scale = want[:, a:a + n_loc].abs().max(dim=1).values
        err = ((out - want[:, a:a + n_loc]).abs().max(dim=1).values
               / scale).max()
        seen[f"sharded{cols}"] = (float(err),
                                  float(((r - want_r).abs()
                                         / want_r.abs()).max()))
    return seen if rank == 0 else None

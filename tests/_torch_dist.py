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

import pytest


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread a test process: six xdist workers share the host's
    cores, and each worker's default pool would spin on all of them. A
    test module takes it by importing it (it is autouse)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# ---------------------------------------------------------------------------
# sharded staleness_k, elastic rounds and ring_gather
# (tests/test_torch_sharded_staleness_k.py)
# ---------------------------------------------------------------------------

def ring_checks(rank, world):
    """On a world of 8: ``ring_gather`` against ``all_gather`` (blocking
    and asynchronous, dims 0 and 1, blocks of 1 and 3 rows) on 8x1 and on
    the data axis of 2x2x2, the multi-axis fallback, a group of one.
    Returns, per check, whether the two are equal bit for bit."""
    import torch
    from repro_torch.launch import mesh as mm
    seen = {}
    for names, sizes in ((mm.FLAT_AXES, (8, 1)), (mm.HIER_AXES, (2, 2, 2))):
        mesh = mm.Mesh(names, sizes, device="cpu")
        key = "x".join(map(str, sizes))
        for axes in ((names[0],), tuple(names[1:])):
            g = mesh.group(axes)
            for m_loc in (1, 3):
                x = torch.arange(m_loc * 5, dtype=torch.float32).reshape(
                    m_loc, 5) * 0.37 + rank
                for dim in (0, 1):
                    want = mm.all_gather(x, g, dim)
                    got = mm.ring_gather(x, g, dim, axes=axes)
                    late = mm.ring_gather(x, g, dim, axes=axes,
                                          async_op=True).wait()
                    seen[f"{key}{axes}{m_loc}{dim}"] = bool(
                        torch.equal(got, want) and torch.equal(late, want))
        one = mesh.group(())
        x = torch.ones(2, 3)
        seen[f"{key}-one"] = mm.ring_gather(x, one) is x
    return seen if rank == 0 else None


def _mask_of(case, r, M):
    import numpy as np
    mask = np.ones(M, np.float32)
    if case.get("drop") and r in case["drop"][1]:
        mask[case["drop"][0]] = 0.0
    return mask, (0.0 if r in case.get("sync0", ()) else 1.0)


def _ring_rounds(st, step, case, data, tb, own=slice(None)):
    """``case["rounds"]`` rounds, the case's membership set before each."""
    from repro_torch.train import set_participation
    metrics = []
    for r in range(case["rounds"]):
        if case.get("drop") or case.get("sync0"):
            mask, sync = _mask_of(case, r, case["M"])
            st = set_participation(st, mask, sync=sync)
        b = {k: v[:, own] for k, v in tb(*data[r]).items()}
        st, m = step(st, b)
        metrics.append({k: float(m[k]) for k in MKEYS}
                       | {"staleness": int(m["staleness"])})
    return st, metrics


def _tb(x, y):
    import torch
    return {"x": torch.tensor(x), "y": torch.tensor(y, dtype=torch.int64)}


def _slots(sst, mesh, plan):
    """A sharded snapshot's slots as whole (R, n) numpy views (each slot's
    rows of this rank and aux rows gathered)."""
    import dataclasses
    import torch
    from repro_torch.train import unshard_params
    from repro_torch.train.trainer import _shard_of
    sh = _shard_of(sst.engine, mesh, plan)
    L = sst.engine.layout
    x = sst.snap["x"]
    out = []
    for s in (x if isinstance(x, list) else [x]):
        blk = torch.cat([s[sh.r_off:sh.r_off + sh.m_loc], s[L.M:]])
        out.append(unshard_params(dataclasses.replace(sst, params=blk),
                                  mesh, plan).numpy().copy())
    return out


def staleness_k_cases(rank, world, p0, cases, meshes):
    """Every case on its mesh, and (``single``) the port's single-device
    rounds of it: the whole view, the snapshot slots and each round's
    metrics after ``rounds`` rounds of the MLP from ``p0``, with the
    case's membership (``drop``: (row, rounds), ``sync0``: rounds with
    the quorum gate at 0)."""
    from repro_torch.benchmarks.common import mlp_loss
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
        data = mlp_batches(case["rounds"], tau, M)
        st, opt, dcfg = _port_state(p0, dkw, M, case["mode"])
        sst = shard_train_state(st, mesh, plan, dcfg=dcfg)
        step = make_sharded_round_step(mlp_loss, opt, dcfg, mesh=mesh,
                                       plan=plan, base_lr=0.05,
                                       total_steps=40)
        m_loc = M // mesh.axis_size(plan.worker_axes)
        i0 = mesh.lin_index(plan.worker_axes) * m_loc
        sst, metrics = _ring_rounds(sst, step, case, data, _tb,
                                    slice(i0, i0 + m_loc))
        res = {"params": unshard_params(sst, mesh, plan).numpy().copy(),
               "metrics": metrics, "snap": _slots(sst, mesh, plan)}
        if case.get("single", True):
            s1, opt, dcfg = _port_state(p0, dkw, M, case["mode"])
            f1 = make_round_step(mlp_loss, opt, dcfg, base_lr=0.05,
                                 total_steps=40)
            s1, m1 = _ring_rounds(s1, f1, case, data, _tb)
            x = s1.snap["x"]
            res["single"] = {
                "params": s1.params.numpy().copy(), "metrics": m1,
                "snap": [v.numpy().copy() for v in
                         (x if isinstance(x, list) else [x])]}
        out[case["name"]] = res
    return out if rank == 0 else None


def cross_mesh_resume(rank, world, p0, case, tmp):
    """A checkpoint written on 2x2x2 after two rounds resumes on 8x1 for
    two more (each rank reading its blocks), whose checkpoint resumes
    unsharded (rank 0) for the last two; against six single-device
    rounds. Returns rank 0's views and
    the resumed states' round counters."""
    import os
    from repro_torch.benchmarks.common import mlp_loss
    from repro_torch.checkpoint import load_train_state, save_train_state
    from repro_torch.train import (
        make_round_step, make_sharded_round_step, shard_train_state,
    )
    M, tau = case["M"], case["tau"]
    dkw = dcfg_of(case)
    data = mlp_batches(6, tau, M)
    legs = (("2x2x2", 0), ("8x1", 2), (None, 4))
    st = None
    rounds_seen = []
    for i, (shape, r0) in enumerate(legs):
        like, opt, dcfg = _port_state(p0, dkw, M, case["mode"])
        mesh = plan = None
        if shape is not None:
            mesh, plan = make_mesh(shape)
            like = shard_train_state(like, mesh, plan, dcfg=dcfg)
        if i:
            # a sharded leg reads its own blocks (load_train_state's mesh)
            st = load_train_state(os.path.join(tmp, f"leg{i - 1}.npz"),
                                  like, in_place=True, mesh=mesh, plan=plan)
            rounds_seen.append(st.round)
        else:
            st = like
        leg = dict(case, rounds=2)
        sub = [data[r] for r in range(r0, r0 + 2)]
        shifted = dict(leg)
        if leg.get("drop"):
            shifted["drop"] = (leg["drop"][0],
                               [r - r0 for r in leg["drop"][1]])
        if shape is None:
            if rank == 0:
                f = make_round_step(mlp_loss, opt, dcfg, base_lr=0.05,
                                    total_steps=40)
                st, _ = _ring_rounds(st, f, shifted, sub, _tb)
            break
        f = make_sharded_round_step(mlp_loss, opt, dcfg, mesh=mesh,
                                    plan=plan, base_lr=0.05, total_steps=40)
        m_loc = M // mesh.axis_size(plan.worker_axes)
        i0 = mesh.lin_index(plan.worker_axes) * m_loc
        sst, _ = _ring_rounds(st, f, shifted, sub, _tb,
                              slice(i0, i0 + m_loc))
        save_train_state(os.path.join(tmp, f"leg{i}.npz"), sst, mesh=mesh,
                         plan=plan)
    if rank:
        return None
    s1, opt, dcfg = _port_state(p0, dkw, M, case["mode"])
    f1 = make_round_step(mlp_loss, opt, dcfg, base_lr=0.05, total_steps=40)
    s1, _ = _ring_rounds(s1, f1, dict(case, rounds=6), data, _tb)
    return {"resumed": st.params.numpy().copy(),
            "straight": s1.params.numpy().copy(),
            "snap": [v.numpy().copy() for v in st.snap["x"]],
            "snap_straight": [v.numpy().copy() for v in s1.snap["x"]],
            "rounds": rounds_seen, "t": st.t, "round": st.round}


def _leaves_of(st):
    """A TrainState's tensors by checkpoint key, a ring's slots apart."""
    from repro_torch.checkpoint.io import _items, _key, _state_tree
    out = {}
    for p, leaf in _items(_state_tree(st)):
        for i, t in enumerate(leaf if isinstance(leaf, list) else [leaf]):
            out[f"{_key(p)}[{i}]"] = t
    return out


def sharded_load_checks(rank, world, p0, case, tmp):
    """On a world of 8: files written by the single-device rounds (three
    elastic k = 2 rounds; the same at k = 1; an exact-mode run's, which
    has no snapshot; one without ``snap::sync``, as from before the
    quorum gate), each loaded
    on 8x1, 2x2x2 and 4x2 by each rank's block reads, into its shard in
    place and into ``state_template`` of it (meta tensors), against
    ``shard_train_state`` of the whole loaded state. Returns rank 0's
    {check: whether every leaf, t and round are equal bit for bit}."""
    import os
    import zipfile

    import torch
    from repro_torch.benchmarks.common import mlp_loss
    from repro_torch.checkpoint import load_train_state, save_train_state
    from repro_torch.train import (
        make_round_step, set_participation, shard_train_state,
        state_template,
    )
    M, tau = case["M"], case["tau"]
    dkw = dcfg_of(case)
    k1 = dict(dkw, staleness=1)
    data = mlp_batches(3, tau, M)
    files, like_of = {}, {"exact": dkw, "legacy": dkw}
    for kind, kw in (("ring", dkw), ("ring1", k1),
                     ("exact", dict(dkw, overlap="none", elastic=False))):
        like_of.setdefault(kind, kw)
        st, opt, dcfg = _port_state(p0, kw, M, case["mode"])
        f = make_round_step(mlp_loss, opt, dcfg, base_lr=0.05,
                            total_steps=40)
        for r, (x, y) in enumerate(data):
            if kind == "ring":
                mask, sync = _mask_of(case, r, M)
                st = set_participation(st, mask, sync=sync)
            st, _ = f(st, _tb(x, y))
        files[kind] = os.path.join(tmp, f"{kind}.npz")
        if rank == 0:
            save_train_state(files[kind], st)
    files["legacy"] = os.path.join(tmp, "legacy.npz")
    if rank == 0:
        with zipfile.ZipFile(files["ring"]) as zin, zipfile.ZipFile(
                files["legacy"], "w") as zout:
            for name in zin.namelist():
                if name != "snap::sync.npy":
                    zout.writestr(name, zin.read(name))
    torch.distributed.barrier()
    seen = {}
    for shape in ("8x1", "2x2x2", "4x2"):
        mesh, plan = make_mesh(shape)
        for kind, path in files.items():
            kw = like_of[kind]
            whole, _, dcfg = _port_state(p0, kw, M, case["mode"])
            want = shard_train_state(load_train_state(path, whole), mesh,
                                     plan, dcfg=dcfg)
            fresh = shard_train_state(
                _port_state(p0, kw, M, case["mode"])[0], mesh, plan,
                dcfg=dcfg)
            for how, like, kw in (
                    ("in_place", fresh, dict(in_place=True)),
                    ("template", state_template(fresh),
                     dict(device="cpu"))):
                got = load_train_state(path, like, mesh=mesh, plan=plan,
                                       **kw)
                a, b = _leaves_of(got), _leaves_of(want)
                seen[f"{shape}-{kind}-{how}"] = (
                    sorted(a) == sorted(b)
                    and all(torch.equal(a[k], b[k]) for k in a)
                    and (got.t, got.round) == (want.t, want.round)
                    and (how != "in_place" or got.params is fresh.params))
    return seen if rank == 0 else None


def local_step_fault(rank, world, p0, case, tmp, kind):
    """On a world of 4 (the 2x2 mesh): four sharded staleness_k k = 1
    rounds under a ``train.Supervisor`` with rotation checkpoints, in
    which rank 1 raises inside its local steps of round 2 (its second
    loss, after the first chunk gather went out), once: ``kind`` "error"
    (a RuntimeError) or "oom" (``torch.cuda.OutOfMemoryError``); and the
    same rounds without the fault. Returns this rank's events, counters,
    final batch and the whole view of both runs."""
    import os

    import torch
    from repro_torch.benchmarks.common import mlp_loss
    from repro_torch.train import (
        RoundClock, Supervisor, make_sharded_round_step, shard_train_state,
        unshard_params,
    )
    M, tau = case["M"], case["tau"]
    dkw = dcfg_of(case)
    data = mlp_batches(4, tau, M)
    mesh, plan = make_mesh("2x2")
    m_loc = M // mesh.axis_size(plan.worker_axes)
    own = slice(mesh.lin_index(plan.worker_axes) * m_loc,
                (mesh.lin_index(plan.worker_axes) + 1) * m_loc)
    out = {}
    for run in ("fault", "straight"):
        st, opt, dcfg = _port_state(p0, dkw, M, case["mode"])
        st = shard_train_state(st, mesh, plan, dcfg=dcfg)
        clock = RoundClock.from_config(dcfg, base_lr=0.05, total_steps=40)
        calls = {"round": 0, "n": 0, "fired": False}

        def loss(params, batch):
            if run == "fault" and rank == 1 and calls["round"] == 2 \
                    and not calls["fired"]:
                calls["n"] += 1
                if calls["n"] == 2:
                    calls["fired"] = True
                    raise (RuntimeError("boom") if kind == "error" else
                           torch.cuda.OutOfMemoryError(
                               "CUDA out of memory. Tried to allocate "
                               "2.00 GiB"))
            return mlp_loss(params, batch)

        def batch_fn(spec, bs):
            calls["round"] = spec.index
            b = _tb(*data[spec.index])
            return {k: v[:, own, :bs] for k, v in b.items()}

        step = make_sharded_round_step(loss, opt, dcfg, mesh=mesh,
                                       plan=plan, clock=clock)
        sup = Supervisor(clock, workers=M, retry_budget=2,
                         ckpt_dir=os.path.join(tmp, run), batch_size=8,
                         mesh=mesh, plan=plan)
        st = sup.run(st, step, batch_fn, end_round=4)
        out[run] = dict(sup.summary(),
                        params=unshard_params(st, mesh, plan).numpy().copy())
    return out

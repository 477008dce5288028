"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's, on the quickstart MLP (dim 16, 4 classes, width 8) and reduced
yi-6b:

* the file format crosses packages both ways: a reference train state
  (the (R, n) view, momentum, the staleness_k ring as (k, R, n) and the
  elastic ``act`` / ``active`` / ``missed`` / ``sync``) loads into the
  port bit for bit and resumes: the port's next rounds against the
  reference's within one fp32 ulp an entry, eps32 * max(|x|, 1) = 1.19e-7
  at the MLP's scale (precise; the packages' local steps round apart by
  that, as ``tests/test_torch_sharded_round.py`` found); the port's file
  loads in the reference's ``load_train_state`` bit for bit; final
  parameters go both ways, and a reference final-params file serves
  through ``launch.serve --ckpt``;
* the reference's bf16 fault (``src/repro/checkpoint/io.py:113``): for
  the same bf16 file its ``load_pytree`` raises "No cast function
  available", the port's loads the exact bits;
* crash-safe writes and the corrupt-archive ``ValueError`` naming the
  path (the restore ladder's contract); a large entry's ZIP64 records;
* the reference's resume pins, in the port: ``tests/test_staleness_k.py``
  (resume mid-pipeline at rounds 1 and 3, the snapless ring broadcast,
  the elastic rejoin across a resume) and ``tests/test_sharded_round.py:
  538-621`` (resume equals a straight run for none / staleness1 /
  doublebuf; the format guard and the snapshot fallback);
* the launcher: ``--ckpt`` on a run stopped early, then a resume, equals a
  straight run bit for bit; a mid-round resume point is refused."""
from __future__ import annotations

import dataclasses
import os
import struct
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from benchmarks.common import mlp_init, mlp_loss
from repro.checkpoint import load_pytree as jload_pytree
from repro.checkpoint import load_train_state as jload_train_state
from repro.checkpoint import save_pytree as jsave_pytree
from repro.checkpoint import save_train_state as jsave_train_state
from repro.configs import DPPFConfig as JDPPFConfig
from repro.core.engine import ConsensusEngine as JEngine
from repro.optim import make_optimizer as jmake_optimizer
from repro.train import init_train_state as jinit_train_state
from repro.train import make_round_step as jmake_round_step
from repro.train import set_participation as jset_participation
from repro_torch.benchmarks.common import mlp_loss as tmlp_loss
from repro_torch.checkpoint import (
    load_pytree, load_train_state, save_pytree, save_train_state,
)
from repro_torch.checkpoint import io as ckio
from repro_torch.configs import DPPFConfig
from repro_torch.train import (
    RoundClock, make_round_step, set_participation, state_template,
)

M, TAU = 4, 2
ELASTIC = dict(alpha=0.2, lam=0.4, tau=TAU, engine="flat",
               overlap="staleness_k", staleness=2, elastic=True,
               elastic_catchup=0.5, lam_schedule="fixed")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _p0():
    return jax.tree.map(np.asarray, mlp_init(jax.random.PRNGKey(0), td.DIM,
                                             td.NCLS, td.WIDTH))


def _port(dkw, mode="precise"):
    """The port's state (from the reference's initial MLP), optimizer and
    config."""
    return td._port_state(_p0(), dict(dkw, consensus=dkw.get(
        "consensus", "simple_avg")), M, mode)


def _ref(dkw, mode="precise"):
    jd = JDPPFConfig(**dict(dkw, consensus=dkw.get("consensus",
                                                     "simple_avg")))
    jp0 = mlp_init(jax.random.PRNGKey(0), td.DIM, td.NCLS, td.WIDTH)
    jstacked = jax.tree.map(
        lambda a: jnp.broadcast_to(a[None], (M,) + a.shape), jp0)
    jeng = JEngine.from_stacked(jstacked, method=jd.consensus, eps=jd.eps,
                                use_kernel=False, precise=mode == "precise")
    jopt = jmake_optimizer("sgd", momentum=0.9)
    st = jinit_train_state(lambda k: jp0, jopt, jd, M, jax.random.PRNGKey(0),
                           engine=jeng)
    return st, jopt, jd


def _mask(r, drop=(1, (2, 3))):
    m = np.ones(M, np.float32)
    if r in drop[1]:
        m[drop[0]] = 0.0
    return m


def _batches(n):
    return td.mlp_batches(n, TAU, M)


def _tb(x, y):
    return {"x": torch.tensor(x), "y": torch.tensor(y, dtype=torch.int64)}


def _jb(x, y):
    return {"x": jnp.asarray(x), "y": jnp.asarray(y, jnp.int32)}


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _ring(st):
    x = st.snap["x"]
    return np.stack([_np(v) for v in x]) if isinstance(x, list) else _np(x)


def _ulps(a, b):
    """Largest |a - b| in units of eps32 * max(|a|, |b|, 1): one fp32 ulp
    of the entry, or of 1 below it (1.19e-7 there)."""
    scale = np.maximum(np.maximum(np.abs(a), np.abs(b)), 1.0)
    return float(np.max(np.abs(a - b) / (np.finfo(np.float32).eps
                                          * scale)))


def _run_port(st, step, data, rounds, elastic=True):
    for r in rounds:
        if elastic:
            st = set_participation(st, _mask(r))
        st, _ = step(st, _tb(*data[r]))
    return st


def _run_ref(st, step, data, rounds):
    for r in rounds:
        st = jset_participation(st, jnp.asarray(_mask(r)))
        st, _ = step(st, _jb(*data[r]))
    return st


# ---------------------------------------------------------------------------
# the file format
# ---------------------------------------------------------------------------

def test_checkpoint_atomic_write_and_corrupt_errors(tmp_path):
    tree = {"w": torch.arange(32.0).reshape(8, 4), "b": torch.zeros(4)}
    like = {k: torch.zeros_like(v) for k, v in tree.items()}
    path = str(tmp_path / "ck.npz")
    save_pytree(path, tree)
    # atomic rename: no stray temp files next to the final archive
    assert os.listdir(str(tmp_path)) == ["ck.npz"]
    out, _ = load_pytree(path, like)
    assert torch.equal(out["w"], tree["w"])
    # the reference reads it as np.savez's own archive
    jout, _ = jload_pytree(path, jax.tree.map(lambda t: np.zeros(
        t.shape, np.float32), like))
    np.testing.assert_array_equal(np.asarray(jout["w"]), tree["w"].numpy())
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])
    with pytest.raises(ValueError, match="truncated or corrupt") as ei:
        load_pytree(path, like)
    assert "ck.npz" in str(ei.value)
    with open(path, "wb") as f:
        f.write(b"\x00" * 100)
    with pytest.raises(ValueError, match="truncated or corrupt"):
        load_pytree(path, like)
    with pytest.raises(FileNotFoundError):
        load_pytree(str(tmp_path / "nope.npz"), like)
    # a template mismatch is a clear error, never a silent reshape
    save_pytree(path, tree)
    with pytest.raises(ValueError, match="shape"):
        load_pytree(path, {"w": torch.zeros(4, 8), "b": torch.zeros(4)})
    with pytest.raises(ValueError, match="no leaf"):
        load_pytree(path, dict(like, c=torch.zeros(1)))


def test_checkpoint_streams_pieces_with_zip64(tmp_path, monkeypatch):
    """Leaves move in pieces of ``PIECE_BYTES`` (a small one here), every
    entry carries ZIP64 records as np.savez writes them, and the pieces
    reassemble bit for bit in both packages."""
    monkeypatch.setattr(ckio, "PIECE_BYTES", 96)
    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn((7, 33), generator=gen),
            "n": torch.arange(50, dtype=torch.int32)}
    path = str(tmp_path / "p.npz")
    save_pytree(path, tree, extra={"steps": 3})
    out, extra = load_pytree(path, {k: torch.empty_like(v)
                                    for k, v in tree.items()})
    assert all(torch.equal(out[k], tree[k]) for k in tree)
    assert int(extra["steps"]) == 3
    with np.load(path) as data:
        np.testing.assert_array_equal(data["a"], tree["a"].numpy())
    with open(path, "rb") as f:
        raw = f.read()
    with zipfile.ZipFile(path) as zf:
        for info in zf.infolist():
            # the local header's extra field opens with the ZIP64 record
            off = info.header_offset
            n, m = struct.unpack("<HH", raw[off + 26:off + 30])
            assert raw[off + 30 + n:off + 32 + n] == b"\x01\x00", \
                info.filename


def test_bf16_reference_fault_and_the_port_reads_the_bits(tmp_path):
    """The reference writes a bf16 leaf as raw '<V2' records and its own
    ``load_pytree`` cannot cast them back (ROADMAP Queue 3); the port reads
    the same file to the exact bits, and writes bf16 the same way."""
    w = jnp.asarray(np.linspace(-3, 3, 12).reshape(3, 4), jnp.bfloat16)
    b = jnp.asarray(np.arange(4), jnp.float32)
    path = str(tmp_path / "bf16.npz")
    jsave_pytree(path, {"w": w, "b": b})
    with np.load(path) as data:
        assert data["w"].dtype == np.dtype("V2")
    with pytest.raises(ValueError, match="No cast function available"):
        jload_pytree(path, {"w": w, "b": b})
    like = {"w": torch.zeros((3, 4), dtype=torch.bfloat16),
            "b": torch.zeros(4)}
    out, _ = load_pytree(path, like)
    assert out["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out["w"].view(torch.int16).numpy(),
        np.asarray(w).view(np.int16))
    # the port's bf16 file: '<V2' records with the same bits
    mine = str(tmp_path / "mine.npz")
    save_pytree(mine, out)
    with np.load(mine) as a, np.load(path) as r:
        assert a["w"].dtype == np.dtype("V2")
        assert a["w"].tobytes() == r["w"].tobytes()


def test_final_params_cross_packages_and_serve_ckpt(tmp_path):
    """Reduced yi-6b's parameters: a reference final-params file loads
    into the port's tree bit for bit and serves through ``launch.serve
    --ckpt`` exactly as the port's own file of the same weights; the
    port's file loads in the reference."""
    from repro.configs import get_arch as jget_arch, reduced as jreduced
    from repro.models import build_model as jbuild_model
    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import build_model, params_from_numpy
    jmodel = jbuild_model(jreduced(jget_arch("yi-6b")))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(3))
    ref_file = str(tmp_path / "ref.npz")
    jsave_pytree(ref_file, jparams, extra={"steps": 8})
    cfg = reduced(get_arch("yi-6b"))
    model = build_model(cfg)
    like = model.init(torch.Generator().manual_seed(0), "cpu")
    got, extra = load_pytree(ref_file, like)
    want = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    from repro_torch.core.engine import tree_items
    for (pa, a), (pb, b) in zip(tree_items(got), tree_items(want)):
        assert pa == pb and torch.equal(a, b), pa
    assert int(extra["steps"]) == 8
    mine = str(tmp_path / "mine.npz")
    save_pytree(mine, want, extra={"steps": 8})
    back, _ = jload_pytree(mine, jparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    argv = ["--arch", "yi-6b", "--smoke", "--requests", "3", "--max-slots",
            "2",
            "--prompt-len", "8", "--new-tokens", "3", "--chunk", "4"]
    a = serve_main(argv + ["--ckpt", ref_file], device="cpu")
    b = serve_main(argv + ["--ckpt", mine], device="cpu")
    c = serve_main(argv, device="cpu")
    toks = lambda r: [r.results[i].tokens for i in sorted(r.results)]
    assert toks(a) == toks(b)
    assert toks(a) != toks(c)          # the random init is not the file


def test_train_state_crosses_packages_both_ways(tmp_path):
    """Elastic staleness_k (k = 2), precise mode: the reference's state
    after 3 rounds (row 1 out in rounds 2-3) loads into the port bit for
    bit and both packages run 3 more rounds (view and ring within one
    fp32 ulp an entry); the port's state after 3 rounds loads into the
    reference's ``load_train_state`` bit for bit."""
    data = _batches(6)
    jst, jopt, jd = _ref(ELASTIC)
    jstep = jax.jit(jmake_round_step(mlp_loss, jopt, jd, base_lr=0.05,
                                     total_steps=40))
    jst = _run_ref(jst, jstep, data, range(3))
    ref_file = str(tmp_path / "ref.state.npz")
    jsave_train_state(ref_file, jst)
    like, opt, dcfg = _port(ELASTIC)
    st = load_train_state(ref_file, like)
    assert st.round == 3 and st.t == 3 * TAU
    np.testing.assert_array_equal(_np(st.params), np.asarray(jst.params))
    np.testing.assert_array_equal(_ring(st), np.asarray(jst.snap["x"]))
    for k in ("losses", "gns", "act", "active", "missed", "sync"):
        np.testing.assert_array_equal(_np(st.snap[k]),
                                      np.asarray(jst.snap[k]), err_msg=k)
    np.testing.assert_array_equal(_np(st.opt["mu"]),
                                  np.asarray(jst.opt["mu"]))
    step = make_round_step(tmlp_loss, opt, dcfg, base_lr=0.05,
                           total_steps=40)
    st = _run_port(st, step, data, range(3, 6))
    jst = _run_ref(jst, jstep, data, range(3, 6))
    assert _ulps(_np(st.params), np.asarray(jst.params)) <= 1.0
    assert _ulps(_ring(st), np.asarray(jst.snap["x"])) <= 1.0
    # the port's file in the reference
    pst, opt, dcfg = _port(ELASTIC)
    pstep = make_round_step(tmlp_loss, opt, dcfg, base_lr=0.05,
                            total_steps=40)
    pst = _run_port(pst, pstep, data, range(3))
    mine = str(tmp_path / "port.state.npz")
    save_train_state(mine, pst)
    jlike, _, _ = _ref(ELASTIC)
    back = jload_train_state(mine, jlike)
    assert int(back.round) == 3 and int(back.t) == 3 * TAU
    np.testing.assert_array_equal(np.asarray(back.params), _np(pst.params))
    np.testing.assert_array_equal(np.asarray(back.snap["x"]), _ring(pst))
    for k in ("losses", "gns", "act", "active", "missed", "sync"):
        np.testing.assert_array_equal(np.asarray(back.snap[k]),
                                      _np(pst.snap[k]), err_msg=k)
    assert np.asarray(back.snap["missed"]).dtype == np.int32


def test_state_template_holds_shapes_only(monkeypatch):
    from repro_torch.train import trainer
    monkeypatch.setattr(trainer, "_SMALL", 64)     # the MLP is all small
    st, _, _ = _port(ELASTIC)
    like = state_template(st)
    assert like.params.is_meta and like.opt["mu"].is_meta
    assert all(s.is_meta for s in like.snap["x"])
    assert not like.snap["missed"].is_meta       # small: a CPU copy
    assert like.engine is st.engine


# ---------------------------------------------------------------------------
# the reference's resume pins, in the port
# ---------------------------------------------------------------------------

def _sk_setup(dkw, steps=12):
    st, opt, dcfg = _port(dkw)
    clock = RoundClock.from_config(dcfg, base_lr=0.05, total_steps=steps)
    return st, make_round_step(tmlp_loss, opt, dcfg, clock=clock), clock


@pytest.mark.parametrize("stop_round", [1, 3])
def test_checkpoint_resume_mid_pipeline(tmp_path, stop_round):
    """staleness_k (k = 2) saved in its fill (round 1) and in its steady
    state (round 3) resumes bit for bit: the ring, the round counter and
    the clock position round-trip."""
    dkw = dict(ELASTIC, elastic=False)
    data = _batches(6)
    full, step, clock = _sk_setup(dkw)
    half, _, _ = _sk_setup(dkw)
    for r in range(6):
        full, _ = step(full, _tb(*data[r]))
        if r < stop_round:
            half, _ = step(half, _tb(*data[r]))
    path = str(tmp_path / "mid.npz")
    save_train_state(path, half)
    like, _, _ = _sk_setup(dkw)
    res = load_train_state(path, like, clock=clock)
    assert res.round == stop_round
    np.testing.assert_array_equal(_ring(res), _ring(half))
    for r in range(stop_round, 6):
        res, m = step(res, _tb(*data[r]))
    assert m["staleness"] == 2
    np.testing.assert_array_equal(_np(res.params), _np(full.params))


def test_checkpoint_snapless_resume_broadcasts_ring(tmp_path):
    d_ex = dict(alpha=0.2, lam=0.4, tau=TAU, engine="flat",
                lam_schedule="fixed")
    st, opt, dcfg = _port(d_ex)
    st, _ = make_round_step(tmlp_loss, opt, dcfg, base_lr=0.05,
                            total_steps=20)(st, _tb(*_batches(1)[0]))
    path = str(tmp_path / "exact.npz")
    save_train_state(path, st)
    like, _, _ = _port(dict(d_ex, overlap="staleness_k", staleness=3))
    res = load_train_state(path, like)
    assert len(res.snap["x"]) == 3
    for slot in res.snap["x"]:
        assert torch.equal(slot, st.params)
    # the same from a template of shapes only (what the supervisor holds)
    res2 = load_train_state(path, state_template(like))
    for slot in res2.snap["x"]:
        assert torch.equal(slot, st.params)
    assert torch.equal(res2.snap["gns"], torch.ones(3, M))


def test_elastic_rejoin_across_checkpoint_resume(tmp_path):
    """Saved mid-drop (row 1 out in rounds 2-3, its missed counter live),
    the run resumes bit for bit against the uninterrupted one: the
    participation ring, the counters, the sync gate and the catch-up."""
    data = _batches(6)
    full, step, clock = _sk_setup(ELASTIC)
    half, _, _ = _sk_setup(ELASTIC)
    full = _run_port(full, step, data, range(6))
    half = _run_port(half, step, data, range(3))
    assert int(half.snap["missed"][1]) == 1
    path = str(tmp_path / "middrop.npz")
    save_train_state(path, half)
    like, _, _ = _sk_setup(ELASTIC)
    res = load_train_state(path, like, clock=clock)
    assert res.round == 3 and int(res.snap["missed"][1]) == 1
    assert float(res.snap["sync"]) == 1.0
    assert torch.equal(res.snap["active"], half.snap["active"])
    res = _run_port(res, step, data, range(3, 6))
    assert torch.equal(res.params, full.params)
    assert torch.equal(res.snap["missed"], full.snap["missed"])
    np.testing.assert_array_equal(_ring(res), _ring(full))


def test_legacy_checkpoint_sync_backfill(tmp_path):
    st, step, clock = _sk_setup(ELASTIC)
    st, _ = step(st, _tb(*_batches(1)[0]))
    legacy = dataclasses.replace(
        st, snap={k: v for k, v in st.snap.items() if k != "sync"})
    path = str(tmp_path / "legacy.npz")
    save_train_state(path, legacy)
    like, _, _ = _sk_setup(ELASTIC)
    res = load_train_state(path, like, clock=clock)
    assert float(res.snap["sync"]) == 1.0
    np.testing.assert_array_equal(_ring(res), _ring(st))


@pytest.mark.parametrize("overlap", ["none", "staleness1", "doublebuf"])
def test_train_state_checkpoint_resume_matches_straight_run(tmp_path,
                                                            overlap):
    dkw = dict(alpha=0.2, lam=0.4, tau=TAU, engine="flat", overlap=overlap,
               overlap_chunks=2)
    data = _batches(4)
    straight, opt, dcfg = _port(dkw, "fast")
    resumed, _, _ = _port(dkw, "fast")
    step = make_round_step(tmlp_loss, opt, dcfg, base_lr=0.05,
                           total_steps=20)
    for r in range(2):
        straight, _ = step(straight, _tb(*data[r]))
        resumed, _ = step(resumed, _tb(*data[r]))
    path = str(tmp_path / "state.npz")
    save_train_state(path, resumed)
    template, _, _ = _port(dkw, "fast")
    resumed = load_train_state(path, template)
    assert resumed.t == 2 * TAU
    if overlap != "none":
        assert resumed.snap is not None
    for r in range(2, 4):
        straight, _ = step(straight, _tb(*data[r]))
        resumed, _ = step(resumed, _tb(*data[r]))
    assert torch.equal(straight.params, resumed.params)
    assert torch.equal(straight.opt["mu"], resumed.opt["mu"])


def test_load_train_state_format_guard_and_snap_fallback(tmp_path):
    bad = str(tmp_path / "final.npz")
    save_pytree(bad, {"w": torch.zeros((3, 3))})
    dkw = dict(alpha=0.2, lam=0.4, tau=TAU, engine="flat")
    template, opt, dcfg = _port(dkw, "fast")
    with pytest.raises(ValueError, match="train-state"):
        load_train_state(bad, template)
    exact, _, _ = _port(dkw, "fast")
    exact, _ = make_round_step(tmlp_loss, opt, dcfg, base_lr=0.05,
                               total_steps=20)(exact, _tb(*_batches(1)[0]))
    path = str(tmp_path / "exact.npz")
    save_train_state(path, exact)
    for mode in ("staleness1", "doublebuf"):
        d_o = dict(dkw, overlap=mode)
        tmpl, opt_o, dcfg_o = _port(d_o, "fast")
        res = load_train_state(path, tmpl)
        assert res.snap is not None and res.t == TAU
        assert torch.equal(res.snap["x"], exact.params)
        assert torch.equal(res.params, exact.params)
        cont, m = make_round_step(tmlp_loss, opt_o, dcfg_o, base_lr=0.05,
                                  total_steps=20)(res, _tb(*_batches(2)[1]))
        assert m["staleness"] == 1
        assert np.isfinite(float(m["consensus_dist"]))


def test_round_counter_clock_fallback(tmp_path):
    """A checkpoint that carries only ``t`` takes its round from the clock
    (or None without one, and the round builders use t // tau)."""
    st, step, clock = _sk_setup(ELASTIC)
    st, _ = step(st, _tb(*_batches(1)[0]))
    path = str(tmp_path / "old.npz")
    save_train_state(path, dataclasses.replace(st, round=None))
    like, _, _ = _sk_setup(ELASTIC)
    assert load_train_state(path, like, clock=clock).round == 1
    res = load_train_state(path, like)
    assert res.round is None
    res, m = step(res, _tb(*_batches(2)[1]))
    assert res.round == 2


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

LAUNCH = ["--arch", "yi-6b", "--smoke", "--workers", "4", "--tau", "2",
          "--steps", "8", "--seq", "16", "--batch", "2", "--log-every", "1",
          "--overlap", "staleness_k", "--staleness", "1",
          "--elastic-drop", "2,1,3", "--quorum", "4"]


def _stopped_at(monkeypatch, end_round):
    """``launch.train``'s supervisor ends its run before ``end_round`` (a
    preempted run): the launcher then writes the resume point there."""
    from repro_torch.launch import train as lt

    class Stopped(lt.Supervisor):
        def run(self, *a, **kw):
            return super().run(*a, end_round=end_round, **kw)
    monkeypatch.setattr(lt, "Supervisor", Stopped)


def test_launcher_ckpt_stop_and_resume_equals_straight_run(tmp_path, capsys,
                                                           monkeypatch):
    """``--ckpt`` on a run stopped before round 2, then the same flags
    again: the resumed run's final parameters, resume point and eval loss
    equal the straight run's bit for bit; the supervisor's degrade events
    split between the two halves."""
    from repro_torch.launch.train import main
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    want = main(LAUNCH + ["--ckpt", a], device="cpu")
    out_a = capsys.readouterr().out
    with monkeypatch.context() as m:
        _stopped_at(m, 2)
        main(LAUNCH + ["--ckpt", b], device="cpu")
    out_b1 = capsys.readouterr().out
    with np.load(b[:-4] + ".state.npz") as f:
        assert int(f["__extra__::round"]) == 2
    got = main(LAUNCH + ["--ckpt", b], device="cpu")
    out_b2 = capsys.readouterr().out
    assert got == want
    assert "supervisor events: r1:degrade r2:degrade" in out_a
    assert "supervisor events: r1:degrade" in out_b1
    assert "resumed from" in out_b2 and "(round 2)" in out_b2
    assert "supervisor events: r2:degrade" in out_b2
    with np.load(a) as fa, np.load(b) as fb:
        assert sorted(fa.files) == sorted(fb.files)
        for k in fa.files:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    with np.load(a[:-4] + ".state.npz") as fa, \
            np.load(b[:-4] + ".state.npz") as fb:
        for k in fa.files:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    # a resume point that lands mid-round in another plan is refused
    with pytest.raises(ValueError, match="mid-round"):
        main(LAUNCH[:-4] + ["--ckpt", b, "--tau", "3", "--steps", "9",
                            "--elastic-drop", "2,1,3", "--quorum", "4"],
             device="cpu")


def test_train_then_serve_at_a_cut_depth(tmp_path, monkeypatch):
    """A checkpoint trained at one layer (``train --smoke --layers 1``)
    serves on the serving launcher's config cut to one layer, and a
    template of another depth is refused (a missing leaf), never
    reshaped."""
    from repro_torch.configs import reduced
    from repro_torch.launch import serve
    from repro_torch.launch.train import main as train_main
    ck = str(tmp_path / "one.npz")
    train_main(["--arch", "yi-6b", "--smoke", "--layers", "1", "--workers",
                "2", "--tau", "2", "--steps", "2", "--seq", "16", "--batch",
                "2", "--ckpt", ck], device="cpu")
    argv = ["--arch", "yi-6b", "--smoke", "--requests", "2", "--max-slots",
            "2", "--prompt-len", "8", "--new-tokens", "2", "--ckpt", ck]
    with monkeypatch.context() as m:
        m.setattr(serve, "reduced",
                  lambda cfg, **kw: reduced(cfg, **dict(kw, n_layers=1)))
        report = serve.main(argv, device="cpu")
    assert sorted(report.results) == [0, 1]
    with pytest.raises(ValueError, match="shape|no leaf"):
        serve.main(argv, device="cpu")


"""Checkpointing: trees of tensors <-> npz with path-flattened keys.

Counterpart of ``repro/checkpoint/io.py``, in its file format, so that a
checkpoint written by either package loads in the other: an uncompressed
zip of ``.npy`` entries (what ``np.savez`` writes), keyed by the leaf's
path joined with ``::`` in ``jax.tree_util``'s flatten order
(``core.engine.tree_items``), plus ``__extra__::<name>`` scalars. A bf16
leaf is written as the reference writes it, raw 2-byte ``'<V2'`` records,
and read back as bf16 bits (the reference's own ``load_pytree`` cannot
cast them back: ROADMAP Queue 3).

The writer streams: each leaf goes to its entry in pieces of at most
``PIECE_BYTES`` copied from the device (through one page-locked buffer),
so host memory holds one piece,
not the state, and entries larger than 4 GiB get ZIP64 records as
``np.savez`` forces them. The reader streams the same way into tensors
on the requested device, each piece read straight into one host buffer
kept for the whole read (page-locked when the tensors lie on a CUDA
device); an entry read whole has its CRC-32 checked as ``zipfile``
checks it. A save goes to a temporary file in the same
directory, ``os.replace``d into place: a crash mid-save never leaves a
torn archive under the final name. A truncated or garbled archive raises
one ``ValueError`` naming the path (the supervisor's restore ladder
relies on it); a missing file stays ``FileNotFoundError``.

``save_train_state`` / ``load_train_state`` round-trip a flat-engine
``TrainState``: the (R, n) view, the optimizer and consensus state, the
overlap snapshot (a ``staleness_k`` ring as the reference's stacked
``(k, R, n)`` entry, written and read slot by slot), and the clock
position. On a mesh (``mesh`` / ``plan`` given) every rank takes part in
gathering the whole state leaf by leaf and rank 0 alone writes it; a
barrier follows, so the file is one, whatever the mesh. A load on a mesh
reads each rank's blocks at their offsets in the file (the entries are
stored uncompressed), so no rank holds the whole state; such block reads
do not check the entries' CRC-32 (a torn archive fails at open, as the
restore ladder needs).
"""
from __future__ import annotations

import dataclasses
import os
import struct
import tempfile
import zipfile
import zlib

import numpy as np
import torch

from repro_torch.core.engine import tree_from_items, tree_items

_SEP = "::"
PIECE_BYTES = 1 << 28

# exception types a truncated / torn / garbled archive surfaces as; the
# reader turns them into one ValueError naming the path
_CORRUPT_ERRORS = (zipfile.BadZipFile, EOFError, OSError, zlib.error,
                   ValueError, KeyError)

_DESCR = {torch.float32: "<f4", torch.float64: "<f8", torch.float16: "<f2",
          torch.bfloat16: "<V2", torch.int32: "<i4", torch.int64: "<i8",
          torch.int16: "<i2", torch.int8: "|i1", torch.uint8: "|u1",
          torch.bool: "|b1"}
_NP_OF = {torch.bfloat16: np.int16}     # bf16 moves as its bits


def _corrupt(path, err):
    return ValueError(
        f"checkpoint {path!r} is truncated or corrupt "
        f"({type(err).__name__}: {err}) — restore from an older copy")


def _key(path):
    return _SEP.join(str(p) for p in path)


def _npz(path):
    return path if path.endswith(".npz") else path + ".npz"


def _as_tensor(v):
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(np.asarray(v))


# ---------------------------------------------------------------------------
# the zip stream
# ---------------------------------------------------------------------------

class _Entry:
    """One ``.npy`` entry: ``parts`` are callables, each returning the next
    slice of the leaf along dim 0 (one part: the whole leaf)."""

    def __init__(self, key, shape, dtype, parts):
        self.key, self.shape, self.dtype = key, tuple(shape), dtype
        self.parts = parts


def _entry(key, t):
    t = _as_tensor(t)
    return _Entry(key, t.shape, t.dtype, [lambda: t])


def _host_pieces(t):
    """``t``'s bytes, in row-major order, as host numpy pieces of at most
    ``PIECE_BYTES``. A CUDA tensor's pieces are copied into one
    page-locked buffer: each piece is valid until the next is asked for."""
    flat = t.detach().reshape(-1)
    if flat.dtype in _NP_OF:
        flat = flat.view(torch.int16)
    step = max(1, PIECE_BYTES // max(1, flat.element_size()))
    buf = torch.empty(min(step, flat.numel()), dtype=flat.dtype,
                      pin_memory=True) if flat.is_cuda else None
    for a in range(0, flat.numel(), step):
        piece = flat[a:a + step]
        if buf is not None:
            piece = buf[:piece.numel()].copy_(piece)
        yield piece.cpu().numpy()


def _write(final, entries, *, writer=True):
    """Stream ``entries`` into ``final`` (crash-safe). Every caller runs
    each part (on a mesh they gather); only the ``writer`` writes."""
    if not writer:
        for e in entries:
            for part in e.parts:
                part()
        return
    d = os.path.dirname(os.path.abspath(final)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(final) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f, zipfile.ZipFile(
                f, "w", compression=zipfile.ZIP_STORED,
                allowZip64=True) as zf:
            for e in entries:
                if e.dtype not in _DESCR:
                    raise ValueError(f"checkpoint leaf {e.key!r}: dtype "
                                     f"{e.dtype} has no npy descr here")
                with zf.open(e.key + ".npy", "w", force_zip64=True) as out:
                    np.lib.format.write_array_header_1_0(out, {
                        "descr": _DESCR[e.dtype], "fortran_order": False,
                        "shape": e.shape})
                    n = 0
                    for part in e.parts:
                        t = part()
                        n += t.numel()
                        for piece in _host_pieces(t):
                            out.write(memoryview(piece).cast("B"))
                        del t   # before the next part is gathered
                    if n != int(np.prod(e.shape, dtype=np.int64)):
                        raise ValueError(f"checkpoint leaf {e.key!r}: parts "
                                         f"hold {n} elements, shape "
                                         f"{e.shape}")
        os.replace(tmp, final)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


class _Reader:
    """An npz archive opened for streaming reads; every failure of a
    damaged archive is the one ``ValueError``."""

    def __init__(self, path):
        self.path = _npz(path)
        try:
            self.zf = zipfile.ZipFile(self.path)
            self.keys = {n[:-4] for n in self.zf.namelist()
                         if n.endswith(".npy")}
        except FileNotFoundError:
            raise
        except _CORRUPT_ERRORS as e:
            raise _corrupt(self.path, e) from e

    def close(self):
        self.zf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _open(self, key):
        try:
            f = self.zf.open(key + ".npy")
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
            else:
                shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
        except _CORRUPT_ERRORS as e:
            raise _corrupt(self.path, e) from e
        if fortran:
            raise ValueError(f"checkpoint {self.path!r}: leaf {key!r} is "
                             "Fortran-ordered")
        return f, tuple(shape), dtype

    def shape(self, key):
        f, shape, _ = self._open(key)
        f.close()
        return shape

    def numpy(self, key):
        """A small entry as a numpy array (``'<V2'`` as int16 bits)."""
        f, shape, dtype = self._open(key)
        try:
            with f:
                if dtype == np.dtype("V2"):
                    dtype = np.dtype("<i2")
                raw = f.read(int(np.prod(shape, dtype=np.int64))
                             * dtype.itemsize)
        except _CORRUPT_ERRORS as e:
            raise _corrupt(self.path, e) from e
        if len(raw) != int(np.prod(shape, dtype=np.int64)) * dtype.itemsize:
            raise _corrupt(self.path, EOFError(f"leaf {key!r} is short"))
        return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()

    def _data(self, key):
        """``(zip info, offset of the entry's first byte in the file,
        offset of the array's first byte, shape, numpy dtype)`` of a
        stored (uncompressed) entry, what ``np.savez`` writes."""
        try:
            info = self.zf.getinfo(key + ".npy")
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"leaf {key!r} is compressed; the "
                                 "reader needs np.savez's stored entries")
            with open(self.path, "rb") as f:
                f.seek(info.header_offset)
                head = f.read(30)
                if len(head) != 30 or head[:4] != b"PK\x03\x04":
                    raise zipfile.BadZipFile(f"leaf {key!r}: no local "
                                             "header")
                name_len, extra_len = struct.unpack("<HH", head[26:30])
                first = info.header_offset + 30 + name_len + extra_len
                f.seek(first)
                version = np.lib.format.read_magic(f)
                if version == (1, 0):
                    shape, fortran, dtype = \
                        np.lib.format.read_array_header_1_0(f)
                else:
                    shape, fortran, dtype = \
                        np.lib.format.read_array_header_2_0(f)
                start = f.tell()
        except _CORRUPT_ERRORS as e:
            raise _corrupt(self.path, e) from e
        if fortran:
            raise ValueError(f"checkpoint {self.path!r}: leaf {key!r} is "
                             "Fortran-ordered")
        return info, first, start, tuple(shape), dtype

    def blocks(self, key, outs, dtype, rows=None, cols=None):
        """Fill ``outs`` with a block of each consecutive slice of the
        entry along dim 0 (one out: the whole entry; k outs: the k slots
        of a ring), read at their offsets: ``rows`` the indices along the
        slice's first dim (None: all), ``cols`` the ``(start, stop)`` of
        its last dim, for a 2-D slice (None: all). Cast to ``dtype``.
        With neither ``rows`` nor ``cols`` the outs (each contiguous, their
        concatenation along dim 0 the entry) take the whole entry in file
        order and its CRC-32 is checked, as ``zipfile`` checks it. Each
        piece of at most ``PIECE_BYTES`` is read straight into one host
        buffer kept for the whole read (page-locked when the outs lie on a
        CUDA device) and copied from there."""
        info, first, start, shape, ndt = self._data(key)
        tdt = torch.bfloat16 if ndt == np.dtype("V2") else \
            torch.from_numpy(np.empty(0, dtype=ndt)).dtype
        whole = rows is None and cols is None
        if whole:
            outs = [o.view(1, -1) for o in outs]
            a, b, rows, (c0, c1) = 1, None, range(1), (0, None)
        else:
            # a ring's entry has a leading slot dim its slots do not have
            sub = shape[1:] if len(shape) > outs[0].dim() else shape
            a = sub[0]
            b = int(np.prod(sub[1:], dtype=np.int64))
            c0, c1 = cols if cols is not None else (0, b)
            rows = range(a) if rows is None else rows
        longest = max([o.shape[1] for o in outs] if whole else [c1 - c0])
        step = max(1, min(PIECE_BYTES // ndt.itemsize, longest))
        pinned = any(o.is_cuda for o in outs) and torch.cuda.is_available()
        buf = torch.empty(step * ndt.itemsize, dtype=torch.uint8,
                          pin_memory=pinned)
        mv = memoryview(buf.numpy())
        done = 0
        try:
            with open(self.path, "rb", buffering=0) as f:
                crc = None
                if whole:
                    f.seek(first)
                    crc = zlib.crc32(_read_full(f, start - first))
                    pos = start
                for i, out in enumerate(outs):
                    dst = out.view(len(rows), -1)
                    end = dst.shape[1] if whole else c1
                    for j, r in enumerate(rows):
                        if not whole:
                            pos = start + ((i * a + r) * b + c0) \
                                * ndt.itemsize
                        for c in range(c0, end, step):
                            cnt = min(step, end - c)
                            nb = cnt * ndt.itemsize
                            f.seek(pos)
                            if _read_into(f, mv[:nb]) != nb:
                                raise EOFError(f"leaf {key!r} is short")
                            pos += nb
                            if crc is not None:
                                crc = zlib.crc32(mv[:nb], crc)
                            dst[j, c - c0:c - c0 + cnt].copy_(
                                buf[:nb].view(tdt).to(dtype))
                            done += nb
            if whole and (crc != info.CRC
                          or start - first + done != info.file_size):
                raise zipfile.BadZipFile(f"Bad CRC-32 for file "
                                         f"{key + '.npy'!r}")
        except _CORRUPT_ERRORS as e:
            raise _corrupt(self.path, e) from e


def _read_full(f, n):
    """``n`` bytes from the unbuffered file ``f`` (fewer only at its end)."""
    out = bytearray(n)
    return bytes(out[:_read_into(f, memoryview(out))])


def _read_into(f, mv):
    """Fill ``mv`` from the unbuffered file ``f``; the bytes read (fewer
    than ``len(mv)`` only at the file's end)."""
    got = 0
    while got < len(mv):
        n = f.readinto(mv[got:])
        if not n:
            break
        got += n
    return got


def _check_shape(path, key, got, want):
    if tuple(got) != tuple(want):
        # ValueError, not assert: restore is a user-facing path and the
        # shape check must survive python -O
        raise ValueError(f"checkpoint leaf {key!r} has shape {tuple(got)}, "
                         f"template expects {tuple(want)}")


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def save_pytree(path, tree, extra=None):
    """Crash-safe save of a tree of tensors (bf16 leaves as ``'<V2'``)
    with ``extra`` scalars under ``__extra__::<name>``."""
    entries = [_entry(_key(p), leaf) for p, leaf in tree_items(tree)]
    for k, v in (extra or {}).items():
        entries.append(_entry(f"__extra__{_SEP}{k}", v))
    _write(_npz(path), entries)


def _device_of(leaf, device):
    if device is not None:
        return torch.device(device)
    return torch.device("cpu") if leaf.is_meta else leaf.device


def load_pytree(path, like, *, device=None):
    """Restore into the structure of ``like`` (a tree of tensors, meta
    tensors allowed: only shapes and dtypes are read). Leaves land on
    ``device`` (default: each template leaf's, the CPU for a meta one) in
    the template's dtype. Returns ``(tree, extra)``, ``extra`` a dict of
    numpy arrays."""
    with _Reader(path) as rd:
        out = []
        for p, leaf in tree_items(like):
            key = _key(p)
            if key not in rd.keys:
                raise ValueError(
                    f"checkpoint {rd.path!r} has no leaf {key!r} (template "
                    "mismatch or truncated archive)")
            _check_shape(rd.path, key, rd.shape(key), leaf.shape)
            t = torch.empty(tuple(leaf.shape), dtype=leaf.dtype,
                            device=_device_of(leaf, device))
            rd.blocks(key, [t], leaf.dtype)
            out.append((p, t))
        extra = {k.split(_SEP, 1)[1]: rd.numpy(k) for k in sorted(rd.keys)
                 if k.startswith("__extra__")}
    return tree_from_items(out), extra


# ---------------------------------------------------------------------------
# train states
# ---------------------------------------------------------------------------

def _state_tree(state):
    tree = {"params": state.params, "opt": state.opt, "cstate": state.cstate}
    if state.snap is not None:
        tree["snap"] = state.snap
    return tree


def _items(tree):
    """``tree_items`` that keeps a snapshot ring (a list) as one leaf."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(((k,) + p, leaf) for p, leaf in _items(v))
        elif isinstance(v, (list, torch.Tensor)):
            out.append(((k,), v))
        else:
            out.extend(((k,) + p, leaf) for p, leaf in tree_items(v))
    return out


def _state_entries(state):
    entries = []
    for p, leaf in _items(_state_tree(state)):
        if isinstance(leaf, list):      # the ring, stacked slot by slot
            entries.append(_Entry(_key(p), (len(leaf),) + tuple(
                leaf[0].shape), leaf[0].dtype,
                [lambda s=s: s for s in leaf]))
        else:
            entries.append(_entry(_key(p), leaf))
    return entries


def save_train_state(path, state, *, mesh=None, plan=None):
    """Full ``TrainState`` -> npz: the flat (R, n) view (or stacked tree),
    optimizer and consensus state, the overlap snapshot (a staleness_k
    ring as the stacked (k, R, n) entry) and the clock position (step and
    round counters). On a mesh the state is this rank's shard: every rank
    gathers each leaf in turn, rank 0 writes, and all wait for the file.
    The engine is not saved: the resume path rebuilds it from the same
    config."""
    extra = [_entry(f"__extra__{_SEP}t", np.asarray(state.t, np.int32))]
    if state.round is not None:
        extra.append(_entry(f"__extra__{_SEP}round",
                            np.asarray(state.round, np.int32)))
    writer = True
    if mesh is None:
        entries = _state_entries(state)
    else:
        from repro_torch.train.trainer import whole_leaves
        entries = [_Entry(k, shape, dt, parts) for k, shape, dt, parts, *_
                   in whole_leaves(state, mesh, plan)]
        writer = mesh.rank == 0
    _write(_npz(path), entries + extra, writer=writer)
    if mesh is not None and torch.distributed.is_initialized():
        torch.distributed.barrier()


def _default_snap(key, leaf):
    """A snapshot entry's init value (``trainer._init_snap``) where the
    template holds only its shape."""
    if not leaf.is_meta:
        return leaf.clone()
    fill = 1 if key in ("gns", "act", "active", "sync") else 0
    return torch.full(tuple(leaf.shape), fill, dtype=leaf.dtype)


def load_train_state(path, like, *, clock=None, device=None,
                     in_place=False, mesh=None, plan=None):
    """Restore a ``save_train_state`` checkpoint into the structure of
    ``like``, a ``TrainState`` of the same config whose engine is kept;
    its tensors may be meta tensors (only shapes and dtypes are read).
    Tensors land on ``device`` (default: the template's, the CPU for meta
    ones); with ``in_place`` a real template tensor of the right shape and
    dtype is filled in place instead of a new one (a resume into a fresh
    state needs no second copy of it). With ``mesh`` / ``plan``, ``like``
    is this rank's shard (``shard_train_state``, or ``state_template`` of
    one) and each rank reads only its blocks of each leaf, at their
    offsets in the file: ``shard_train_state`` of the whole restored
    state, without the whole state on any rank. The file is the same
    whatever mesh wrote it.

    A checkpoint without a snapshot (an exact-mode run) resumes into an
    overlap run with the restored params as its warm-start snapshot,
    every slot of a staleness_k ring taking them. An elastic checkpoint
    written before the quorum gate has no ``snap::sync``: the gate is
    backfilled at 1. The clock position restores from the ``round``
    extra; a checkpoint that carries only ``t`` takes its round from
    ``clock.round_of_step`` when a clock is given, else ``round`` is None
    (the round builders then use ``t // tau``). Returns the resumed
    ``TrainState``."""
    blocks = {}
    if mesh is not None:
        from repro_torch.train.trainer import whole_leaves
        blocks = {k: (shape, rows, cols) for k, shape, _, _, _, rows, cols
                  in whole_leaves(like, mesh, plan)}
    with _Reader(path) as rd:
        keys = rd.keys
        if f"__extra__{_SEP}t" not in keys:
            raise ValueError(
                f"{path} is not a train-state checkpoint (no step counter) "
                "— final-params checkpoints (save_pytree) are a different "
                "format")
        template = _state_tree(like)
        missing_snap = "snap" in template and not any(
            k.startswith(f"snap{_SEP}") for k in keys)
        if missing_snap:
            del template["snap"]
        fill_sync = (not missing_snap and "snap" in template
                     and "sync" in template["snap"]
                     and f"snap{_SEP}sync" not in keys)
        if fill_sync:
            template["snap"] = {k: v for k, v in template["snap"].items()
                                if k != "sync"}

        def targets_of(leaf, dev):
            out = []
            for t in (leaf if isinstance(leaf, list) else [leaf]):
                if in_place and not t.is_meta and t.device == dev \
                        and t.is_contiguous():
                    out.append(t)
                else:
                    out.append(torch.empty(tuple(t.shape), dtype=t.dtype,
                                           device=dev))
            return out

        out = []
        for p, leaf in _items(template):
            key = _key(p)
            if key not in keys:
                raise ValueError(
                    f"checkpoint {rd.path!r} has no leaf {key!r} (template "
                    "mismatch or truncated archive)")
            ring = isinstance(leaf, list)
            first = leaf[0] if ring else leaf
            whole, rows, cols = blocks.get(key, (None, None, None))
            want = whole if whole is not None else \
                ((len(leaf),) if ring else ()) + tuple(first.shape)
            _check_shape(rd.path, key, rd.shape(key), want)
            targets = targets_of(leaf, _device_of(first, device))
            rd.blocks(key, targets, first.dtype, rows, cols)
            out.append((p, targets if ring else targets[0]))
        tree = tree_from_items(out)
        if missing_snap:
            # the warm start: every slot takes the restored view (on a
            # mesh, its column block of every row)
            x = like.snap["x"]
            slots = x if isinstance(x, list) else [x]
            dev = tree["params"].device
            slots = targets_of(slots, dev)
            _, _, cols = blocks.get("snap::x", (None, None, None))
            if mesh is None:
                slots[0].copy_(tree["params"])
            else:
                rd.blocks("params", slots[:1], slots[0].dtype, None, cols)
            for s in slots[1:]:
                s.copy_(slots[0])
        extra = {k.split(_SEP, 1)[1]: rd.numpy(k) for k in sorted(keys)
                 if k.startswith("__extra__")}
    snap = tree.get("snap", like.snap)
    if fill_sync:
        dev = tree["snap"]["act"].device
        snap = dict(tree["snap"], sync=torch.ones((), dtype=torch.float32,
                                                  device=dev))
    if missing_snap:
        snap = {k: _default_snap(k, v).to(dev)
                for k, v in like.snap.items() if k != "x"}
        snap["x"] = slots if isinstance(like.snap["x"], list) else slots[0]
    if "round" in extra:
        rnd = int(extra["round"])
    elif clock is not None:
        rnd = clock.round_of_step(int(extra["t"]))
    else:
        rnd = None
    return dataclasses.replace(
        like, params=tree["params"], opt=tree["opt"],
        cstate=tree.get("cstate", {}), snap=snap, round=rnd,
        t=int(extra["t"]))

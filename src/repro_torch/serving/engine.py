"""Serving engine: continuous batching over the position-tagged KV / ring
cache, plus the one-shot ``generate`` entry point (counterpart of
``repro/serving/engine.py``).

Two layers:

* ``generate`` — prefill, then decode a fixed batch. Prompts longer than
  ``buf_len`` stream through the ring buffer in fixed-size chunks via
  ``ModelAPI.make_state`` / ``prefill_chunk`` (window mode only: without a
  sliding window a ring overwrite would silently truncate the prompt). A
  vlm prefix occupies the first positions, so decoding starts at ``S +
  P``; an enc-dec model's frames take no cache position.

* ``SlotEngine`` — the continuous-batching core. A fixed ``(max_slots,)``
  slot table whose per-slot index / generated-token counter / key / budget
  / active lanes live beside the model states of all slots (KV caches,
  Mamba ssm / conv states, xLSTM states; any nested tree). Admission =
  blank request state + chunked prefill of every full chunk + a copy into
  the slot's row; the prompt tail (1..chunk tokens) is fed through the
  decode step itself, so the first kept token comes out of the same step
  (per-slot ``decode_key`` contract); eviction is the budget check flipping
  the active lane. The host ``Scheduler`` (``serving/scheduler.py``) packs
  requests into slots. A request's state is made from its own batch
  (its encoder frames or prefix); ``example`` (required for an enc-dec
  model) gives the blank slot states their shapes.

The decode step (``slot_step``) is one ``decode_step`` over all
``max_slots`` rows, as the reference's vmap over slots: each row at its
own position, with its own ``pos`` tags, band, MoE routing group and
sampling key; inactive rows' states come out unchanged. Its shapes do not
depend on which slots are active, and its only read-back is the sampled
tokens. ``slot_step_loop``, one ``decode_step`` per active slot, is its
plain version, which the tests and the card check hold it against.

PyTorch runs eagerly, so there is no compile to count: each lane
(``fresh``, ``chunk``, ``decode``, ``insert``) and generate's decode loop
instead count the distinct input-shape signatures they have seen
(``compile_cache_sizes``, ``decode_loop_cache_size``), and the reference's
pin carries over: one signature per lane across admissions and evictions.
The model's states are updated in place. ``make_serve_step`` builds the
single-token decode function; ``window`` selects the sliding-window
(ring-buffer) variant.

A model split over a ``model`` group (``build_model(cfg, mesh, plan)``)
serves through ``generate`` and ``make_serve_step`` as it is: every rank
calls them with its shard, the lanes gather the logits, and every rank
samples the same tokens from the same keys. The slot engine does not
take such a model yet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import tree_at, tree_from_items, tree_items
from repro_torch.models.registry import ModelAPI, state_batch_axes
from repro_torch.serving.sampling import (
    GREEDY, SamplingParams, fold_in, fold_in_array, sample_batch,
    sample_token,
)


def make_serve_step(model: ModelAPI, window: int = 0):
    """decode one token: (params, states, token (B,1), index) -> (logits,
    states)."""
    def serve_step(params, states, token, index):
        return model.decode_step(params, states, token, index, window=window)
    return serve_step


def decode_key(key: int, i: int) -> int:
    """Sampling key for generated token ``i``: token 0 consumes the
    caller's key directly, tokens ``i >= 1`` fold the token index in."""
    if i == 0:
        return key
    return fold_in(key, i)


def default_chunk(buf_len: int) -> int:
    """Streaming-prefill chunk size when the caller does not pick one."""
    return min(buf_len, 128)


def _resolve_sampling(greedy, sampling):
    if sampling is not None:
        return sampling
    # greedy=False with no explicit params: temperature 1, no truncation
    return GREEDY if greedy else SamplingParams()


def _signature(x):
    """Shapes, dtypes and devices of the tensors / arrays in ``x`` and the
    types of its scalars: what a jit cache would key on."""
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), str(x.dtype), x.device.type)
    if isinstance(x, np.ndarray):
        return ("array", x.shape, x.dtype.str)
    if isinstance(x, dict):
        return tuple(sorted((k, _signature(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_signature(v) for v in x)
    return type(x).__name__


class _Lane:
    """A serving lane: calls ``fn`` and records the signature of its
    arguments after the parameters."""

    def __init__(self, fn):
        self.fn = fn
        self.signatures = set()

    def __call__(self, params, *args):
        self.signatures.add(_signature(args))
        return self.fn(params, *args)

    def cache_size(self) -> int:
        return len(self.signatures)


_DECODE_LOOPS = {}


def _decode_loop(model: ModelAPI, max_new_tokens: int, window: int,
                 sp: SamplingParams):
    """generate's decode loop for one (model, length, window, sampling);
    the prompt's start index is an argument, so prompts of another length
    share its signature."""
    ck = (model, max_new_tokens, window, sp)
    if ck not in _DECODE_LOOPS:
        def loop(params, states, logits0, k0, start):
            # one key per step for the whole batch (the reference's
            # contract); the slot engine keys each slot on its own
            tok = sample_token(logits0, decode_key(k0, 0), sp)
            toks = [tok]
            for i in range(1, max_new_tokens):
                # token i-1 sits at absolute position start + i - 1
                lg, states = model.decode_step(params, states, tok[:, None],
                                               start + i - 1, window=window)
                tok = sample_token(lg, decode_key(k0, i), sp)
                toks.append(tok)
            return torch.stack(toks, dim=1), states
        _DECODE_LOOPS[ck] = _Lane(loop)
    return _DECODE_LOOPS[ck]


def decode_loop_cache_size(model: ModelAPI, max_new_tokens: int, window: int,
                           sp: SamplingParams = GREEDY) -> int:
    """Distinct input signatures of generate's decode loop for this config
    (two generate calls of identical shape leave it at 1)."""
    return _decode_loop(model, max_new_tokens, window, sp).cache_size()


def _ring_check_chunk(buf_len, window, chunk):
    """Ring-streaming contract: a C-token chunk write overwrites C slots,
    and the chunk's earliest query still needs window-1 of history, so
    exact chunked streaming needs buf_len >= window + chunk - 1 (per-token
    decode is the chunk == 1 corner). Validated, not silently truncated."""
    if not 1 <= chunk <= buf_len:
        raise ValueError(
            f"chunk must be in [1, buf_len={buf_len}], got {chunk}")
    if window and chunk > buf_len - window + 1:
        raise ValueError(
            f"chunk {chunk} with window {window} needs buf_len >= "
            f"{window + chunk - 1} (got {buf_len}): a chunk write would "
            f"clobber ring slots its own queries still attend to")


def _ring_default_chunk(buf_len, window):
    if window:
        return max(1, min(default_chunk(buf_len), buf_len - window + 1))
    return default_chunk(buf_len)


def _stream_prefill(model, params, batch, buf_len, window, chunk):
    """Chunked prefill for prompts longer than buf_len: every chunk goes
    through ``prefill_chunk`` (ring writes wrap). Returns (last logits,
    states)."""
    tokens = batch["tokens"]
    _ring_check_chunk(buf_len, window, chunk)
    states, start = model.make_state(params, batch, buf_len, window=window)
    S = tokens.shape[1]
    idx, logits = start, None
    for j in range(0, S, chunk):
        logits, states = model.prefill_chunk(
            params, states, tokens[:, j:j + chunk], idx, window=window)
        idx += min(chunk, S - j)
    return logits, states


def generate(model: ModelAPI, params, batch, *, max_new_tokens: int,
             buf_len: int, window: int = 0, greedy: bool = True, key=None,
             sampling: SamplingParams | None = None, chunk: int = 0):
    """Prefill the prompt, then decode ``max_new_tokens`` greedily (or
    sampled). ``sampling`` overrides ``greedy``. Prompts longer than
    ``buf_len`` stream chunk-wise through the ring buffer (requires
    ``window > 0``). ``key`` is an int seed (default 0). Returns (tokens
    (B, max_new_tokens) int64 on the parameters' device, final prefill
    logits)."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if window > buf_len:
        raise ValueError(
            f"buf_len {buf_len} smaller than window {window}: the ring "
            f"buffer must hold at least one full attention window")
    sp = _resolve_sampling(greedy, sampling)
    S = batch["tokens"].shape[1]
    # a vlm prefix takes the cache's first positions; encoder frames none
    extra = batch["prefix"].shape[1] if "prefix" in batch else 0
    if extra + S <= buf_len:
        logits, states = model.prefill(params, batch, buf_len, window=window)
    else:
        if window <= 0:
            raise ValueError(
                f"prompt of {S} tokens (+{extra} prefix) exceeds buf_len "
                f"{buf_len} without a sliding window: ring overwrite would "
                f"silently truncate the prompt — pass window > 0 or grow "
                f"buf_len")
        logits, states = _stream_prefill(
            model, params, batch, buf_len, window,
            chunk or _ring_default_chunk(buf_len, window))
    k0 = key if key is not None else 0
    out, _ = _decode_loop(model, max_new_tokens, window, sp)(
        params, states, logits, k0, S + extra)
    return out, logits


# ---------------------------------------------------------------------------
# Continuous batching
# ---------------------------------------------------------------------------

def decode_keys(keys, gen):
    """The ``decode_key`` contract over the slot lanes: each slot's key
    for generated token ``max(gen, 0)``, as a (max_slots,) int64 array
    computed on the host from the host lanes."""
    i = np.maximum(np.asarray(gen, np.int64), 0)
    keys = np.asarray(keys, np.int64)
    return np.where(i == 0, keys, fold_in_array(keys, i))


def _advance(slots):
    """Every active slot's index and generated-token counter move on by
    one; a slot whose budget is spent turns inactive."""
    act = slots["active"]
    gen_after = slots["gen"] + 1
    slots["index"] = torch.where(act, slots["index"] + 1, slots["index"])
    slots["gen"] = torch.where(act, gen_after, slots["gen"])
    slots["active"] = act & (gen_after < slots["budget"])


def slot_step(model: ModelAPI, params, slots, toks, window: int,
              sp: SamplingParams):
    """One decode step of the slot table: ONE ``decode_step`` over all
    ``max_slots`` rows (``slots["rows"]``), each at its own index, the
    inactive rows frozen; one sampled token a row under its own key.
    ``toks``: (max_slots,) tokens fed. The per-row tokens, indices and
    active flags cross to the device in one copy; the sampled tokens are
    the one read-back. Returns (sampled (max_slots,) np.int64, 0 for
    inactive slots; logits (max_slots, V) fp32); the slot table is
    updated in place."""
    lanes = torch.stack([torch.as_tensor(toks, dtype=torch.int64),
                         slots["index"], slots["active"].long()])
    tok, index, act = lanes.to(params["embed"].device)
    act = act.bool()
    logits, _ = model.decode_step(params, slots["rows"], tok[:, None], index,
                                  window=window, active=act)
    picked = sample_batch(logits, decode_keys(slots["key"], slots["gen"]),
                          sp)
    nxt = torch.where(act, picked, torch.zeros_like(picked)).cpu().numpy()
    _advance(slots)
    return nxt, logits


def slot_step_loop(model: ModelAPI, params, slots, toks, window: int,
                   sp: SamplingParams):
    """The plain version of ``slot_step``: one ``decode_step`` and one
    ``sample_token`` per active slot, on the slot's own state (its views
    ``slots["model"]``) at its own index. Same returns (an inactive
    slot's logits row 0; None when no slot is active)."""
    act = slots["active"]
    nxt = np.zeros((act.shape[0],), np.int64)
    logits = None
    for s in torch.nonzero(act).flatten().tolist():
        lg, _ = model.decode_step(
            params, tree_at(slots["model"], s),
            torch.as_tensor(toks[s:s + 1])[None], int(slots["index"][s]),
            window=window)
        if logits is None:
            logits = lg.new_zeros((act.shape[0], lg.shape[-1]))
        logits[s] = lg[0]
        i = max(int(slots["gen"][s]), 0)
        nxt[s] = int(sample_token(lg[0].to(torch.float32),
                                  decode_key(int(slots["key"][s]), i), sp))
    _advance(slots)
    return nxt, logits


def _slot_layout(blank, axes, n):
    """The slot table's model states made from a blank request state: each
    leaf with its batch axis widened to ``n`` rows (a ``pos`` tag, shared
    by a request's batch, gains a row axis before its buffer axis), and
    the per-slot views of the same storage, ``leaf[s]`` slot s's state in
    the request's layout. Returns (rows, views)."""
    rows, views = [], []
    for path, leaf in tree_items(blank):
        ax = axes[path]
        if ax is None:
            ax = leaf.dim() - 1
            leaf = leaf.unsqueeze(ax)
        shape = list(leaf.shape)
        shape[ax] = n
        big = leaf.expand(shape).clone(memory_format=torch.contiguous_format)
        view = big.movedim(ax, 0)
        rows.append((path, big))
        views.append((path, view if axes[path] is None
                      else view.unsqueeze(ax + 1)))
    return tree_from_items(rows), tree_from_items(views)


class SlotEngine:
    """Lanes for slot-based continuous batching.

    The slot table is ``{"rows": <model states with batch max_slots and
    per-row pos tags>, "model": <the same storage viewed per slot, leaf[s]
    slot s's state in the request layout>, "index", "gen", "budget",
    "key", "active"}``; the scalar lanes are int64 / bool CPU tensors (the
    host drives the loop), the model states live on the parameters'
    device. One decode step (``slot_step``) runs ``ModelAPI.decode_step``
    once over all rows, each at its own index, samples each row under the
    ``decode_key`` contract on its generated-token counter, and flips
    ``active`` off the moment a slot's budget is exhausted.

    ``gen`` is the generated-token index of the NEXT sample; it starts at
    ``-(tail_len - 1)`` so the step that consumes the last prompt-tail
    token lands on ``gen == 0`` (first kept sample, keyed by the request
    key itself). Samples drawn while ``gen < 0`` are prompt-feeding
    by-products and are discarded by the host scheduler.
    """

    def __init__(self, model: ModelAPI, params, *, max_slots: int,
                 buf_len: int, window: int = 0, chunk: int = 0,
                 sampling: SamplingParams = GREEDY, example=None):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if model.tp is not None:
            raise NotImplementedError(
                "the slot engine over a model group is not ported: serve a "
                "tensor-parallel model with generate")
        if buf_len < 1:
            raise ValueError(f"buf_len must be >= 1, got {buf_len}")
        if window < 0:
            raise ValueError(f"window must be >= 0, got {window}")
        if window > buf_len:
            raise ValueError(
                f"buf_len {buf_len} smaller than window {window}: the ring "
                f"buffer must hold at least one full attention window")
        # a request's prompt tail (up to `chunk` tokens) rides the
        # per-token decode lane, so huge chunks trade prefill efficiency
        # for tail latency
        chunk = chunk or min(32, _ring_default_chunk(buf_len, window))
        _ring_check_chunk(buf_len, window, chunk)
        self.model = model
        self.params = params
        self.max_slots = max_slots
        self.buf_len = buf_len
        self.window = window
        self.chunk = chunk
        self.sampling = sampling
        # a one-sequence batch the blank slot states are made from: an
        # enc-dec model's carries the encoder frames' shape
        if example is None:
            if model.cfg.n_enc_layers:
                raise ValueError(
                    "enc-dec serving needs an example batch carrying the "
                    "encoder-frame shape (example={'tokens': ..., "
                    "'enc': ...})")
            example = {"tokens": np.zeros((1, 1), np.int32)}
        self.example = example
        self.device = params["embed"].device

        # the lanes' closures hold no reference to self: an engine (and the
        # parameters it holds) is freed as soon as its last user drops it
        w, sp = window, sampling

        def fresh(params, batch):
            return model.make_state(params, batch, buf_len, window=w)

        def chunk_step(params, state, toks, idx):
            return model.prefill_chunk(params, state, toks, idx, window=w)

        def step(params, slots, toks):
            return slot_step(model, params, slots, toks, w, sp)[0], slots

        def insert(slots, mstate, slot, idx0, gen0, budget, key):
            # the whole state: a reset leaves zero SSM / conv states too
            new = dict(tree_items(mstate))
            for path, leaf in tree_items(slots["model"]):
                leaf[slot].copy_(new[path])
            slots["index"][slot] = idx0
            slots["gen"][slot] = gen0
            slots["budget"][slot] = budget
            slots["key"][slot] = key
            slots["active"][slot] = True
            return slots

        self._fresh = _Lane(fresh)
        self._chunk = _Lane(chunk_step)
        self._decode = _Lane(step)
        self._insert = _Lane(insert)
        self._blank, start0 = self._fresh(self.params, self.example)
        self.start0 = int(start0)
        self._axes = state_batch_axes(model.cfg)

    # -- host API ----------------------------------------------------------

    def blank_slots(self):
        """Fresh all-inactive slot table (max_slots rows of blanks)."""
        S = self.max_slots
        lane = lambda v: torch.full((S,), v, dtype=torch.int64)
        rows, views = _slot_layout(self._blank, self._axes, S)
        return {
            "rows": rows, "model": views,
            "index": lane(0), "gen": lane(0), "budget": lane(1),
            "key": lane(0),
            "active": torch.zeros((S,), dtype=torch.bool),
        }

    def request_state(self, batch):
        """Blank per-request (B=1) state. Returns (state, start index of
        the first prompt token)."""
        state, start = self._fresh(self.params, batch)
        return state, int(start)

    def prefill_chunks(self, state, tokens, start):
        """Stream all FULL chunks of a request's prompt through the chunk
        lane; the remaining 1..chunk tail tokens are returned for the host
        to feed through the decode step (the step consuming the last tail
        token yields generated token 0). Returns (state, index of the
        first tail token, tail list)."""
        tokens = np.asarray(tokens).reshape(-1)
        if tokens.size < 1:
            raise ValueError("empty prompt")
        n_full = (tokens.size - 1) // self.chunk
        idx = start
        for j in range(n_full):
            _, state = self._chunk(
                self.params, state,
                tokens[None, j * self.chunk:(j + 1) * self.chunk].astype(
                    np.int64), idx)
            idx += self.chunk
        return state, idx, [int(t) for t in tokens[n_full * self.chunk:]]

    def insert(self, slots, state, slot, idx0, gen0, budget, key):
        """Admit a prefilled request into a slot (an in-place write of the
        model state and all lanes). ``key`` is the request's int seed."""
        if not 0 <= slot < self.max_slots:
            raise ValueError(
                f"slot {slot} out of range for max_slots {self.max_slots}")
        if budget < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {budget}")
        return self._insert(slots, state, int(slot), int(idx0), int(gen0),
                            int(budget), int(key))

    def decode(self, slots, toks):
        """One continuous-batching decode step over all slots. ``toks``:
        (max_slots,) tokens being fed (prompt tail or previous sample; junk
        for inactive slots). Returns (sampled (max_slots,) np.int64, 0 for
        inactive slots; the slot table)."""
        return self._decode(self.params, slots, np.asarray(toks, np.int64))

    @staticmethod
    def slot_state(slots, s):
        """Slot ``s``'s model state in the per-request layout (views into
        the table), as ``make_state`` gives a one-sequence request."""
        return tree_at(slots["model"], s)

    def compile_cache_sizes(self):
        """Distinct input signatures per lane: the no-retrace test pins
        these at 1 across admissions and evictions."""
        return {"fresh": self._fresh.cache_size(),
                "chunk": self._chunk.cache_size(),
                "decode": self._decode.cache_size(),
                "insert": self._insert.cache_size()}

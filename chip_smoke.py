#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. Card: requires CUDA, prints ``nvidia-smi``'s name and power limit,
   builds the four CUDA sources (``src/repro_torch/kernels/{pullpush,
   swa_attention,mamba_scan,slstm_step}/csrc``, as ``kernels/_build.py``
   lists them), one ``nvcc`` each, all at once.
2. Kernels: every kernel of the DPPF round against its plain PyTorch
   version at (4, 300), (8, 4097), (5, 2^26 + 3), (32, 65537) and at the
   main path's shape R = 4, n = 1,216,385,024 (yi-6b at LAYERS = 4); then
   times kernel, plain version and the nearest PyTorch call at the main
   shape (CUDA events, median of 20 runs after 3 warm-ups).
3. The slice: yi-6b at full width (d_model 4096, 32/4 heads, d_ff 11008,
   vocab 64000), depth cut to 4 layers, bf16 model over the fp32 flat
   master view; M = 4 workers, simple_avg, alpha 0.1, lam 0.5, tau 4,
   16 steps, seq 64, batch 8 per worker, SGD (momentum 0.9, wd 1e-3).
   Launch counters are zeroed just before and read just after.
4. The launcher: ``repro_torch.launch.train.main`` (``--smoke``) on the
   card, on the flat engine and with ``--engine tree``.
5. Attention kernel: ``swa_attention`` against its plain version in fp32
   (the CUDA-core kernel) and bf16 (the tensor-core kernel) on the six
   cases of ``tests/test_kernels.py``, a ragged non-causal case, an
   ``Sq > Skv`` case, an hd = 112 case, a small hd = 256 case (B = 2, 8
   heads over 4, S = 333, window 96, cap 50) and the serving shapes
   (B = 4, H = 8 over 4 kv heads, S = 8160, hd = 256: local window 4096
   with cap 50, global with cap 50, and cap 0 / window 0 where one
   PyTorch call, ``scaled_dot_product_attention``, computes the same
   function; zamba2-7b's B = 4, 32 heads over 32, S = 8160, hd = 112,
   cap 0 / window 0); times kernel, plain version and that call (CUDA
   events, median of 20 after 3 warm-ups). Each query row is held to 2e-5
   (fp32) or 2e-2 (bf16) of its own largest |output|; bf16 both in the
   (B, H, S, hd) layout and as the transposed (B, S, H, hd) view the model
   hands the kernel (timed too). For each bf16 serving shape it prints
   TFLOP/s, the share of the bound and the ratio to that call; for every
   kernel instance the registers and spills (ptxas) and, from
   ``cuobjdump -sass``, the highest register and the count of ``HGMMA``
   (``wgmma``) instructions, which must be nonzero in every bf16 instance.
6. Serving gemma2-2b at full width and full depth (26 layers, bf16,
   random weights from a seeded generator): (0) the kernel route of the
   prefill against the ``attend`` path at full width, 2 layers, fp32;
   (a) ``generate`` on 4 prompts of 8160 tokens, greedy, 32 new tokens,
   buf_len 8192 — the main path, launch counters zeroed just before and
   read just after — then the same call traced with ``torch.profiler``
   (8 new tokens: device busy time, idle share, the longest kernels, the
   share of the traced prefill taken by the ``swa*`` kernels);
   (b) one prompt through ``make_state`` +
   ``prefill_chunk`` in chunks of 512; (c) the continuous-batching
   launcher ``repro_torch.launch.serve.main`` at full size.
7. SSD kernel: ptxas's registers and spills and a ``cuobjdump -sass``
   census of every ``ssd_kernel`` instance (highest register, HMMA and
   HGMMA counts: the phase fails unless each instance runs its products
   on the tensor cores) and the launch geometry at the three timed
   shapes; ``ssd_chunks`` against its plain version (fp32, TF32 off) on
   the three cases of ``tests/test_kernels.py``, then in the model's
   layout a ragged sequence (S = 70 in chunks of 32) and the serving
   shape (B = 4, S = 8160 -> 64 chunks of 128 with a 96-token last one,
   H = 112, P = N = 64, B_ / C_ as strided column slices, decay spanning
   A = 1..8), launched twice there (the two results must be bit-equal);
   then a 512-token chunk of the chunked prefill (1, 512, 112) and the
   launcher's 64-token chunk (1, 64, 112). Every output held to 1e-4 of
   its scale. Times kernel and plain version at the three shapes (CUDA
   events, median of 20 after 3 warm-ups) beside the bound of the
   kernel's route (bytes, or 3xTF32 operations over the TF32 peak), with
   the fp32 CUDA-core bound kept beside it. No single PyTorch call
   computes this function.
8. Serving zamba2-7b at full width and full depth (81 layers: 68 Mamba2
   blocks and 13 occurrences of one shared attention + MLP block, bf16,
   5,737,416,000 random parameters from a seeded generator): (0) one
   Mamba2 block's kernel route against the plain ``_ssd_chunked`` route
   at full width, fp32, S = 1024, with non-zero carried-in states;
   (a) ``generate`` on 4 prompts of 8160 tokens, greedy, 32 new tokens,
   buf_len 8192 (counters zeroed just before and read just after: 68
   ``ssd_chunks`` and 13 ``swa_attention`` launches), then the same call
   traced (8 new tokens) with CUDA events around each SSD scan and its
   kernel, and the share of the traced prefill taken by the ``swa*``
   kernels; (b) one prompt in chunks of 512 (carried ssm and conv states);
   (c) the serving launcher: 5 requests of 256 / 512 / 1024 / 256 / 512
   tokens, 4 slots, chunk 64, 16 new tokens.
9. sLSTM kernel: its launch geometry at every head dim (blocks per
   cluster, batch group, rows of R in registers and in shared memory,
   shared bytes) with ``cudaOccupancyMaxActiveClusters``' count, and
   ptxas's registers and spills (the P = 512 instance must not spill).
   ``slstm_steps`` against its plain version on the four cases of
   ``tests/test_kernels.py``, a carried state, T = 1, the reduced config's
   P = 128; then the serving shape (B = 4, T = 4096, H = 4, P = 512) on
   the model's own gates, launched twice (the two results must be
   bit-equal): g_in = xi @ w_gates + b_gates of a
   real xlstm-350m sLSTM block (its seeded init, bf16) on a random
   prompt, reshaped head-major as the model does, so the forget bias of 3
   lands on every gate of head 2 and on no gate of heads 0, 1, 3. Error
   per head beside that head's plain fp32-vs-fp64 drift: a head is held
   to 1e-4 of its scale, or, where its own fp32 arithmetic drifts further
   over 4096 chaotic steps, to twice that drift. The same gates over
   their first 512 steps (a strided view), before chaos amplifies
   rounding: every head held to 1e-4. Then the serving shape with a
   forget bias of 3 on every head (not the model's layout), held to 1e-4.
   Then xlstm-350m's 512-token chunk (1, 512, 4, 512) and a B
   above one batch group (9, 64, 4, 512), after the serving shape so that
   its draws are those of the cases before it. Times kernel (median of 20
   after 3 warm-ups) and plain version (median of 3) on the model's
   gates; then the kernel at the
   serving, chunk and decode (4, 1, 4, 512) shapes, in CUDA events around
   each call and in device time (20 calls queued behind a sleep kernel,
   so that at T = 1 the launch's host cost does not count), with
   microseconds a step and the share of the bound; and the h exchange alone at the serving geometry, microseconds a
   step, for each protocol of ``EXCHANGES`` (``slstm_exchange_probe``).
   No single PyTorch call computes this recurrence.
10. Serving xlstm-350m at full width and full depth (24 layers: 18 mLSTM
   and 6 sLSTM blocks, bf16, 555,246,736 random parameters from a seeded
   generator): (0) one sLSTM block's kernel route against its plain route
   (fp32, S = 1024, a carried state) and one mLSTM block's chunked form
   (256) against its per-step one (fp32, S = 512); (a) ``generate`` with
   ``xlstm_chunk = 256`` on 4 prompts of 4096 tokens, greedy, 32 new
   tokens (counters zeroed just before and read just after: 6
   ``slstm_steps`` launches in the prefill and 6 in each decode step),
   then the same call traced (8 new tokens), with the share of the traced
   prefill taken by its 6 ``slstm`` kernels; (b) one prompt in chunks of
   512 (and, for information, one-shot against chunked in fp32 at 1024
   and 4096 tokens); (c) the serving launcher on the published config
   (``xlstm_chunk = 0``): 5 requests of 256 / 512 / 1024 / 256 / 512
   tokens, 4 slots, chunk 64, 16 new tokens.

11. The tree path's pair: ``sq_dist`` and ``apply_update`` against their
   plain versions on the cases of ``tests/test_kernels.py`` (n = 128 to
   40001) in fp32, bf16 and bf16 x with fp32 a, a row at an odd element
   offset, and the slice's leaves (``embed`` / ``lm_head``, n =
   262,144,000; a stacked MLP leaf, n = 180,355,072) in bf16 x / fp32 a
   and fp32 / fp32; two ``sq_dist`` calls must give the same bits. Times
   kernel, plain version and one PyTorch call (``torch.dist(x, a) ** 2``,
   ``torch.lerp``; fp32 / fp32) at n = 262,144,000 (CUDA events, median of
   20 after 3 warm-ups).
12. The tree path: yi-6b at full width, 4 layers, bf16 stacked leaves with
   fp32 momentum, ``engine="tree"``, as phase 3 otherwise (M = 4,
   simple_avg, tau 4, 16 steps). Counters zeroed just before the four
   rounds and read just after: 48 ``sq_dist`` and 48 ``apply_update``
   launches a round (M x 12 leaves). Then one ``easgd`` round (pull, then
   push): 144 and 48. Then, on the full-width state, one Eq. 5 round on
   the kernels against the same round on ``ref.py``'s plain functions,
   leaf by leaf.
13. The overlap modes: yi-6b at full width, 4 layers, as phase 3
   otherwise, through ``make_round_step``: ``staleness1``, ``doublebuf``
   (4 chunks), ``staleness_k`` k = 1 elastic (row 2 dropped through
   ``set_participation`` in rounds 1-2, forced back in at round 2 after k
   misses, ``sync = 0`` in round 3); then ``staleness_k`` k = 2 elastic at
   2 layers (a ring of two does not fit at 4; the reckoning is printed),
   6 rounds, row 2 out in rounds 2-4, ``sync = 0`` in round 5. Counters
   zeroed before each round and held to the launches the code implies;
   a frozen row and every row of a ``sync = 0`` round bit-exact; peak
   memory under 70 GB. Prints round ms (host clock, synchronised),
   boundary ms (CUDA events around the consensus application after the
   local steps), the chunk Grams' ms (events around each
   ``stage_comm``) and peak memory for each, beside phase 3's. (c) On
   the doublebuf run's full-width state: one stale application on the
   kernels (4 strided ``partial_gram`` chunks, ``mix_from_gram`` with the
   ``stale_mix`` epilogue) against the same on ``ref.py``'s plain
   functions, each row within 1e-5 of its scale; the epilogue bit-equal
   to the plain ``q + (mix(s) - s)`` on the kernel's coefficients;
   times of the epilogue, ``mix_from_gram`` and a strided chunk Gram
   beside a contiguous one; then doublebuf in one chunk against
   staleness_k k = 1 in one chunk, 3 rounds at 1 layer, bit for bit.
   (d) The launcher with ``--overlap doublebuf --log-every-round``:
   one JSONL record a round, staleness 0 in round 0 and 1 after.

It prints a ``kernels`` line, the ``{"kernels": [...]}`` record and, last,
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM published peaks (NVIDIA's data sheet): HBM bytes/s and
# fp32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SHAPES = ((4, 300), (8, 4097), (5, 2 ** 26 + 3), (32, 65537))
MAIN_R, MAIN_N = 4, 1_216_385_024
# the slice's depth and local-step learning rate (the launcher's default);
# PERF.md records the numbers of this depth and rate
LAYERS, LR = 4, 0.3
TOL = 1e-4          # max abs error relative to the output's scale
SOURCE = "src/repro_torch/kernels/pullpush/csrc/pullpush.cu"
# H100 SXM dense bf16 and TF32 tensor-core peaks (NVIDIA's data sheet)
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
# swa_attention cases: (B, H, Hkv, Sq, Skv, hd, window, cap, causal); the
# first six are tests/test_kernels.py::ATTN_CASES
ATTN_CASES = (
    (1, 4, 4, 128, 128, 64, 0, 0.0, True),
    (2, 4, 2, 256, 256, 64, 0, 0.0, True),
    (1, 8, 4, 384, 384, 128, 128, 0.0, True),
    (1, 2, 1, 512, 512, 64, 0, 50.0, True),
    (2, 4, 4, 200, 200, 64, 96, 30.0, True),
    (1, 4, 2, 128, 1024, 64, 256, 0.0, True),
    (1, 2, 1, 128, 200, 64, 0, 0.0, False),     # ragged, not causal
    (1, 2, 1, 300, 200, 64, 0, 0.0, True),      # Sq > Skv
    (1, 4, 4, 200, 200, 112, 96, 30.0, True),   # zamba2-7b's head_dim
    (2, 8, 4, 333, 333, 256, 96, 50.0, True),   # gemma2-2b's, small
)
# the serving shapes: gemma2-2b's local and global layers at S = 8160,
# and the cap 0 / window 0 case one PyTorch call computes
SERVE_S = 8160
ATTN_SLICE = {
    "local": (4, 8, 4, SERVE_S, SERVE_S, 256, 4096, 50.0, True),
    "global": (4, 8, 4, SERVE_S, SERVE_S, 256, 0, 50.0, True),
    "library": (4, 8, 4, SERVE_S, SERVE_S, 256, 0, 0.0, True),
    # zamba2-7b's shared attention: 32 heads over 32 kv heads, hd 112
    "zamba2": (4, 32, 32, SERVE_S, SERVE_S, 112, 0, 0.0, True),
}
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
ATTN_SOURCE = "src/repro_torch/kernels/swa_attention/csrc/swa_attention.cu"
ATTN_REPLACES = "src/repro/kernels/swa_attention/swa_attention.py:85"
# ssd_chunks cases: (B, H, nc, L, P, N), tests/test_kernels.py::SSD_CASES
SSD_CASES = (
    (1, 2, 2, 32, 16, 8),
    (2, 4, 3, 64, 32, 16),
    (1, 1, 4, 128, 64, 64),
)
# in the model's layout, (Bt, S, H, P, N, L): a ragged last chunk (70 =
# 2 x 32 + 6), and zamba2-7b's prefill
SSD_RAGGED = (2, 70, 3, 16, 8, 32)
SSD_SLICE = (4, SERVE_S, 112, 64, 64, 128)
# checked and timed after the serving shape, so that the draws above stay
# as they were: a 512-token chunk of zamba2-7b's chunked prefill and the
# serving launcher's 64-token chunk
SSD_MORE = {"chunk512": (1, 512, 112, 64, 64, 128),
            "launcher64": (1, 64, 112, 64, 64, 128)}
SSD_SOURCE = "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu"
SSD_REPLACES = "src/repro/kernels/mamba_scan/mamba_scan.py:46"
# zamba2-7b's parameter tree, counted from the reference's init
ZAMBA2_PARAMS = 5_737_416_000
# slstm_steps cases: (B, T, H, P, carried state); the first four are
# tests/test_kernels.py::SLSTM_CASES, then a carried state, T = 1, the
# reduced config's P = 128
SLSTM_CASES = (
    (2, 50, 2, 16, False),
    (1, 128, 4, 32, False),
    (2, 37, 2, 8, False),
    (1, 16, 1, 8, False),
    (2, 40, 3, 32, True),
    (3, 1, 4, 512, True),
    (2, 300, 4, 128, False),
)
# checked after the serving shape, so that its draws stay those above:
# xlstm-350m's 512-token chunk (B = 1) and a B above one batch group (9 =
# 4 + 4 + 1)
SLSTM_MORE_CASES = (
    (1, 512, 4, 512, False),
    (9, 64, 4, 512, True),
)
SLSTM_CHUNK = 512       # the chunked prefill's launch length
# xlstm-350m's prefill: B = 4 prompts of 4096 tokens, 4 heads of 512; its
# prefill in 512-token chunks (B = 1) and its decode step (T = 1)
SLSTM_SLICE = (4, 4096, 4, 512)
SLSTM_TIMED = {"serving": SLSTM_SLICE, "chunk": (1, 512, 4, 512),
               "decode": (4, 1, 4, 512)}
FORGET_BIAS = 3.0       # the forget part of b_gates (models/xlstm.py)
SLSTM_SOURCE = "src/repro_torch/kernels/slstm_step/csrc/slstm_step.cu"
SLSTM_REPLACES = "src/repro/kernels/slstm_step/slstm_step.py:79"
# xlstm-350m's parameter tree, counted from the reference's init
XLSTM_PARAMS = 555_246_736
REPLACES = {
    "fused_round": "src/repro/kernels/pullpush/pullpush.py:194",
    "partial_gram": "src/repro/kernels/pullpush/pullpush.py:298",
    "gram_coef": "src/repro/kernels/pullpush/pullpush.py:162",
    "mix_shard": "src/repro/kernels/pullpush/pullpush.py:319",
}
# the tree path's pair (phase 11): the cases of tests/test_kernels.py
PAIR_REPLACES = {
    "sq_dist": "src/repro/kernels/pullpush/pullpush.py:90",
    "apply_update": "src/repro/kernels/pullpush/pullpush.py:110",
}
PAIR_N = {"sq_dist": (128, 1000, 32768, 40001),
          "apply_update": (256, 5000, 33000)}
# the slice's leaves: embed / lm_head, and one stacked MLP leaf (4 layers)
PAIR_SLICE_N = (262_144_000, 180_355_072)
# phase 13: (label, overlap settings, layers, rounds, elastic plan);
# a plan maps a round to (row dropped or None, sync)
OVERLAP_RUNS = (
    ("staleness1", dict(overlap="staleness1"), LAYERS, 4, None),
    ("doublebuf", dict(overlap="doublebuf", overlap_chunks=4), LAYERS, 4,
     None),
    ("staleness_k k=1 elastic", dict(overlap="staleness_k", staleness=1,
                                     elastic=True, overlap_chunks=4),
     LAYERS, 4, {1: (2, 1.0), 2: (2, 1.0), 3: (None, 0.0)}),
    ("staleness_k k=2 elastic", dict(overlap="staleness_k", staleness=2,
                                     elastic=True, overlap_chunks=4),
     2, 6, {2: (2, 1.0), 3: (2, 1.0), 4: (2, 1.0), 5: (None, 0.0)}),
)
OVERLAP_TOL = 1e-5      # each row of a stale application, of its scale
STALE_SOURCE = SOURCE
STALE_REPLACES = {
    "mix_from_gram": "src/repro/kernels/pullpush/pullpush.py:345",
    "stale_mix": "src/repro/kernels/pullpush/pullpush.py:319 (mix_shard) "
                 "+ src/repro/train/trainer.py:387 (q + (c_out - s))",
}
PAIR_DTYPES = ((torch.float32, torch.float32),
               (torch.bfloat16, torch.bfloat16),
               (torch.bfloat16, torch.float32))
SQ_DIST_RTOL = 1e-5     # the same numbers summed in fp32 in another order


def _time_ms(fn, reps=20, warm=3):
    """Median CUDA-event time of ``fn`` in ms."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def _forms(G, T, coef):
    """Pre / post distance forms (zero-sum) of a Gram."""
    R = G.shape[0]
    eye = torch.eye(R, dtype=torch.float32, device=G.device)
    Vu = eye - 1.0 / R
    W = eye + coef[:, None] * (T - eye)
    f = lambda V: torch.sum((V @ G) * V, dim=1)
    return torch.cat([f(Vu), f(Vu @ W)])


class ErrLog:
    """Largest error per kernel, absolute and relative to the output's
    scale (max |plain output|); the relative one is held to TOL."""

    def __init__(self):
        self.abs = {k: 0.0 for k in REPLACES}
        self.rel = {k: 0.0 for k in REPLACES}

    def check(self, name, what, got, want):
        # column chunks: a full-width difference of the main path's view
        # would be one more 19.5 GB temporary
        got, want = got.reshape(got.shape[0], -1), want.reshape(
            want.shape[0], -1)
        err = max(float((g - w).abs().max()) for g, w in zip(
            got.split(1 << 24, dim=-1), want.split(1 << 24, dim=-1)))
        scale = max(float(want.max()), -float(want.min()), 1e-30)
        self.abs[name] = max(self.abs[name], err)
        self.rel[name] = max(self.rel[name], err / scale)
        if not err <= TOL * scale:
            raise AssertionError(f"{name} {what}: max abs err {err:.3e} > "
                                 f"{TOL} x {scale:.3e}")


def _inputs(R, n, gen):
    x = torch.randn((R, n), generator=gen, device="cuda")
    x.mul_(2.0).add_(1.0)
    T = torch.softmax(torch.randn((R, R), generator=gen, device="cuda"),
                      dim=1)
    c0 = torch.linspace(0.1, 0.5, R, device="cuda")
    c1 = torch.linspace(-0.4, -0.1, R, device="cuda")
    return x, T, c0, c1


def check_shape(pk, ref, errs, x, T, c0, c1):
    """Every kernel against its plain version on one input."""
    out, r, G = pk.fused_round(x, T, c0, c1)
    torch.cuda.synchronize()
    p_out, p_r, p_G = ref.fused_round_plain(x, T, c0, c1)
    coef = c0 + c1 / torch.clamp(p_r, min=1e-12)
    errs.check("fused_round", "out", out, p_out)
    errs.check("fused_round", "r", r, p_r)
    errs.check("fused_round", "G forms", _forms(G, T, coef),
               _forms(p_G, T, coef))
    del out
    Gk = pk.partial_gram(x)
    torch.cuda.synchronize()
    errs.check("partial_gram", "G forms", _forms(Gk, T, coef),
               _forms(p_G, T, coef))
    m = pk.mix_shard(x, T, coef)
    torch.cuda.synchronize()
    errs.check("mix_shard", "out", m, p_out)
    del m
    nblk = pk.workspace_blocks(x)
    ws = torch.stack([ref.partial_gram_plain(c)
                      for c in torch.tensor_split(x, nblk, dim=1)])
    g_G, g_r, g_coef = pk.gram_coef(ws, T, c0, c1)
    torch.cuda.synchronize()
    w_G = ws.sum(0)
    w_r, w_coef = ref.gram_coef_plain(w_G, T, c0, c1)
    errs.check("gram_coef", "G", g_G, w_G)
    errs.check("gram_coef", "r", g_r, w_r)
    errs.check("gram_coef", "coef", g_coef, w_coef)
    return p_out, p_r, coef, ws


def phase_kernels(pk, ref):
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = ErrLog()
    for R, n in SHAPES:
        check_shape(pk, ref, errs, *_inputs(R, n, gen))
        print(f"  checked ({R}, {n})")
    R, n = MAIN_R, MAIN_N
    x, T, c0, c1 = _inputs(R, n, gen)
    p_out, _, coef, ws = check_shape(pk, ref, errs, x, T, c0, c1)
    print(f"  checked ({R}, {n}) (main path)")
    del p_out
    out = torch.empty_like(x)
    times = {
        "fused_round": (
            _time_ms(lambda: pk.fused_round(x, T, c0, c1, out=out)),
            _time_ms(lambda: ref.fused_round_plain(x, T, c0, c1, out=out)),
            None),
        "partial_gram": (
            _time_ms(lambda: pk.partial_gram(x)),
            _time_ms(lambda: ref.partial_gram_plain(x)),
            _time_ms(lambda: torch.matmul(x, x.T))),
        "gram_coef": (
            _time_ms(lambda: pk.gram_coef(ws, T, c0, c1)),
            _time_ms(lambda: ref.gram_coef_plain(ws.sum(0), T, c0, c1)),
            None),
        "mix_shard": (
            _time_ms(lambda: pk.mix_shard(x, T, coef, out=out)),
            _time_ms(lambda: ref.mix_shard_plain(x, T, coef, out=out)),
            _time_ms(lambda: torch.matmul(T, x, out=out))),
    }
    nblk = ws.shape[0]
    small = 4 * (R * R + 3 * R)              # T, c0/c1/coef, r
    work = {   # (bytes: inputs once + outputs once, fp32 operations)
        "fused_round": (2 * R * n * 4 + small + R * R * 4,
                        2 * (2 * R * R * n)),
        "partial_gram": (R * n * 4 + R * R * 4, 2 * R * R * n),
        "gram_coef": (nblk * R * R * 4 + small + R * R * 4,
                      nblk * R * R + 4 * R ** 3),
        "mix_shard": (2 * R * n * 4 + small, 2 * R * R * n),
    }
    del x, out, ws
    torch.cuda.empty_cache()
    rows = {}
    for name, (ms, plain_ms, lib_ms) in times.items():
        nbytes, ops = work[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_FLOPS * 1e3
        rows[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": 0,
            "max_abs_err": errs.abs[name], "max_rel_err": errs.rel[name],
            "tol_rel": TOL, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms}
    return rows


def phase_slice(pk):
    from repro_torch.configs import DPPFConfig, get_arch
    from repro_torch.core import consensus
    from repro_torch.data import TokenTask, make_round_batch
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.train import (
        RoundClock, init_train_state, make_round_step,
    )
    import repro_torch.train.trainer as trainer_mod

    cfg = dataclasses.replace(get_arch("yi-6b"), n_layers=LAYERS)
    M, tau, steps, seq, batch = 4, 4, 16, 64, 8
    print(f"  config {cfg.name}: d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, layers {cfg.n_layers}, dtype {cfg.dtype}; "
          f"M={M} tau={tau} steps={steps} seq={seq} batch={batch} "
          f"lr={LR}")
    model = build_model(cfg)
    dcfg = DPPFConfig(alpha=0.1, lam=0.5, tau=tau, consensus="simple_avg",
                      engine="flat")
    opt = make_optimizer("sgd", momentum=0.9, weight_decay=1e-3)
    clock = RoundClock.from_config(dcfg, base_lr=LR, total_steps=steps)
    task = TokenTask(vocab_size=cfg.vocab_size, seq_len=seq)
    gen = torch.Generator(device="cuda").manual_seed(0)

    torch.cuda.reset_peak_memory_stats()
    pk.reset_launches()                     # main path: counts from here
    state = init_train_state(model.init, opt, dcfg, M, gen, device="cuda")
    n = state.engine.layout.n
    if n != cfg.param_count():
        raise AssertionError(f"flat view has {n} columns, param_count() "
                             f"{cfg.param_count()}")
    print(f"  flat view ({state.engine.layout.R}, {n}) fp32, "
          f"use_kernel={state.engine.use_kernel}")
    step = make_round_step(model.loss, opt, dcfg, clock=clock)
    stages_per_round = sum(
        s[0] == "coef" for s in consensus.lower_stages(
            state.engine, dcfg, clock.lam_at(0))[0])

    # CUDA events around the consensus stage of each round
    apply_round = trainer_mod.consensus.apply_round
    events = []

    def timed_apply_round(*a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = apply_round(*a, **kw)
        e1.record()
        events.append((e0, e1))
        return out

    trainer_mod.consensus.apply_round = timed_apply_round
    rounds = []
    try:
        for spec in clock.rounds:
            b = make_round_batch(task, 0, M, spec.tau, spec.start, batch,
                                 cfg, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            round_ms = (time.perf_counter() - t0) * 1e3
            cons_ms = events[-1][0].elapsed_time(events[-1][1])
            row = {"round": spec.index, "loss": float(m["train_loss"]),
                   "consensus_dist": float(m["consensus_dist"]),
                   "round_ms": round_ms, "consensus_ms": cons_ms,
                   "local_ms": round_ms - cons_ms}
            rounds.append(row)
            print("  round " + json.dumps(row))
    finally:
        trainer_mod.consensus.apply_round = apply_round
    launches = dict(pk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"  peak memory allocated {peak} bytes ({peak / 1e9:.2f} GB)")
    print(f"  launches on the main path {json.dumps(launches)}")
    if not all(math.isfinite(r["loss"]) for r in rounds):
        raise AssertionError("non-finite training loss")
    if not all(r["consensus_dist"] > 0 for r in rounds[1:]):
        raise AssertionError("consensus_dist is 0 after round 0")
    want = stages_per_round * len(rounds)
    if launches["fused_round"] != want:
        raise AssertionError(f"fused_round launched {launches['fused_round']}"
                             f" times for {want} consensus stages")
    for name in REPLACES:
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched on the main path")
    if peak > 70e9:
        raise AssertionError(f"peak memory {peak / 1e9:.1f} GB > 70 GB: set "
                             "LAYERS = 2 and record why in PERF.md")
    later = rounds[1:] or rounds
    summary = {k: statistics.mean(r[k] for r in later)
               for k in ("round_ms", "consensus_ms", "local_ms")}
    print("  mean of rounds 1.. " + json.dumps(summary))
    del state, step
    torch.cuda.empty_cache()
    return launches, dict(summary, peak_bytes=peak)


def phase_launcher(pk):
    from repro_torch.launch.train import main as train_main
    for engine, kernels in (("flat", ("fused_round",)),
                            ("tree", ("sq_dist", "apply_update"))):
        pk.reset_launches()
        loss = train_main(["--arch", "yi-6b", "--smoke", "--workers", "4",
                           "--tau", "4", "--steps", "16", "--seq", "16",
                           "--batch", "2", "--engine", engine])
        if not math.isfinite(loss):
            raise AssertionError(f"launcher ({engine}) eval loss {loss}")
        if any(pk.LAUNCHES[k] <= 0 for k in kernels):
            raise AssertionError(f"the launcher's {engine} rounds launched "
                                 f"no {kernels}")
        print(f"  launcher --engine {engine}: eval loss {loss:.4f}, "
              f"launches {json.dumps(dict(pk.LAUNCHES))}")


# ---------------------------------------------------------------------------
# phase 5: the attention kernel
# ---------------------------------------------------------------------------

def _in_band_pairs(Sq, Skv, causal, window):
    """(q, k) pairs the mask keeps, counted for these shapes."""
    qp = np.arange(Sq)
    lo = np.maximum(qp - window + 1, 0) if window > 0 else np.zeros_like(qp)
    hi = np.minimum(qp, Skv - 1) if causal else np.full_like(qp, Skv - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _attn_bound(case, dtype):
    """Least time in ms: 4 hd FLOPs per in-band pair per (b, h) over the
    peak of the inputs' type, or q, k, v read once and the output written
    once over the memory rate, whichever is larger."""
    B, H, Hkv, Sq, Skv, hd, window, cap, causal = case
    flops = _in_band_pairs(Sq, Skv, causal, window) * 4 * hd * B * H
    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    esize = torch.finfo(dtype).bits // 8
    nbytes = esize * hd * (2 * B * H * Sq + 2 * B * Hkv * Skv)
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), flops


def _attn_plain_rows(plain, q, k, v, **kw):
    """The plain version one batch row at a time: one row of the serving
    shape's fp32 scores is 2.1 GB."""
    return torch.cat([plain(q[b:b + 1], k[b:b + 1], v[b:b + 1], **kw)
                      for b in range(q.shape[0])])


def _row_rel_err(got, want):
    """The largest error of a query row over that row's own largest
    |want|, maximised over (b, h, row). A row that attends to n keys has
    outputs of order n^-1/2, so one scale for the whole tensor (set by the
    first rows) would not see a wrong long row."""
    d = (got.float() - want.float()).abs().amax(-1)
    return float((d / want.float().abs().amax(-1).clamp_min(1e-30)).max())


def _model_layout(t):
    """The same values as the transposed view of a (B, S, H, hd) tensor:
    the layout ``qkv_proj`` hands the kernel on the main path."""
    return t.transpose(1, 2).contiguous().transpose(1, 2)


def _attn_case(swa, plain, case, dtype, gen, name):
    """One case against the plain version, each query row held to the
    dtype's tolerance of its own largest |value|; bf16 also in the model's
    transposed (B, S, H, hd) view, whose strides the TMA descriptors are
    built from."""
    B, H, Hkv, Sq, Skv, hd, window, cap, causal = case
    q = torch.randn((B, H, Sq, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Hkv, Skv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Hkv, Skv, hd), generator=gen, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window, cap=cap)
    got = swa.swa_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = _attn_plain_rows(plain, q, k, v, **kw)
    err = float((got.float() - want.float()).abs().max())
    rel = _row_rel_err(got, want)
    tol = ATTN_TOL[dtype]
    if not rel <= tol:
        raise AssertionError(f"swa_attention {name} {dtype}: largest error "
                             f"over its row's scale {rel:.3e} > {tol}")
    del got
    bound, bound_by, flops = _attn_bound(case, dtype)
    row = {"case": name, "shape": list(case), "dtype": str(dtype)[6:],
           "max_abs_err": err, "max_rel_err": rel, "tol_rel": tol,
           "ms": _time_ms(lambda: swa.swa_attention(q, k, v, **kw)),
           "plain_ms": _time_ms(lambda: _attn_plain_rows(plain, q, k, v,
                                                         **kw)),
           "bound_ms": bound, "bound_by": bound_by, "flops": flops,
           "library_ms": None}
    if dtype == torch.bfloat16:
        qm, km, vm = (_model_layout(t) for t in (q, k, v))
        got = swa.swa_attention(qm, km, vm, **kw)
        torch.cuda.synchronize()
        row["max_rel_err_model_layout"] = _row_rel_err(got, want)
        if not row["max_rel_err_model_layout"] <= tol:
            raise AssertionError(
                f"swa_attention {name} bf16 in the (B, S, H, hd) layout: "
                "largest error over its row's scale "
                f"{row['max_rel_err_model_layout']:.3e} > {tol}")
        del got
        row["ms_model_layout"] = _time_ms(
            lambda: swa.swa_attention(qm, km, vm, **kw))
        del qm, km, vm
    del want
    if causal and not window and not cap and Sq == Skv:
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row["library_ms"] = _time_ms(lambda: sdpa(q, k, v, is_causal=True,
                                                  enable_gqa=True))
    print("  attention " + json.dumps(row))
    if name in ATTN_SLICE and dtype == torch.bfloat16:
        ratio = (f", {row['ms'] / row['library_ms']:.3f} x "
                 "scaled_dot_product_attention" if row["library_ms"] else "")
        print(f"  {name} bf16: {row['ms']:.4f} ms "
              f"({row['ms_model_layout']:.4f} in the model's layout), "
              f"{flops / row['ms'] / 1e9:.1f} TFLOP/s, "
              f"{bound / row['ms']:.1%} of the bound{ratio}")
    return row


def _ptxas_report(log, kernels=("swa_wgmma_kernel", "swa_kernel")):
    """{kernel instance: (registers, spill store bytes, spill load bytes)}
    from ptxas's -v report of a source (by default swa_attention's;
    an instance is named by its first template argument)."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(rf"({'|'.join(kernels)})(?:ILi(\d+)E)?", m[1])
            name = (f"{k[1]}<{k[2]}>" if k[2] else k[1]) if k else m[1]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name] = [None, int(m[1]), int(m[2])]
        m = re.search(r"Used (\d+) registers", line)
        if m and name in out:
            out[name][0] = int(m[1])
    return {k: tuple(v) for k, v in out.items()}


def _sass_census(path, kernels=("swa_wgmma_kernel", "swa_kernel"),
                 op="HGMMA"):
    """{kernel instance: (highest register the SASS names, ``op``
    instructions: HGMMA for wgmma, HMMA for mma.sync)} from ``cuobjdump
    -sass`` of the built library. ptxas reports a launch's registers; a
    warpgroup that raises its share with ``setmaxnreg`` shows only here."""
    import re
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(rf"Function : \S*?({'|'.join(kernels)})ILi(\d+)E",
                      line)
        if m:
            name = f"{m[1]}<{m[2]}>"
            out[name] = [-1, 0]
        elif "Function : " in line:
            name = None
        elif name:
            for r in re.findall(r"\bR(\d+)\b", line):
                out[name][0] = max(out[name][0], int(r))
            out[name][1] += bool(re.search(rf"\b{op}\.", line))
    return {k: tuple(v) for k, v in out.items()}


def phase_attention(swa, plain):
    from repro_torch.kernels import _build
    info = _build.build_info["swa_attention"]
    regs = _ptxas_report(info["log"])
    print("  ptxas (registers, spill store / load bytes) " + json.dumps(regs))
    sass = _sass_census(info["path"])
    print("  SASS (highest register, HGMMA instructions) "
          + json.dumps(sass))
    wgmma = {k: v for k, v in sass.items() if "wgmma" in k}
    if len(wgmma) != len(swa.HEAD_DIMS) or not all(
            n for _, n in wgmma.values()):
        raise AssertionError("the bf16 kernel's instances do not all run "
                             f"their products on wgmma: {sass}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(ATTN_CASES):
            rows.append(_attn_case(swa, plain, case, dtype, gen, f"case{i}"))
        for name, case in ATTN_SLICE.items():
            rows.append(_attn_case(swa, plain, case, dtype, gen, name))
            torch.cuda.empty_cache()
    by = {(r["case"], r["dtype"]): r for r in rows}
    head, local = by[("global", "bfloat16")], by[("local", "bfloat16")]
    lib = by[("library", "bfloat16")]
    z = by[("zamba2", "bfloat16")]
    return {
        "name": "swa_attention", "route": "cuda", "source": ATTN_SOURCE,
        "replaces": ATTN_REPLACES, "launches": 0,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # errors over each query row's own scale
        "max_rel_err": max(r["max_rel_err"] for r in rows
                           if r["dtype"] == "bfloat16"),
        "tol_rel": ATTN_TOL[torch.bfloat16],
        "max_rel_err_fp32": max(r["max_rel_err"] for r in rows
                                if r["dtype"] == "float32"),
        "tol_rel_fp32": ATTN_TOL[torch.float32],
        # the headline: a global layer of the serving prefill, bf16, cap 50
        "shape": head["shape"], "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        # scaled_dot_product_attention(is_causal, enable_gqa) at cap 0
        "library_ms": lib["library_ms"], "ms_library_case": lib["ms"],
        "ms_local": local["ms"], "plain_ms_local": local["plain_ms"],
        "bound_ms_local": local["bound_ms"],
        "ms_hd112": z["ms"], "plain_ms_hd112": z["plain_ms"],
        "bound_ms_hd112": z["bound_ms"], "library_ms_hd112": z["library_ms"],
        "max_rel_err_model_layout": max(
            r["max_rel_err_model_layout"] for r in rows
            if r["dtype"] == "bfloat16"),
        "ms_model_layout": head["ms_model_layout"],
        "product_route": "wgmma", "sass_bf16": wgmma,
        "ptxas_bf16": {k: v for k, v in regs.items() if "wgmma" in k}}


# ---------------------------------------------------------------------------
# phase 6: serving gemma2-2b
# ---------------------------------------------------------------------------

def _events_of(model, names):
    """The model with CUDA events around each call of the named lanes."""
    events = {n: [] for n in names}

    def wrap(name, fn):
        def run(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            events[name].append((e0, e1))
            return out
        return run
    return dataclasses.replace(model, **{n: wrap(n, getattr(model, n))
                                         for n in names}), events


def _serve_reference_check(swa, cfg):
    """(0) The kernel route of the prefill (fresh caches at index 0)
    against the training path's ``attend`` on the same input, at full
    width, 2 layers (one local, one global) and fp32; S = 4608 crosses
    the local window. Hidden states at every position, tolerance 1e-4 of
    their scale."""
    from repro_torch.models import build_model
    from repro_torch.models import transformer as lm

    small = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params = build_model(small).init(
        torch.Generator(device="cuda").manual_seed(3), "cuda")
    tokens = torch.randint(0, small.vocab_size, (1, 4608), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(4))
    with torch.no_grad():
        x = lm._embed(params, small, tokens)
        want, _, _ = lm.run_blocks(params["blocks"], x, small)
        before = swa.LAUNCHES["swa_attention"]
        states = lm.init_states(small, 1, 4608, torch.float32, device="cuda")
        got, _, _ = lm.run_blocks(params["blocks"], x, small, states=states,
                                  index=0)
    if swa.LAUNCHES["swa_attention"] - before != small.n_layers:
        raise AssertionError("the kernel route was not taken")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    print(f"  (0) kernel route vs attend, full width, 2 layers, fp32, "
          f"S=4608: max abs err {err:.3e} (scale {scale:.3e})")
    if not err <= 1e-4 * scale:
        raise AssertionError(f"prefill kernel route differs from attend: "
                             f"{err:.3e} > 1e-4 x {scale:.3e}")


def _profile_generate(generate, model, params, prompts, buf, new,
                      prefill_kernel=None):
    """``torch.profiler`` over one ``generate`` call (prefill + new - 1
    decode steps): wall time, the device's busy time (the sum of its
    kernels' and copies' spans: one stream, so they do not overlap) and
    idle share, and the kernels that hold the device longest. With
    ``prefill_kernel = (name, n)``: the time of the kernels whose name
    holds ``name``, in all and in their first n launches (the prefill's)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate(model, params, {"tokens": prompts}, max_new_tokens=new,
                 buf_len=buf)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    swa = [(ms, n) for name, (ms, n) in by_name.items() if "swa_" in name]
    out = {"new_tokens": new, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "swa_ms": sum(ms for ms, _ in swa),
           "swa_kernels": sum(n for _, n in swa),
           "idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
           "device_launches": sum(n for _, n in by_name.values()),
           "top": [[name[:70], ms, n] for name, (ms, n) in top]}
    if prefill_kernel:
        name, n = prefill_kernel
        spans = sorted((e.time_range.start, e.time_range.elapsed_us() / 1e3)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA and name in e.name)
        out[f"{name}_ms"] = sum(ms for _, ms in spans)
        out[f"{name}_kernels"] = len(spans)
        out[f"{name}_prefill_ms"] = sum(ms for _, ms in spans[:n])
    if not busy_ms:
        out["note"] = "the profiler recorded no device time: not measured"
    return out


def phase_serving(swa):
    from repro_torch.configs import get_arch
    from repro_torch.core.engine import tree_items
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import build_model
    from repro_torch.serving import generate

    cfg = get_arch("gemma2-2b")
    _serve_reference_check(swa, cfg)
    torch.cuda.empty_cache()

    B, NEW, BUF = 4, 32, 8192
    print(f"  config {cfg.name}: d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, head_dim {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, layers {cfg.n_layers}, "
          f"window {cfg.sliding_window}, dtype {cfg.dtype}; B={B} "
          f"S={SERVE_S} new={NEW} buf_len={BUF}")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    n = sum(leaf.numel() for _, leaf in tree_items(params))
    # param_count() leaves out gemma2's post-block norms (ROADMAP Queue 3)
    post = 2 * cfg.d_model * cfg.n_layers if cfg.post_block_norm else 0
    print(f"  parameters {n} = param_count() {cfg.param_count()} + "
          f"post-block norms {post}")
    if n != cfg.param_count() + post:
        raise AssertionError("parameter count differs from the config's")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, SERVE_S))).cuda()

    # (a) the main path: generate, counters zeroed just before
    timed, events = _events_of(model, ("prefill", "decode_step"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    swa.reset_launches()
    t0 = time.perf_counter()
    toks, logits = generate(timed, params, {"tokens": prompts},
                            max_new_tokens=NEW, buf_len=BUF)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = swa.LAUNCHES["swa_attention"]
    peak = torch.cuda.max_memory_allocated()
    prefill_ms = events["prefill"][0][0].elapsed_time(events["prefill"][0][1])
    dec = [a.elapsed_time(b) for a, b in events["decode_step"]]
    a = {"prefill_ms": prefill_ms, "ttft_ms": prefill_ms,
         "decode_ms_per_token": statistics.mean(dec),
         "decode_ms_median": statistics.median(dec),
         "wall_s": wall, "tok_s": B * NEW / wall,
         "prefill_tok_s": B * SERVE_S / (prefill_ms / 1e3),
         "peak_bytes": peak, "swa_launches": launches}
    print("  (a) generate " + json.dumps(a))
    print(f"  first tokens {toks[:, :8].tolist()}")
    if launches != cfg.n_layers:
        raise AssertionError(f"swa_attention launched {launches} times in "
                             f"the prefill, not {cfg.n_layers}")
    if toks.shape != (B, NEW) or not bool(torch.isfinite(logits).all()):
        raise AssertionError("generate gave a bad shape or non-finite logits")
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError("token ids out of the vocabulary")
    # where the time goes: the same call, traced, with 8 new tokens
    prof = _profile_generate(generate, timed, params, prompts, BUF, 8)
    prof["prefill_ms"] = events["prefill"][-1][0].elapsed_time(
        events["prefill"][-1][1])
    prof["swa_share_of_prefill"] = prof["swa_ms"] / prof["prefill_ms"]
    print("  (a) profile " + json.dumps(prof))

    # (b) one prompt in chunks of 512: the first through the kernel
    swa.reset_launches()
    states, start = model.make_state(params, {"tokens": prompts[:1]}, BUF)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for j in range(0, SERVE_S, 512):
        lg, states = model.prefill_chunk(params, states,
                                         prompts[:1, j:j + 512], start + j)
    e1.record()
    torch.cuda.synchronize()
    diff = float((lg[0] - logits[0]).abs().max())
    print(f"  (b) chunked prefill (512): {e0.elapsed_time(e1):.1f} ms, "
          f"swa launches {swa.LAUNCHES['swa_attention']}, max |last-token "
          f"logits - (a)'s| {diff:.4f} (information; logits scale "
          f"{float(logits[0].abs().max()):.2f})")
    if swa.LAUNCHES["swa_attention"] != cfg.n_layers:
        raise AssertionError("the first chunk did not run the kernel")
    del params, states, timed, model, lg, logits
    torch.cuda.empty_cache()

    # (c) the continuous-batching launcher at full size
    swa.reset_launches()
    report = serve_main(["--arch", "gemma2-2b", "--requests", "8",
                         "--max-slots", "4", "--prompt-len", "512",
                         "--new-tokens", "32", "--chunk", "64"])
    c = {"steps": report.steps, "generated": report.generated,
         "occupancy": report.occupancy, "wall_s": report.wall_s,
         "tok_s": report.tok_s, "ttft_mean_ms": report.ttft_mean_s * 1e3,
         "swa_launches": swa.LAUNCHES["swa_attention"]}
    print("  (c) launcher " + json.dumps(c))
    if sorted(report.results) != list(range(8)) or any(
            len(r.tokens) != 32 for r in report.results.values()):
        raise AssertionError("the launcher left requests unfinished")
    if swa.LAUNCHES["swa_attention"] == 0:
        raise AssertionError("the launcher launched no swa_attention")
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 7: the SSD kernel
# ---------------------------------------------------------------------------

def _rel_err(got, want):
    """(max abs error, the plain output's scale)."""
    return (float((got - want).abs().max()),
            max(float(want.abs().max()), 1e-30))


def _ssd_check(name, errs, got, want):
    for what, g, w in zip(("y", "states"), got, want):
        err, scale = _rel_err(g, w)
        errs.append((err, err / scale))
        if not err <= TOL * scale:
            raise AssertionError(f"ssd_chunks {name} {what}: max abs err "
                                 f"{err:.3e} > {TOL} x {scale:.3e}")


def _ssd_bound(Bt, S, H, P, N, L):
    """Least time in ms for ``ssd_chunks_seq`` on S tokens in chunks of L:
    x, B, C, a read once and y, states written once over the memory rate,
    or the operations the function needs over the peak of the route,
    whichever is larger. A chunk of v tokens has v (v + 1) / 2 causal
    (t, s) pairs; per pair y = (G o decay) x needs 2 P FLOPs per head and
    S = G o decay one multiply per head, G = C B^T needs 2 N once per (b,
    chunk) (it does not depend on the head), and the state x^T (B o rem)
    needs 2 P N per token and head. Pairs with s > t and tokens past S
    need nothing. The kernel's route takes each product in 3xTF32 (three
    TF32 passes on the tensor cores), so its operations bound is 3 x the
    FLOPs over the TF32 peak; the fp32 CUDA-core figure (the first
    kernel's route) and one TF32 pass are kept beside it."""
    nc = -(-S // L)
    pairs = sum(v * (v + 1) // 2 for v in (min(L, S - c * L)
                                            for c in range(nc)))
    nbytes = 4 * (2 * Bt * S * H * P + Bt * H * nc * P * N
                  + 2 * Bt * S * N + Bt * S * H)
    flops = (Bt * H * (2 * P * pairs + pairs + 2 * P * N * S)
             + Bt * 2 * N * pairs)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * flops / TF32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_ms_bytes": t_bytes, "bound_ms_3xtf32_ops": t_ops,
            "bound_ms_tf32_ops": flops / TF32_FLOPS * 1e3,
            "bound_ms_fp32_ops": flops / FP32_FLOPS * 1e3, "flops": flops}


def _ssd_census(mk):
    """ptxas's registers and spills and the SASS census of every instance
    of the kernel (``ssd_kernel<MP>``, MP = P / 16): its products must run
    on the tensor cores (HMMA, mma.sync; or HGMMA, wgmma)."""
    from repro_torch.kernels import _build
    info = _build.build_info["mamba_scan"]
    regs = _ptxas_report(info["log"], kernels=("ssd_kernel",))
    hmma = _sass_census(info["path"], kernels=("ssd_kernel",), op="HMMA")
    hgmma = _sass_census(info["path"], kernels=("ssd_kernel",), op="HGMMA")
    census = {k: {"ptxas_registers": regs.get(k, (None,))[0],
                  "spill_store_bytes": regs.get(k, (None, None))[1],
                  "spill_load_bytes": regs.get(k, (None, None, None))[2],
                  "sass_highest_register": v[0], "hmma": v[1],
                  "hgmma": hgmma[k][1]} for k, v in hmma.items()}
    print("  ptxas and SASS per instance " + json.dumps(census))
    if len(census) != mk.MAX_P // 16 or not all(
            c["hmma"] + c["hgmma"] for c in census.values()):
        raise AssertionError("ssd_kernel's instances do not all run their "
                             f"products on the tensor cores: {census}")
    return census


def phase_ssd(mk, ssd_ref):
    census = _ssd_census(mk)
    for name, (Bt, S, H, P, N, L) in dict(
            serving=SSD_SLICE, **SSD_MORE).items():
        print(f"  geometry {name}: {mk.geometry(Bt, S, H, L, P, N)}")
    gen = torch.Generator(device="cuda").manual_seed(5)
    errs = []

    def a_log_of(shape, scale=1.0):
        return -scale * torch.nn.functional.softplus(
            torch.randn(shape, generator=gen, device="cuda"))
    for i, (B, H, nc, L, P, N) in enumerate(SSD_CASES):
        x = torch.randn((B, H, nc, L, P), generator=gen, device="cuda")
        B_, C_ = (torch.randn((B, nc, L, N), generator=gen, device="cuda")
                  for _ in range(2))
        a = a_log_of((B, H, nc, L))
        got = mk.ssd_chunks(x, B_, C_, a)
        torch.cuda.synchronize()
        _ssd_check(f"case{i}", errs, got,
                   ssd_ref.ssd_chunks_plain(x, B_, C_, a))
        print(f"  checked case{i} {(B, H, nc, L, P, N)}")

    def seq_inputs(Bt, S, H, P, N, decay):
        xh = torch.randn((Bt, S, H, P), generator=gen, device="cuda")
        conv = torch.randn((Bt, S, 2 * N + 64), generator=gen,
                           device="cuda")
        # B_ and C_ as strided column slices, as the conv output gives them
        return (xh, conv[..., :N], conv[..., N:2 * N],
                a_log_of((Bt, S, H)) * decay)

    def zamba2_decay(H):  # zamba2's A = 1..8: la falls to about -700
        return torch.linspace(1.0, 8.0, H, device="cuda")
    # the model's layout: a ragged last chunk (the plain version pads it
    # with zeros, the kernel reads past S as zero), then the serving shape,
    # whose decay spans zamba2's A = 1..8 (la falls to about -700 over a
    # chunk); the serving shape twice, bit for bit
    bit_equal = None
    for name, (Bt, S, H, P, N, L), decay in (
            ("ragged", SSD_RAGGED, 1.0),
            ("serving shape", SSD_SLICE, zamba2_decay(SSD_SLICE[2]))):
        xh, B_, C_, a = seq_inputs(Bt, S, H, P, N, decay)
        got = mk.ssd_chunks_seq(xh, B_, C_, a, L)
        torch.cuda.synchronize()
        _ssd_check(name, errs, got,
                   ssd_ref.ssd_chunks_seq_plain(xh, B_, C_, a, L))
        if name == "serving shape":
            again = mk.ssd_chunks_seq(xh, B_, C_, a, L)
            bit_equal = all(torch.equal(u, v) for u, v in zip(got, again))
            del again
            if not bit_equal:
                raise AssertionError("two launches at the serving shape "
                                     "differ")
        del got
        torch.cuda.empty_cache()
        print(f"  checked the {name} {(Bt, S, H, P, N, L)}: "
              f"{-(-S // L)} chunks" + (", two launches bit-equal"
                                       if bit_equal else ""))
    ms = _time_ms(lambda: mk.ssd_chunks_seq(xh, B_, C_, a, L))
    plain_ms = _time_ms(lambda: ssd_ref.ssd_chunks_seq_plain(xh, B_, C_, a,
                                                             L))
    bound = _ssd_bound(Bt, S, H, P, N, L)
    row = {"name": "ssd_chunks", "route": "cuda", "source": SSD_SOURCE,
           "replaces": SSD_REPLACES, "launches": 0,
           "product_route": "mma.sync m16n8k8 tf32, 3xTF32",
           "shape": [Bt, S, H, P, N, L], "ms": ms, "plain_ms": plain_ms,
           **bound, "bit_equal_serving": bit_equal,
           "library_ms": None,
           "library_note": "no single PyTorch call computes the SSD chunk",
           "census": census}
    del xh, B_, C_, a
    torch.cuda.empty_cache()
    # the chunked prefill's and the launcher's chunks, checked and timed
    for name, (Bt, S, H, P, N, L) in SSD_MORE.items():
        xh, B_, C_, a = seq_inputs(Bt, S, H, P, N, zamba2_decay(H))
        got = mk.ssd_chunks_seq(xh, B_, C_, a, L)
        torch.cuda.synchronize()
        _ssd_check(name, errs, got,
                   ssd_ref.ssd_chunks_seq_plain(xh, B_, C_, a, L))
        row[f"ms_{name}"] = _time_ms(
            lambda: mk.ssd_chunks_seq(xh, B_, C_, a, L))
        row[f"plain_ms_{name}"] = _time_ms(
            lambda: ssd_ref.ssd_chunks_seq_plain(xh, B_, C_, a, L))
        row[f"bound_ms_{name}"] = _ssd_bound(Bt, S, H, P, N, L)["bound_ms"]
        print(f"  checked and timed {name} {(Bt, S, H, P, N, L)}: "
              f"{row[f'ms_{name}']:.4f} ms")
    row["max_abs_err"] = max(e for e, _ in errs)
    row["max_rel_err"] = max(r for _, r in errs)
    row["tol_rel"] = TOL
    print("  ssd_chunks " + json.dumps(row))
    return row


# ---------------------------------------------------------------------------
# phase 8: serving zamba2-7b
# ---------------------------------------------------------------------------

def _mamba_route_check(mk, cfg):
    """(0) One Mamba2 block at full width in fp32, S = 1024, with non-zero
    carried-in ssm and conv states: the kernel route (no gradient
    recorded) against the plain ``_ssd_chunked`` route (a gradient
    recorded), outputs and new states within 1e-4 of their scale."""
    from repro_torch.models import ssm
    gen = torch.Generator(device="cuda").manual_seed(6)
    p = ssm.init_mamba(gen, cfg, torch.float32, device="cuda")
    x = torch.randn((1, 1024, cfg.d_model), generator=gen, device="cuda")
    state = ssm.init_mamba_state(cfg, 1, torch.float32, device="cuda")
    state["ssm"].normal_(generator=gen)
    state["conv"].normal_(generator=gen)
    plain_state = {k: v.clone() for k, v in state.items()}
    before = mk.LAUNCHES["ssd_chunks"]
    with torch.no_grad():
        got, _ = ssm.mamba_forward(p, x, cfg, state)
    if mk.LAUNCHES["ssd_chunks"] != before + 1:
        raise AssertionError("the kernel route was not taken")
    with torch.enable_grad():
        want, _ = ssm.mamba_forward(p, x.clone().requires_grad_(True), cfg,
                                    plain_state)
    if mk.LAUNCHES["ssd_chunks"] != before + 1:
        raise AssertionError("the plain route launched the kernel")
    out = {}
    for name, g, w in (("out", got, want),
                       ("ssm", state["ssm"], plain_state["ssm"]),
                       ("conv", state["conv"], plain_state["conv"])):
        err, scale = _rel_err(g, w.detach())
        out[name] = [err, scale]
        if not err <= 1e-4 * scale:
            raise AssertionError(f"mamba kernel route {name}: {err:.3e} > "
                                 f"1e-4 x {scale:.3e}")
    print("  (0) mamba block, kernel route vs plain, full width, fp32, "
          "S=1024, carried states: [max abs err, scale] " + json.dumps(out))


def _scan_events():
    """CUDA events around every SSD scan and its kernel call (the glue is
    the scan less the kernel). Returns (events, undo)."""
    from repro_torch.kernels.mamba_scan import ops
    events = {"scan": [], "kernel": []}
    real = {"ssd_scan": ops.ssd_scan, "ssd_chunks_seq": ops.ssd_chunks_seq}

    def timed(name, fn):
        def run(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            events[name].append((e0, e1))
            return out
        return run
    ops.ssd_scan = timed("scan", real["ssd_scan"])
    ops.ssd_chunks_seq = timed("kernel", real["ssd_chunks_seq"])

    def undo():
        ops.ssd_scan = real["ssd_scan"]
        ops.ssd_chunks_seq = real["ssd_chunks_seq"]
    return events, undo


def phase_zamba2(swa, mk):
    from repro_torch.configs import get_arch
    from repro_torch.core.engine import tree_items
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import build_model
    from repro_torch.serving import generate

    cfg = get_arch("zamba2-7b")
    _mamba_route_check(mk, cfg)
    torch.cuda.empty_cache()

    B, NEW, BUF = 4, 32, 8192
    n_mamba = cfg.blocks().count("mamba")
    n_attn = cfg.blocks().count("shared_attn")
    print(f"  config {cfg.name}: d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, head_dim {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, layers {cfg.n_layers} "
          f"({n_mamba} mamba, {n_attn} shared_attn), ssm heads "
          f"{cfg.ssm_heads}, state {cfg.ssm_state}, chunk {cfg.ssm_chunk}, "
          f"dtype {cfg.dtype}; B={B} S={SERVE_S} new={NEW} buf_len={BUF}")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    n = sum(leaf.numel() for _, leaf in tree_items(params))
    print(f"  parameters {n} (param_count() says {cfg.param_count()}: it "
          "overcounts Mamba blocks, ROADMAP Queue 3)")
    if n != ZAMBA2_PARAMS:
        raise AssertionError(f"zamba2-7b has {n} parameters, not "
                             f"{ZAMBA2_PARAMS}")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, SERVE_S))).cuda()

    # (a) the main path: generate, counters zeroed just before
    timed, events = _events_of(model, ("prefill", "decode_step"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    swa.reset_launches()
    mk.reset_launches()
    t0 = time.perf_counter()
    toks, logits = generate(timed, params, {"tokens": prompts},
                            max_new_tokens=NEW, buf_len=BUF)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"ssd_chunks": mk.LAUNCHES["ssd_chunks"],
                "swa_attention": swa.LAUNCHES["swa_attention"]}
    peak = torch.cuda.max_memory_allocated()
    prefill_ms = events["prefill"][0][0].elapsed_time(events["prefill"][0][1])
    dec = [a.elapsed_time(b) for a, b in events["decode_step"]]
    a = {"prefill_ms": prefill_ms, "ttft_ms": prefill_ms,
         "decode_ms_per_token": statistics.mean(dec),
         "decode_ms_median": statistics.median(dec),
         "wall_s": wall, "tok_s": B * NEW / wall,
         "prefill_tok_s": B * SERVE_S / (prefill_ms / 1e3),
         "peak_bytes": peak, "allocated_before_bytes": before,
         "launches": launches}
    print("  (a) generate " + json.dumps(a))
    print(f"  first tokens {toks[:, :8].tolist()}")
    if launches != {"ssd_chunks": n_mamba, "swa_attention": n_attn}:
        raise AssertionError(f"launches in the prefill {launches}, not "
                             f"{n_mamba} ssd_chunks and {n_attn} "
                             "swa_attention")
    if toks.shape != (B, NEW) or not bool(torch.isfinite(logits).all()):
        raise AssertionError("generate gave a bad shape or non-finite logits")
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError("token ids out of the vocabulary")
    # where the time goes: the same call traced (8 new tokens), with
    # events around each SSD scan and its kernel
    scan_events, undo = _scan_events()
    try:
        prof = _profile_generate(generate, timed, params, prompts, BUF, 8)
    finally:
        undo()
    scan_ms = sum(a.elapsed_time(b) for a, b in scan_events["scan"])
    kernel_ms = sum(a.elapsed_time(b) for a, b in scan_events["kernel"])
    traced_prefill = events["prefill"][-1][0].elapsed_time(
        events["prefill"][-1][1])
    prof["prefill_ms"] = traced_prefill
    prof["ssd_scans"] = len(scan_events["scan"])
    prof["ssd_scan_ms"] = scan_ms
    prof["ssd_kernel_ms"] = kernel_ms
    prof["ssd_glue_ms"] = scan_ms - kernel_ms
    prof["ssd_kernel_share_of_prefill"] = kernel_ms / traced_prefill
    prof["ssd_glue_share_of_prefill"] = (scan_ms - kernel_ms) / traced_prefill
    prof["swa_share_of_prefill"] = prof["swa_ms"] / traced_prefill
    print("  (a) profile " + json.dumps(prof))

    # (b) one prompt in chunks of 512: ssm and conv states carried
    swa.reset_launches()
    mk.reset_launches()
    states, start = model.make_state(params, {"tokens": prompts[:1]}, BUF)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for j in range(0, SERVE_S, 512):
        lg, states = model.prefill_chunk(params, states,
                                         prompts[:1, j:j + 512], start + j)
    e1.record()
    torch.cuda.synchronize()
    n_chunks = -(-SERVE_S // 512)
    diff = float((lg[0] - logits[0]).abs().max())
    print(f"  (b) chunked prefill (512): {e0.elapsed_time(e1):.1f} ms, "
          f"ssd launches {mk.LAUNCHES['ssd_chunks']}, swa launches "
          f"{swa.LAUNCHES['swa_attention']}, max |last-token logits - "
          f"(a)'s| {diff:.4f} (information; logits scale "
          f"{float(logits[0].abs().max()):.2f})")
    if (mk.LAUNCHES["ssd_chunks"] != n_mamba * n_chunks
            or swa.LAUNCHES["swa_attention"] != n_attn):
        raise AssertionError("the chunks did not run the kernels")
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError("non-finite chunked-prefill logits")
    del params, states, timed, model, lg, logits, toks
    torch.cuda.empty_cache()

    # (c) the continuous-batching launcher at full size
    swa.reset_launches()
    mk.reset_launches()
    # prompts of 256 / 512 / 1024 / 256 / 512 tokens: each ends in a
    # 64-token tail fed one token per decode step, as the reference's
    # scheduler does; 5 requests (cut from 8 for time) so that one is
    # admitted mid-stream
    report = serve_main(["--arch", "zamba2-7b", "--requests", "5",
                         "--max-slots", "4", "--prompt-len", "512",
                         "--new-tokens", "16", "--chunk", "64"])
    c = {"steps": report.steps, "generated": report.generated,
         "occupancy": report.occupancy, "wall_s": report.wall_s,
         "tok_s": report.tok_s, "ttft_mean_ms": report.ttft_mean_s * 1e3,
         "ssd_launches": mk.LAUNCHES["ssd_chunks"],
         "swa_launches": swa.LAUNCHES["swa_attention"]}
    print("  (c) launcher " + json.dumps(c))
    if sorted(report.results) != list(range(5)) or any(
            len(r.tokens) != 16 for r in report.results.values()):
        raise AssertionError("the launcher left requests unfinished")
    if mk.LAUNCHES["ssd_chunks"] == 0 or swa.LAUNCHES["swa_attention"] == 0:
        raise AssertionError("the launcher launched no ssd_chunks or "
                             "swa_attention")
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 9: the sLSTM kernel
# ---------------------------------------------------------------------------

def _slstm_inputs(B, T, H, P, gen, carried=False, forget_bias=0.0):
    """g_in (unit normal, every head's forget block shifted by
    ``forget_bias``), R (the model's init scale P^-1/2) and a fresh or
    carried state."""
    g = torch.randn((B, T, H, 4 * P), generator=gen, device="cuda")
    g[..., 2 * P:3 * P] += forget_bias
    R = torch.randn((H, P, 4 * P), generator=gen, device="cuda") * P ** -0.5
    shape = (B, H, P)
    if carried:
        st = (torch.randn(shape, generator=gen, device="cuda"),
              torch.rand(shape, generator=gen, device="cuda") + 0.5,
              torch.randn(shape, generator=gen, device="cuda") * 0.3,
              torch.randn(shape, generator=gen, device="cuda"))
    else:
        z = torch.zeros(shape, device="cuda")
        st = (z, z + 1e-6, z.clone(), z - 1e30)
    return g, R, st


def _slstm_model_inputs(B, T, gen):
    """The serving shape on the model's own gates: a seeded xlstm-350m
    sLSTM block (bf16, its init), a random prompt's block input x, and
    g_in = xi @ w_gates + b_gates reshaped head-major as
    ``models/xlstm.py::slstm_forward`` does; R is the block's r_gates."""
    from repro_torch.configs import get_arch
    from repro_torch.models import xlstm
    from repro_torch.models.layers import rms_norm
    cfg = get_arch("xlstm-350m")
    d_in, H, P = xlstm.dims(cfg)
    p = xlstm.init_slstm(gen, cfg, torch.bfloat16, device="cuda")
    x = torch.randn((B, T, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    xi = (rms_norm(x, p["ln"], cfg.norm_eps) @ p["w_up"])[..., :d_in]
    g = (xi.to(torch.float32) @ p["w_gates"].to(torch.float32)
         + p["b_gates"]).view(B, T, H, 4 * P)
    st = xlstm.init_slstm_state(cfg, B, device="cuda")
    return g, p["r_gates"], st


def _slstm_head_rel(got, want, head):
    """Largest error relative to its scale over h and the four final-state
    tensors, restricted to one head."""
    (h, st), (wh, wst) = got, want
    pairs = [(h[:, :, head], wh[:, :, head])] + [
        (a[:, head], b[:, head]) for a, b in zip(st, wst)]
    return max(err / scale for err, scale in (
        _rel_err(a.double(), b.double()) for a, b in pairs))


def _slstm_errs(got, want):
    """[(max abs err, scale)] of h and the four final-state tensors."""
    (h, st), (wh, wst) = got, want
    return [_rel_err(a.double(), b.double())
            for a, b in zip((h,) + tuple(st), (wh,) + tuple(wst))]


def _slstm_bound(B, T, H, P):
    """Least time in ms: 2 B T H P 4P FLOP for h @ R over the fp32 peak,
    or g_in, R and the state read once and h and the final state written
    once over the memory rate, whichever is larger."""
    flops = 2 * B * T * H * P * 4 * P
    nbytes = 4 * (B * T * H * 4 * P + H * P * 4 * P + B * T * H * P
                  + 8 * B * H * P)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), t_bytes, t_ops, flops


def _device_ms(fn, reps=20, sleep_cycles=20_000_000):
    """Mean device time in ms of ``reps`` back-to-back calls of ``fn``:
    queued behind a sleep kernel (~10 ms), so that the host has enqueued
    them all before the first runs. At T = 1 a call's host cost exceeds
    its kernel's, and CUDA events around each call would time the host."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _slstm_layout(sk):
    """The kernel's geometry at each head dim (B = 4), the card's count of
    resident clusters, ptxas's registers and spills; fails if the P = 512
    instance spills."""
    from repro_torch.kernels import _build
    geo = {P: dataclasses.asdict(sk.geometry(P, 4)) for P in sk.HEAD_DIMS}
    for P, row in geo.items():
        row["max_active_clusters"] = sk.max_active_clusters(P)
    print("  geometry (B = 4) and cudaOccupancyMaxActiveClusters: "
          + json.dumps(geo))
    regs = _ptxas_report(_build.build_info["slstm_step"]["log"],
                         ("slstm_cluster_kernel",
                          "slstm_exchange_probe_kernel"))
    print("  ptxas (registers, spill store / load bytes) " + json.dumps(regs))
    big = regs.get("slstm_cluster_kernel<512>")
    if big is None or big[1] or big[2]:
        raise AssertionError(f"slstm_cluster_kernel<512> spills or is "
                             f"missing from the ptxas report: {big}")
    need = SLSTM_SLICE[2] * -(-SLSTM_SLICE[0] // sk.G)
    if geo[512]["max_active_clusters"] < need:
        raise AssertionError(f"{need} clusters of 16 needed at once, the "
                             f"card holds {geo[512]['max_active_clusters']}")
    return geo, regs


def phase_slstm(sk, sref):
    gen = torch.Generator(device="cuda").manual_seed(9)
    errs = []
    geo, regs = _slstm_layout(sk)
    def check_cases(cases):
        for B, T, H, P, carried in cases:
            g, R, st = _slstm_inputs(B, T, H, P, gen, carried)
            got = sk.slstm_steps(g, R, st)
            torch.cuda.synchronize()
            e = _slstm_errs(got, sref.slstm_steps_ref(g, R, st))
            errs.extend(e)
            worst = max(err / scale for err, scale in e)
            print(f"  checked {(B, T, H, P)} carried={carried}: max rel "
                  f"err {worst:.3e}")
            if not worst <= TOL:
                raise AssertionError(f"slstm_steps {(B, T, H, P)}: max rel "
                                     f"err {worst:.3e} > {TOL}")

    with torch.no_grad():
        check_cases(SLSTM_CASES)
        # the serving shape on the model's own gates, head by head, twice
        B, T, H, P = SLSTM_SLICE
        g, R, st = _slstm_model_inputs(B, T, gen)
        k32 = sk.slstm_steps(g, R, st)
        again = sk.slstm_steps(g, R, st)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(
            (k32[0],) + tuple(k32[1]), (again[0],) + tuple(again[1])))
        print(f"  serving shape, the model's gates: two launches bit-equal "
              f"{same}")
        if not same:
            raise AssertionError("two slstm_steps launches on the same "
                                 "inputs differ")
        p32 = sref.slstm_steps_ref(g, R, st)
        p64 = sref.slstm_steps_ref(g.double(), R.double(),
                                   tuple(t.double() for t in st))
        heads = []
        for hd in range(H):
            f_bias = float(g[..., hd, 2 * P:3 * P].mean())
            row = {"head": hd, "mean_forget_preact": f_bias,
                   "kernel_vs_plain32": _slstm_head_rel(k32, p32, hd),
                   "plain32_vs_plain64": _slstm_head_rel(p32, p64, hd)}
            row["bar"] = max(TOL, 2 * row["plain32_vs_plain64"])
            heads.append(row)
            print("  serving shape, the model's gates, head " + json.dumps(
                row))
            if not row["kernel_vs_plain32"] <= row["bar"]:
                raise AssertionError(
                    f"slstm_steps head {hd}: rel err "
                    f"{row['kernel_vs_plain32']:.3e} > {row['bar']:.3e}")
        # the same gates over one chunk's steps (a strided view), before
        # 4096 chaotic steps amplify rounding: every head within TOL
        gc = g[:, :SLSTM_CHUNK]
        e = _slstm_errs(sk.slstm_steps(gc, R, st),
                        sref.slstm_steps_ref(gc, R, st))
        worst = max(err / scale for err, scale in e)
        print(f"  the model's gates, first {SLSTM_CHUNK} steps: max rel err "
              f"{worst:.3e}")
        if not worst <= TOL:
            raise AssertionError(f"slstm_steps on the model's gates, "
                                 f"{SLSTM_CHUNK} steps: max rel err "
                                 f"{worst:.3e} > {TOL}")
        errs += e
        ms = _time_ms(lambda: sk.slstm_steps(g, R, st))
        plain_ms = _time_ms(lambda: sref.slstm_steps_ref(g, R, st), reps=3,
                            warm=1)
        del g, R, st, k32, again, p32, p64
        # a forget bias of 3 on every head: not the model's layout
        g, R, st = _slstm_inputs(B, T, H, P, gen, forget_bias=FORGET_BIAS)
        got = sk.slstm_steps(g, R, st)
        torch.cuda.synchronize()
        e = _slstm_errs(got, sref.slstm_steps_ref(g, R, st))
        errs += e
        worst = max(err / scale for err, scale in e)
        print(f"  checked the serving shape {SLSTM_SLICE}, forget bias "
              f"{FORGET_BIAS} on every head (not the model's layout): max "
              f"rel err {worst:.3e} ([abs, scale] of h, c, n, h_T, m: "
              f"{json.dumps(e)})")
        if not worst <= TOL:
            raise AssertionError(f"slstm_steps serving shape: max rel err "
                                 f"{worst:.3e} > {TOL}")
        del got, g, R, st
        check_cases(SLSTM_MORE_CASES)
        # the three shapes of the main path: CUDA events around a call and
        # the kernel's device time (profiler)
        shapes = {}
        for name, shape in SLSTM_TIMED.items():
            g, R, st = _slstm_inputs(*shape, gen)
            run = lambda: sk.slstm_steps(g, R, st)  # noqa: E731
            row = {"shape": list(shape), "events_ms": _time_ms(run),
                   "device_ms": _device_ms(run),
                   "bound_ms": _slstm_bound(*shape)[0]}
            row["us_per_step"] = row["device_ms"] / shape[1] * 1e3
            row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
            shapes[name] = row
            print(f"  {name} {shape}: {row['device_ms']:.4f} ms on the "
                  f"device ({row['events_ms']:.4f} ms in events), "
                  f"{row['us_per_step']:.3f} us a step, "
                  f"{row['share_of_bound']:.1%} of the bound")
            del g, R, st
        # what a step pays to pass h around, without arithmetic
        exchange = {}
        for mode, what in enumerate(sk.EXCHANGES):
            t_ms = _time_ms(lambda: sk.exchange_probe(H, T, mode))
            exchange[what] = t_ms / T * 1e3
        print("  h exchange alone, us a step at the serving geometry "
              f"(H = {H}, T = {T}): " + json.dumps(exchange))
    bound, bound_by, t_bytes, t_ops, flops = _slstm_bound(B, T, H, P)
    row = {"name": "slstm_steps", "route": "cuda", "source": SLSTM_SOURCE,
           "replaces": SLSTM_REPLACES, "launches": 0,
           "max_abs_err": max(e for e, _ in errs),
           "max_rel_err": max(e / s for e, s in errs), "tol_rel": TOL,
           "shape": [B, T, H, P], "ms": ms, "ms_per_step": ms / T,
           "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
           "bound_ms_bytes": t_bytes, "bound_ms_fp32_ops": t_ops,
           "flops": flops, "library_ms": None,
           "library_note": "no single PyTorch call computes the sLSTM "
                           "recurrence",
           "model_gates_by_head": heads, "shapes": shapes,
           "exchange_us_per_step": exchange,
           "geometry": geo[P], "ptxas": regs}
    print("  slstm_steps " + json.dumps(row))
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# phase 10: serving xlstm-350m
# ---------------------------------------------------------------------------

def _xlstm_route_checks(sk, cfg):
    """(0) At full width in fp32: one sLSTM block's kernel route (no
    gradient recorded) against its plain route (a gradient recorded), S =
    1024 after a 256-token prefix that leaves a carried state; one mLSTM
    block's chunked form (256) against its per-step one, S = 512. Outputs
    and new states within 1e-4 of their scale."""
    from repro_torch.models import xlstm
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {}

    def check(name, got, want):
        err, scale = _rel_err(got, want.detach())
        out[name] = [err, scale]
        if not err <= 1e-4 * scale:
            raise AssertionError(f"xlstm route check {name}: {err:.3e} > "
                                 f"1e-4 x {scale:.3e}")
    p = xlstm.init_slstm(gen, cfg, torch.float32, device="cuda")
    x = torch.randn((1, 1280, cfg.d_model), generator=gen, device="cuda")
    state = xlstm.init_slstm_state(cfg, 1, device="cuda")
    before = sk.LAUNCHES["slstm_steps"]
    with torch.no_grad():
        xlstm.slstm_forward(p, x[:, :256], cfg, state)
        plain_state = tuple(t.clone() for t in state)
        got, _ = xlstm.slstm_forward(p, x[:, 256:], cfg, state)
    if sk.LAUNCHES["slstm_steps"] != before + 2:
        raise AssertionError("the sLSTM kernel route was not taken")
    with torch.enable_grad():
        want, _ = xlstm.slstm_forward(
            p, x[:, 256:].clone().requires_grad_(True), cfg, plain_state)
    if sk.LAUNCHES["slstm_steps"] != before + 2:
        raise AssertionError("the sLSTM plain route launched the kernel")
    check("slstm out", got, want)
    for name, a, b in zip("cnhm", state, plain_state):
        check(f"slstm {name}", a, b)

    p = xlstm.init_mlstm(gen, cfg, torch.float32, device="cuda")
    x = torch.randn((1, 512, cfg.d_model), generator=gen, device="cuda")
    with torch.no_grad():
        want, st_w = xlstm.mlstm_forward(
            p, x, dataclasses.replace(cfg, xlstm_chunk=0))
        got, st_g = xlstm.mlstm_forward(
            p, x, dataclasses.replace(cfg, xlstm_chunk=256))
    check("mlstm out", got, want)
    for name, a, b in zip(("C", "n", "m"), st_g, st_w):
        check(f"mlstm {name}", a, b)
    print("  (0) full width, fp32: sLSTM kernel route vs plain (S=1024, "
          "carried state), mLSTM chunked (256) vs per-step (S=512): "
          "[max abs err, scale] " + json.dumps(out))


def _count_launches(model, names, counter):
    """The model with the kernel launches of each call of the named lanes
    recorded (``counter()`` reads the launch count)."""
    counts = {n: [] for n in names}

    def wrap(name, fn):
        def run(*a, **kw):
            before = counter()
            out = fn(*a, **kw)
            counts[name].append(counter() - before)
            return out
        return run
    return dataclasses.replace(model, **{n: wrap(n, getattr(model, n))
                                         for n in names}), counts


def phase_xlstm(sk):
    from repro_torch.configs import get_arch
    from repro_torch.core.engine import tree_items
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import build_model
    from repro_torch.serving import generate

    published = get_arch("xlstm-350m")
    _xlstm_route_checks(sk, dataclasses.replace(published, dtype="float32"))
    torch.cuda.empty_cache()

    # the one-shot prefill runs the chunked mLSTM (the reference's "opt"
    # setting): the per-step form makes about 15 launches per token and
    # layer
    cfg = dataclasses.replace(published, xlstm_chunk=256)
    B, S, NEW = 4, 4096, 32
    BUF = S + NEW
    n_slstm = cfg.blocks().count("slstm")
    n_mlstm = cfg.blocks().count("mlstm")
    print(f"  config {cfg.name}: d_model {cfg.d_model}, layers "
          f"{cfg.n_layers} ({n_mlstm} mlstm, {n_slstm} slstm), heads "
          f"{cfg.ssm_heads}, d_in {cfg.ssm_expand * cfg.d_model}, vocab "
          f"{cfg.vocab_size}, tied {cfg.tie_embeddings}, dtype {cfg.dtype}, "
          f"xlstm_chunk {cfg.xlstm_chunk}; B={B} S={S} new={NEW}")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    n = sum(leaf.numel() for _, leaf in tree_items(params))
    print(f"  parameters {n} (param_count() says {cfg.param_count()}: it "
          "undercounts xLSTM blocks, ROADMAP Queue 3)")
    if n != XLSTM_PARAMS:
        raise AssertionError(f"xlstm-350m has {n} parameters, not "
                             f"{XLSTM_PARAMS}")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S))).cuda()

    # (a) the main path: generate, counters zeroed just before
    timed, events = _events_of(model, ("prefill", "decode_step"))
    counted, per_call = _count_launches(
        timed, ("prefill", "decode_step"),
        lambda: sk.LAUNCHES["slstm_steps"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    sk.reset_launches()
    t0 = time.perf_counter()
    toks, logits = generate(counted, params, {"tokens": prompts},
                            max_new_tokens=NEW, buf_len=BUF)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sk.LAUNCHES["slstm_steps"]
    peak = torch.cuda.max_memory_allocated()
    prefill_ms = events["prefill"][0][0].elapsed_time(events["prefill"][0][1])
    dec = [a.elapsed_time(b) for a, b in events["decode_step"]]
    a = {"prefill_ms": prefill_ms, "ttft_ms": prefill_ms,
         "decode_ms_per_token": statistics.mean(dec),
         "decode_ms_median": statistics.median(dec),
         "wall_s": wall, "tok_s": B * NEW / wall,
         "prefill_tok_s": B * S / (prefill_ms / 1e3),
         "peak_bytes": peak, "allocated_before_bytes": before,
         "slstm_launches": launches,
         "slstm_launches_prefill": per_call["prefill"],
         "slstm_launches_per_decode_step": sorted(set(
             per_call["decode_step"]))}
    print("  (a) generate " + json.dumps(a))
    print(f"  first tokens {toks[:, :8].tolist()}")
    if per_call["prefill"] != [n_slstm] or set(
            per_call["decode_step"]) != {n_slstm}:
        raise AssertionError(f"slstm_steps launches {per_call}: not "
                             f"{n_slstm} per prefill and per decode step")
    if launches != n_slstm * NEW:
        raise AssertionError(f"slstm_steps launched {launches} times, not "
                             f"{n_slstm * NEW}")
    if toks.shape != (B, NEW) or not bool(torch.isfinite(logits).all()):
        raise AssertionError("generate gave a bad shape or non-finite logits")
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError("token ids out of the vocabulary")
    # where the time goes: the same call traced, with 8 new tokens
    prof = _profile_generate(generate, timed, params, prompts, BUF, 8,
                             prefill_kernel=("slstm", n_slstm))
    prof["prefill_ms"] = events["prefill"][-1][0].elapsed_time(
        events["prefill"][-1][1])
    prof["slstm_share_of_prefill"] = (prof["slstm_prefill_ms"]
                                      / prof["prefill_ms"])
    print("  (a) profile " + json.dumps(prof))
    print(f"  (a) slstm kernels: {prof['slstm_prefill_ms']:.2f} ms of the "
          f"traced prefill's {prof['prefill_ms']:.2f} "
          f"({prof['slstm_share_of_prefill']:.1%}), "
          f"{prof['slstm_kernels']} launches in the traced call (of "
          f"{n_slstm * 8} launched)")

    # (b) one prompt in chunks of 512: the recurrent states carried
    sk.reset_launches()
    states, start = model.make_state(params, {"tokens": prompts[:1]}, BUF)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for j in range(0, S, 512):
        lg, states = model.prefill_chunk(params, states,
                                         prompts[:1, j:j + 512], start + j)
    e1.record()
    torch.cuda.synchronize()
    n_chunks = -(-S // 512)
    diff = float((lg[0] - logits[0]).abs().max())
    print(f"  (b) chunked prefill (512): {e0.elapsed_time(e1):.1f} ms, "
          f"slstm launches {sk.LAUNCHES['slstm_steps']}, max |last-token "
          f"logits - (a)'s| {diff:.4f} (information; logits scale "
          f"{float(logits[0].abs().max()):.2f})")
    if sk.LAUNCHES["slstm_steps"] != n_slstm * n_chunks:
        raise AssertionError("the chunks did not run the kernel")
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError("non-finite chunked-prefill logits")
    m_max = {kind: max(float(states["cycle"][f"b{j}"][-1].abs().max())
                       for j, k in enumerate(cfg.layer_pattern) if k == kind)
             for kind in ("mlstm", "slstm")}
    del params, states, timed, counted, model, lg, logits, toks
    torch.cuda.empty_cache()
    # (information) the same one-shot / chunked comparison in fp32, at two
    # prompt lengths: how far rounding alone carries the two apart through
    # 24 random-weight layers while the stabilisers m grow with the length
    model = build_model(dataclasses.replace(cfg, dtype="float32"))
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    gap = {"max_abs_m_after_b": m_max}
    for L in (1024, S):
        one, _ = model.prefill(params, {"tokens": prompts[:1, :L]}, BUF)
        states, _ = model.make_state(params, {"tokens": prompts[:1]}, BUF)
        for j in range(0, L, 512):
            lg, states = model.prefill_chunk(params, states,
                                             prompts[:1, j:j + 512], j)
        gap[f"fp32_len{L}"] = [float((lg - one).abs().max()),
                               float(one.abs().max())]
        del states
    print("  (b) information: [max |one-shot - chunked| logits, scale] "
          + json.dumps(gap))
    del params, model, one, lg
    torch.cuda.empty_cache()

    # (c) the launcher on the published config (xlstm_chunk = 0, the
    # per-step mLSTM) at full size: prompts of 256 / 512 / 1024 / 256 /
    # 512 tokens in chunks of 64, each ending in a 64-token tail fed one
    # token per decode step; 5 requests, so that one is admitted
    # mid-stream, and no more: a 64-token chunk of the per-step mLSTM
    # makes about 15 launches per token and layer
    sk.reset_launches()
    report = serve_main(["--arch", "xlstm-350m", "--requests", "5",
                         "--max-slots", "4", "--prompt-len", "512",
                         "--new-tokens", "16", "--chunk", "64"])
    c = {"steps": report.steps, "generated": report.generated,
         "occupancy": report.occupancy, "wall_s": report.wall_s,
         "tok_s": report.tok_s, "ttft_mean_ms": report.ttft_mean_s * 1e3,
         "slstm_launches": sk.LAUNCHES["slstm_steps"]}
    print("  (c) launcher " + json.dumps(c))
    if sorted(report.results) != list(range(5)) or any(
            len(r.tokens) != 16 for r in report.results.values()):
        raise AssertionError("the launcher left requests unfinished")
    if sk.LAUNCHES["slstm_steps"] == 0:
        raise AssertionError("the launcher launched no slstm_steps")
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 11: the tree path's pair, sq_dist and apply_update
# ---------------------------------------------------------------------------

def _bf16_ulp(t):
    """One bf16 ulp (8 significant bits) at each entry's magnitude."""
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def _pair_inputs(n, xd, ad, gen):
    x = torch.randn((n,), generator=gen, device="cuda").to(xd)
    a = torch.randn((n,), generator=gen, device="cuda").to(ad)
    return x, a


def _check_pair(pk, ref, name, x, a, coef, errs, what):
    """One kernel against its plain version; sq_dist within
    SQ_DIST_RTOL, twice with the same bits; apply_update within 1e-6
    (fp32) or one bf16 ulp of each entry (bf16)."""
    if name == "sq_dist":
        got, again = pk.sq_dist(x, a), pk.sq_dist(x, a)
        torch.cuda.synchronize()
        want = ref.sq_dist_plain(x, a)
        if not torch.equal(got, again):
            raise AssertionError(f"sq_dist {what}: two calls differ")
        err = abs(float(got) - float(want))
        rel = err / max(abs(float(want)), 1e-30)
        ok = rel <= SQ_DIST_RTOL
    else:
        got = pk.apply_update(x, a, coef)
        torch.cuda.synchronize()
        want = ref.apply_plain(x, a, coef)
        d = (got.float() - want.float()).abs()
        err = float(d.max())
        rel = err / max(float(want.float().abs().max()), 1e-30)
        bar = _bf16_ulp(want) if x.dtype == torch.bfloat16 else 1e-6
        ok = bool((d <= bar).all())
        del d
    errs[name] = (max(errs[name][0], err), max(errs[name][1], rel))
    if not ok:
        raise AssertionError(f"{name} {what}: err {err:.3e} (rel "
                             f"{rel:.3e}) over its bar")
    return err


def phase_pair(pk, ref):
    gen = torch.Generator(device="cuda").manual_seed(11)
    errs = {k: (0.0, 0.0) for k in PAIR_REPLACES}
    coef = torch.tensor([0.1 - 0.5 / 3.0], device="cuda")
    for name, ns in PAIR_N.items():
        for xd, ad in PAIR_DTYPES:
            for n in ns:
                x, a = _pair_inputs(n, xd, ad, gen)
                _check_pair(pk, ref, name, x, a, coef, errs,
                            f"n={n} {xd}/{ad}")
        # a stacked leaf's row at an odd element offset (element-wise path)
        leaf = torch.randn((4, 40001), generator=gen,
                           device="cuda").to(torch.bfloat16)
        c = torch.randn((40001,), generator=gen, device="cuda")
        _check_pair(pk, ref, name, leaf[1], c, coef, errs, "odd offset")
        print(f"  {name}: checked the test cases and an odd offset")
    rows = {}
    for name in PAIR_REPLACES:
        timing = {}
        for n in PAIR_SLICE_N:
            for xd, ad in ((torch.bfloat16, torch.float32),
                           (torch.float32, torch.float32)):
                x, a = _pair_inputs(n, xd, ad, gen)
                err = _check_pair(pk, ref, name, x, a, coef, errs,
                                  f"n={n} {xd}/{ad}")
                out = torch.empty_like(x)
                if name == "sq_dist":
                    kern = lambda: pk.sq_dist(x, a)
                    plain = lambda: ref.sq_dist_plain(x, a)
                    lib = lambda: torch.dist(x, a) ** 2
                    nbytes = n * (x.element_size() + a.element_size())
                else:
                    kern = lambda: pk.apply_update(x, a, coef, out=out)
                    plain = lambda: ref.apply_plain(x, a, coef, out=out)
                    lib = lambda: torch.lerp(x, a, coef, out=out)
                    nbytes = n * (2 * x.element_size() + a.element_size())
                key = f"{n} {str(xd)[6:]}/{str(ad)[6:]}"
                timing[key] = {
                    "ms": _time_ms(kern), "plain_ms": _time_ms(plain),
                    "library_ms": _time_ms(lib) if xd == ad else None,
                    "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                    "bytes": nbytes, "max_abs_err": err}
                print(f"  {name} {key}: " + json.dumps(timing[key]))
                del x, a, out
                torch.cuda.empty_cache()
        n = PAIR_SLICE_N[0]
        head = timing[f"{n} bfloat16/float32"]
        same = timing[f"{n} float32/float32"]
        rows[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": PAIR_REPLACES[name], "launches": 0,
            "max_abs_err": errs[name][0], "max_rel_err": errs[name][1],
            "tol_rel": SQ_DIST_RTOL if name == "sq_dist" else
            "1e-6 abs fp32, one bf16 ulp bf16",
            # the headline: the tree path's bf16 leaf against the fp32
            # center at the largest leaf; one PyTorch call computes the
            # function only on inputs of one dtype, so library_ms is the
            # fp32 / fp32 case's, beside that case's own kernel time
            "shape": [n], "dtypes": "bfloat16/float32", "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": "bytes", "library_ms": same["library_ms"],
            "library_call": ("torch.dist(x, a) ** 2" if name == "sq_dist"
                             else "torch.lerp(x, a, coef, out=out)"),
            "ms_fp32": same["ms"], "bound_ms_fp32": same["bound_ms"],
            "timings": timing}
    return rows


# ---------------------------------------------------------------------------
# phase 12: the tree path, yi-6b at full width
# ---------------------------------------------------------------------------

def _timed_rounds(trainer_mod, step, box, batches, label):
    """Run ``step`` over ``batches`` from the state in the one-element list
    ``box`` (taken out of it, so that no caller keeps a round's input
    alive), with CUDA events around each ``apply_round``; print and return
    the last state and each round's numbers."""
    state = box.pop()
    apply_round = trainer_mod.consensus.apply_round
    events = []

    def timed_apply_round(*a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = apply_round(*a, **kw)
        e1.record()
        events.append((e0, e1))
        return out

    trainer_mod.consensus.apply_round = timed_apply_round
    rounds = []
    try:
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b())
            torch.cuda.synchronize()
            round_ms = (time.perf_counter() - t0) * 1e3
            cons_ms = events[-1][0].elapsed_time(events[-1][1])
            row = {"round": state.round - 1, "loss": float(m["train_loss"]),
                   "consensus_dist": float(m["consensus_dist"]),
                   "round_ms": round_ms, "consensus_ms": cons_ms,
                   "local_ms": round_ms - cons_ms,
                   "peak_bytes": torch.cuda.max_memory_allocated()}
            rounds.append(row)
            print(f"  {label} round " + json.dumps(row))
    finally:
        trainer_mod.consensus.apply_round = apply_round
    return state, rounds


def _plain_round(core_pp, ref, stacked):
    """One Eq. 5 round on ``ref.py``'s plain functions in place of the
    kernels."""
    kernels = core_pp.sq_dist, core_pp.apply_update
    core_pp.sq_dist, core_pp.apply_update = ref.sq_dist_plain, ref.apply_plain
    try:
        return core_pp.pullpush(stacked, 0.1, 0.5)[0], \
            core_pp.worker_dists(stacked)
    finally:
        core_pp.sq_dist, core_pp.apply_update = kernels


def phase_tree(pk, ref):
    from repro_torch.configs import DPPFConfig, get_arch
    from repro_torch.core import consensus
    from repro_torch.core import pullpush as core_pp
    from repro_torch.core.engine import tree_items
    from repro_torch.data import TokenTask, make_round_batch
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.train import (
        RoundClock, init_train_state, make_round_step,
    )
    import repro_torch.train.trainer as trainer_mod

    cfg = dataclasses.replace(get_arch("yi-6b"), n_layers=LAYERS)
    M, tau, steps, seq, batch = 4, 4, 16, 64, 8
    model = build_model(cfg)
    dcfg = DPPFConfig(alpha=0.1, lam=0.5, tau=tau, consensus="simple_avg",
                      engine="tree")
    opt = make_optimizer("sgd", momentum=0.9, weight_decay=1e-3)
    clock = RoundClock.from_config(dcfg, base_lr=LR, total_steps=steps)
    task = TokenTask(vocab_size=cfg.vocab_size, seq_len=seq)
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(f"  config {cfg.name}: layers {cfg.n_layers}, dtype {cfg.dtype}, "
          f"engine tree; M={M} tau={tau} steps={steps} seq={seq} "
          f"batch={batch} lr={LR}")

    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model.init, opt, dcfg, M, gen, device="cuda")
    leaves = tree_items(state.params)
    n = sum(leaf[0].numel() for _, leaf in leaves)
    if state.engine is not None or n != cfg.param_count():
        raise AssertionError(f"tree state: engine {state.engine}, {n} "
                             f"parameters, param_count() "
                             f"{cfg.param_count()}")
    L = len(leaves)
    print(f"  stacked tree: {L} leaves, {n} parameters a worker, dtypes "
          f"{sorted({str(leaf.dtype) for _, leaf in leaves})}")
    step = make_round_step(model.loss, opt, dcfg, clock=clock)
    batches = [lambda spec=spec: make_round_batch(
        task, 0, M, spec.tau, spec.start, batch, cfg, device="cuda")
        for spec in clock.rounds]
    box = [state]
    del state, leaves           # each round's input goes with its round
    pk.reset_launches()                     # main path: counts from here
    state, rounds = _timed_rounds(trainer_mod, step, box, batches,
                                  "simple_avg")
    eq5 = {k: pk.LAUNCHES[k] for k in PAIR_REPLACES}
    print(f"  launches over {len(rounds)} Eq. 5 rounds {json.dumps(eq5)}")
    want = {k: M * L * len(rounds) for k in PAIR_REPLACES}
    if eq5 != want:
        raise AssertionError(f"Eq. 5 rounds launched {eq5}, want {want}")
    if not all(math.isfinite(r["loss"]) for r in rounds):
        raise AssertionError("non-finite training loss")
    if not all(r["consensus_dist"] > 0 for r in rounds[1:]):
        raise AssertionError("consensus_dist is 0 after round 0")

    # one easgd round: the center state, a pull, then a push
    edcfg = dataclasses.replace(dcfg, consensus="easgd")
    eclock = RoundClock.from_config(edcfg, base_lr=LR,
                                    total_steps=steps + tau)
    estep = make_round_step(model.loss, opt, edcfg, clock=eclock)
    spec = eclock.rounds[state.round]
    box = [dataclasses.replace(
        state, cstate=consensus.init_state("easgd", state.params))]
    del state
    pk.reset_launches()
    state, erounds = _timed_rounds(
        trainer_mod, estep, box, [lambda: make_round_batch(
            task, 0, M, spec.tau, spec.start, batch, cfg, device="cuda")],
        "easgd")
    ez = {k: pk.LAUNCHES[k] for k in PAIR_REPLACES}
    print(f"  launches in the easgd round {json.dumps(ez)}")
    if ez != {"sq_dist": 3 * M * L, "apply_update": M * L}:
        raise AssertionError(f"easgd round launched {ez}")
    peak = torch.cuda.max_memory_allocated()
    print(f"  peak memory allocated {peak} bytes ({peak / 1e9:.2f} GB)")
    if peak > 70e9:
        raise AssertionError(f"peak memory {peak / 1e9:.1f} GB > 70 GB")
    later = rounds[1:] or rounds
    print("  mean of Eq. 5 rounds 1.. " + json.dumps({
        k: statistics.mean(r[k] for r in later)
        for k in ("round_ms", "consensus_ms", "local_ms")}))

    # one Eq. 5 round on the kernels against the plain functions
    stacked = state.params
    del state, step, estep
    torch.cuda.empty_cache()
    pk.reset_launches()
    new_k, _ = core_pp.pullpush(stacked, 0.1, 0.5)
    r_k = core_pp.worker_dists(stacked)
    kernel_launches = dict(pk.LAUNCHES)
    new_p, r_p = _plain_round(core_pp, ref, stacked)
    if dict(pk.LAUNCHES) != kernel_launches:
        raise AssertionError("the plain round launched a kernel")
    r_rel = float(((r_k - r_p).abs() / r_p).max())
    center = core_pp.tree_mean0(stacked)
    sq_rel = 0.0
    for (_, a), (_, c) in zip(tree_items(stacked), tree_items(center)):
        for row in a.view(M, -1):
            want = float(ref.sq_dist_plain(row, c.view(-1)))
            got = float(pk.sq_dist(row, c.view(-1)))
            sq_rel = max(sq_rel, abs(got - want) / want)
    del center
    worst, flips = 0.0, 0
    for (path, k), (_, p) in zip(tree_items(new_k), tree_items(new_p)):
        for m in range(M):
            d = (k[m].float() - p[m].float()).abs()
            u = _bf16_ulp(p[m])
            worst = max(worst, float((d / u).max()))
            flips += int((d > 0).sum())
            del d, u
    print(f"  kernel round vs plain round: r max rel err {r_rel:.3e} "
          f"(per (worker, leaf) sums of squares {sq_rel:.3e}), leaves max "
          f"err {worst:.3f} bf16 ulp, {flips} entries differ")
    if not (r_rel <= 1e-5 and sq_rel <= SQ_DIST_RTOL and worst <= 1.0):
        raise AssertionError("the kernel round differs from the plain one")
    del new_k, new_p, stacked
    torch.cuda.empty_cache()
    return {"eq5": eq5, "easgd": ez, "rounds": rounds, "easgd_round":
            erounds, "peak_bytes": peak, "plain_round_r_rel": r_rel,
            "plain_round_sq_rel": sq_rel, "plain_round_ulp": worst}


# ---------------------------------------------------------------------------
# phase 13: the overlap modes
# ---------------------------------------------------------------------------

def _expected_launches(dcfg, r, launch_names):
    """The kernel launches round r of a one-stage lowering runs: a
    staleness1 round is one fused_round with the stale epilogue; a fill
    round of doublebuf / staleness_k is one fused_round; a stale one runs
    its chunk Grams, then mix_from_gram (gram_coef + stale_mix)."""
    want = dict.fromkeys(launch_names, 0)
    k = dcfg.staleness if dcfg.overlap == "staleness_k" else 1
    if dcfg.overlap == "staleness1":
        want.update(fused_round=1, partial_gram=1, gram_coef=1, stale_mix=1)
    elif r < k:
        want.update(fused_round=1, partial_gram=1, gram_coef=1, mix_shard=1)
    else:
        c = dcfg.overlap_chunks
        want.update(partial_gram=c, gram_coef=c + 1, mix_from_gram=1,
                    stale_mix=1)
    return want


def _equal(a, b, chunk=1 << 24):
    """Bit-equality of two (R, n) tensors on the card, column chunk by
    chunk (a whole-width comparison would be an (R, n) temporary)."""
    return all(torch.equal(x, y) for x, y in zip(a.split(chunk, dim=-1),
                                                  b.split(chunk, dim=-1)))


class _Events:
    """CUDA events around every call of a function in a module or class,
    collected per round."""

    def __init__(self, owner, name):
        self.owner, self.name = owner, name
        self.fn = getattr(owner, name)
        self.ms, self.pairs = [], []

    def __enter__(self):
        def timed(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = self.fn(*a, **kw)
            e1.record()
            self.pairs.append((e0, e1))
            return out
        setattr(self.owner, self.name, timed)
        return self

    def close_round(self):
        self.ms.append(sum(a.elapsed_time(b) for a, b in self.pairs))
        self.pairs = []

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.fn)


def _overlap_run(pk, label, over, layers, rounds, plan, keep=False):
    from repro_torch.configs import DPPFConfig, get_arch
    from repro_torch.core.engine import ConsensusEngine
    from repro_torch.data import TokenTask, make_round_batch
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.train import (
        RoundClock, init_train_state, make_round_step, set_participation,
    )
    import repro_torch.train.trainer as trainer_mod

    cfg = dataclasses.replace(get_arch("yi-6b"), n_layers=layers)
    M, tau, seq, batch = 4, 4, 64, 8
    model = build_model(cfg)
    dcfg = DPPFConfig(alpha=0.1, lam=0.5, tau=tau, consensus="simple_avg",
                      engine="flat", **over)
    opt = make_optimizer("sgd", momentum=0.9, weight_decay=1e-3)
    clock = RoundClock.from_config(dcfg, base_lr=LR,
                                   total_steps=rounds * tau)
    task = TokenTask(vocab_size=cfg.vocab_size, seq_len=seq)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model.init, opt, dcfg, M, gen, device="cuda")
    step = make_round_step(model.loss, opt, dcfg, clock=clock)
    boundary = "_staleness1" if dcfg.overlap == "staleness1" \
        else "_ring_round"
    out, held = [], None
    launched = dict.fromkeys(pk.LAUNCHES, 0)
    # the dropped row before each round, in page-locked host memory
    row = torch.empty((state.engine.layout.n,), pin_memory=True) \
        if plan else None
    with _Events(trainer_mod, boundary) as bev, \
            _Events(ConsensusEngine, "stage_comm") as gev:
        for spec in clock.rounds:
            r = spec.index
            drop, sync = (plan or {}).get(r, (None, 1.0))
            if plan is not None:
                mask = torch.ones(M)
                if drop is not None:
                    mask[drop] = 0.0
                state = set_participation(state, mask, sync=sync)
            b = make_round_batch(task, 0, M, spec.tau, spec.start, batch,
                                 cfg, device="cuda")
            if drop is not None:
                row.copy_(state.params[drop])
            missed = state.snap["missed"].tolist() if plan else None
            pk.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            round_ms = (time.perf_counter() - t0) * 1e3
            got = dict(pk.LAUNCHES)
            for key, v in got.items():
                launched[key] += v
            bev.close_round()
            gev.close_round()
            want = _expected_launches(dcfg, r, pk.LAUNCHES)
            if got != want:
                raise AssertionError(f"{label} round {r} launched {got}, "
                                     f"want {want}")
            rec = {"round": r, "loss": float(m["train_loss"]),
                   "consensus_dist": float(m["consensus_dist"]),
                   "staleness": m["staleness"], "round_ms": round_ms,
                   "boundary_ms": bev.ms[-1], "chunk_gram_ms": gev.ms[-1]}
            if plan is not None:
                frozen = drop is not None and missed[drop] < dcfg.staleness
                if drop is not None:
                    same = all(torch.equal(now, was.to("cuda"))
                               for now, was in zip(
                                   state.params[drop].split(1 << 24),
                                   row.split(1 << 24)))
                    if frozen != same:
                        raise AssertionError(
                            f"{label} round {r}: row {drop} "
                            f"{'moved' if frozen else 'did not move'} (it "
                            f"was {'frozen' if frozen else 'forced back'})")
                if sync == 0.0 and not _equal(state.params,
                                              state.snap["x"][-1]):
                    raise AssertionError(f"{label} round {r}: a sync = 0 "
                                         "round moved a row off its q")
                rec.update(dropped=drop, frozen=frozen, sync=sync)
            if not math.isfinite(rec["loss"]) or not (
                    r == 0 or rec["consensus_dist"] > 0):
                raise AssertionError(f"{label} round {r}: {rec}")
            out.append(rec)
            print(f"  {label} round " + json.dumps(rec))
    peak = torch.cuda.max_memory_allocated()
    print(f"  {label}: peak memory allocated {peak} bytes "
          f"({peak / 1e9:.2f} GB), layers {layers}, "
          f"n = {state.engine.layout.n}")
    if peak > 70e9:
        raise AssertionError(f"{label}: peak memory {peak / 1e9:.1f} GB > "
                             "70 GB: an (R, n) temporary beside the carry")
    if keep:
        held = state
    del state, step
    torch.cuda.empty_cache()
    k = dcfg.staleness if dcfg.overlap == "staleness_k" else 1
    stale = [rec for rec in out if rec["round"] >= k] or out
    summary = {key: statistics.mean(rec[key] for rec in stale)
               for key in ("round_ms", "boundary_ms", "chunk_gram_ms")}
    summary.update(peak_bytes=peak, rounds=[rec["round"] for rec in stale],
                   launches=launched)
    print(f"  {label}: mean of stale rounds " + json.dumps(summary))
    return summary, held


def _stale_against_plain(pk, ref, state):
    """(c): one stale application on the doublebuf run's full-width state
    (snapshot s, fresh view q = its params) on the kernels and on the
    plain functions; times of the epilogue and of a strided chunk Gram."""
    from repro_torch.train.trainer import _chunk_bounds
    s, q = state.snap["x"], state.params
    R, n = s.shape
    state.opt = None                    # the momentum's 19.5 GB go
    torch.cuda.empty_cache()
    T = torch.full((R, R), 1.0 / R, device="cuda")
    c0 = torch.full((R,), 0.1, device="cuda")        # alpha
    c1 = torch.full((R,), -0.5, device="cuda")       # -lam
    bounds = _chunk_bounds(n, 4)
    pk.reset_launches()
    Gk = sum(pk.partial_gram(s[:, a:b]) for a, b in bounds)
    Gp = sum(ref.partial_gram_plain(s[:, a:b]) for a, b in bounds)
    out = torch.empty_like(s)
    pk.mix_from_gram(s, T, c0, c1, Gk, out=out, base=q)
    _, rk, coef_k = pk.gram_coef(Gk[None], T, c0, c1)
    rp, coef_p = ref.gram_coef_plain(Gp, T, c0, c1)
    torch.cuda.synchronize()
    r_rel = float(((rk - rp).abs() / rp).max())
    err = torch.zeros(R, device="cuda")
    scale = torch.zeros(R, device="cuda")
    bitwise = True
    for a in range(0, n, ref.PLAIN_CHUNK * 4):
        b = min(n, a + ref.PLAIN_CHUNK * 4)
        got = out[:, a:b]
        plain = ref.stale_mix_plain(s[:, a:b], T, coef_p, q[:, a:b])
        err = torch.maximum(err, (got - plain).abs().amax(dim=1))
        scale = torch.maximum(scale, plain.abs().amax(dim=1))
        same = ref.stale_mix_plain(s[:, a:b], T, coef_k, q[:, a:b])
        bitwise = bitwise and torch.equal(got, same)
        del got, plain, same
    rel = float((err / scale).max())
    abs_err = float(err.max())
    print(f"  stale application, kernels vs plain: r max rel err "
          f"{r_rel:.3e}, rows max err {rel:.3e} of their scale "
          f"(tolerance {OVERLAP_TOL}); epilogue bit-equal to the plain "
          f"q + (mix(s) - s) on the kernel's coefficients: {bitwise}")
    if not (rel <= OVERLAP_TOL and r_rel <= OVERLAP_TOL and bitwise):
        raise AssertionError("the stale application differs from plain")
    # times at the main path's shape
    a, b = bounds[0]
    contiguous = out.view(-1)[:R * (b - a)].view(R, b - a)
    contiguous.copy_(s[:, a:b])
    times = {
        "stale_mix": (
            _time_ms(lambda: pk.stale_mix(s, T, coef_k, q, out=out)),
            _time_ms(lambda: ref.stale_mix_plain(s, T, coef_k, q, out=out),
                     reps=1, warm=1),
            None),
        "mix_from_gram": (
            _time_ms(lambda: pk.mix_from_gram(s, T, c0, c1, Gk, out=out,
                                              base=q)),
            _time_ms(lambda: ref.mix_from_gram_plain(
                s, T, c0, c1, Gk, out=out, base=q), reps=1, warm=1),
            None),
    }
    strided_ms = _time_ms(lambda: pk.partial_gram(s[:, a:b]))
    contiguous_ms = _time_ms(lambda: pk.partial_gram(contiguous))
    chunk_bound = (R * (b - a) * 4 + R * R * 4) / HBM_BYTES_PER_S * 1e3
    print(f"  partial_gram on a 4-chunk column slice ({R}, {b - a}) of the "
          f"({R}, {n}) view: strided {strided_ms:.4f} ms, contiguous copy "
          f"{contiguous_ms:.4f} ms, bound {chunk_bound:.4f} ms (bytes)")
    small = 4 * (R * R + 3 * R)
    nbytes = {"stale_mix": 3 * R * n * 4 + small,
              "mix_from_gram": 3 * R * n * 4 + small + R * R * 4}
    ops = 3 * R * R * n
    rows = {}
    for name, (ms, plain_ms, lib_ms) in times.items():
        t_bytes = nbytes[name] / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_FLOPS * 1e3
        rows[name] = {
            "name": name, "route": "cuda", "source": STALE_SOURCE,
            "replaces": STALE_REPLACES[name], "launches": 0,
            "max_abs_err": 0.0 if bitwise else abs_err,
            "max_rel_err": 0.0 if bitwise else rel, "tol_rel": OVERLAP_TOL,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
            "round_vs_plain_rel_err": rel}
    rows["partial_gram_strided"] = {"ms": strided_ms,
                                    "contiguous_ms": contiguous_ms,
                                    "bound_ms": chunk_bound,
                                    "shape": [R, b - a], "ld": n}
    del out, contiguous
    return rows


def _k1_pin(pk):
    """(c): doublebuf in one chunk against staleness_k k = 1 in one chunk,
    3 rounds at full width and 1 layer from one seed: bit for bit."""
    kept = {}
    for label, over in (("doublebuf", dict(overlap="doublebuf",
                                           overlap_chunks=1)),
                        ("k=1", dict(overlap="staleness_k", staleness=1,
                                     overlap_chunks=1))):
        _, st = _overlap_run(pk, f"pin {label}", over, 1, 3, None,
                             keep=True)
        x = st.snap["x"]
        kept[label] = (st.params, x[0] if isinstance(x, list) else x)
        del st, x
        torch.cuda.empty_cache()
    (pa, sa), (pb, sb) = kept["doublebuf"], kept["k=1"]
    same = _equal(pa, pb) and _equal(sa, sb)
    print(f"  doublebuf (1 chunk) and staleness_k k=1 (1 chunk) after 3 "
          f"rounds: params and snapshot bit-equal: {same}")
    if not same:
        raise AssertionError("staleness_k k=1 differs from doublebuf")
    del kept, pa, pb, sa, sb
    torch.cuda.empty_cache()


def _launcher_overlap(pk):
    """(d): the launcher with --overlap doublebuf --log-every-round."""
    from repro_torch.launch.train import main as train_main
    path = os.path.join(ROOT, "build", "chip_smoke", "round_metrics.jsonl")
    pk.reset_launches()
    loss = train_main(["--arch", "yi-6b", "--smoke", "--workers", "4",
                       "--tau", "4", "--steps", "16", "--seq", "16",
                       "--batch", "2", "--overlap", "doublebuf",
                       "--log-every-round", path])
    with open(path) as fh:
        recs = [json.loads(line) for line in fh]
    stal = [r["staleness"] for r in recs]
    print(f"  launcher --overlap doublebuf: eval loss {loss:.4f}, "
          f"{len(recs)} records, staleness {stal}, launches "
          f"{json.dumps(dict(pk.LAUNCHES))}")
    if not math.isfinite(loss) or stal != [0.0] + [1.0] * 3 \
            or [r["round"] for r in recs] != [0, 1, 2, 3] \
            or pk.LAUNCHES["stale_mix"] != 3:
        raise AssertionError("the overlap launcher's records are off")


def phase_overlap(pk, ref, none_mode):
    view4 = 4 * MAIN_N * 4
    n2 = 870_338_560
    print(f"  reckoning: one (4, n) fp32 view is {view4 / 1e9:.2f} GB at 4 "
          f"layers, {4 * n2 * 4 / 1e9:.2f} GB at 2; with one snapshot the "
          f"carry is params + momentum + snapshot, ~"
          f"{none_mode['peak_bytes'] / 1e9 + view4 / 1e9:.1f} GB at 4 "
          f"layers (phase 3's peak + a view); a k = 2 ring needs 4 views + "
          f"~9.8 GB = {(4 * view4) / 1e9 + 9.8:.1f} GB at 4 layers (more "
          f"than the card), {4 * 4 * n2 * 4 / 1e9 + 7.0:.1f} GB at 2")
    summaries = {"none (phase 3)": none_mode}
    for label, over, layers, rounds, plan in OVERLAP_RUNS:
        keep = label == "doublebuf"
        summary, st = _overlap_run(pk, label, over, layers, rounds, plan,
                                   keep=keep)
        summaries[label] = summary
        if keep:
            rows = _stale_against_plain(pk, ref, st)
        del st
        torch.cuda.empty_cache()
    # the counters are zeroed before each round: the runs' sums
    totals = {key: sum(summaries[label]["launches"][key]
                       for label, *_ in OVERLAP_RUNS)
              for key in pk.LAUNCHES}
    print("  launches over the phase's runs " + json.dumps(totals))
    print("  modes side by side " + json.dumps(summaries))
    _k1_pin(pk)
    _launcher_overlap(pk)
    strided = rows.pop("partial_gram_strided")
    for name in ("stale_mix", "mix_from_gram"):
        rows[name]["launches"] = totals[name]
        rows[name]["boundary_ms"] = summaries["doublebuf"]["boundary_ms"]
    return {"rows": rows, "launches": totals, "summaries": summaries,
            "partial_gram_strided": strided}


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device — the port's smoke run "
                         "needs the card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import importlib
    from repro_torch.kernels import _build
    from repro_torch.kernels.pullpush import pullpush as pk
    from repro_torch.kernels.pullpush import ref
    from repro_torch.kernels.swa_attention import swa_attention_plain
    from repro_torch.kernels.mamba_scan import ref as ssd_ref
    from repro_torch.kernels.slstm_step import ref as slstm_ref
    swa = importlib.import_module(
        "repro_torch.kernels.swa_attention.swa_attention")
    mk = importlib.import_module("repro_torch.kernels.mamba_scan.mamba_scan")
    sk = importlib.import_module("repro_torch.kernels.slstm_step.slstm_step")

    print("phase 1: card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    _build.build(*_build.all_sources())
    print(f"  kernels built in {time.perf_counter() - t0:.2f} s")
    for name, info in _build.build_info.items():
        print(f"  {name}: {info['path']}")
        print("\n".join("    " + line for line in info["log"].splitlines()
                        if "registers" in line or "spill" in line))

    secs = {"card": time.perf_counter() - t_start}

    print("phase 2: kernels against their plain versions")
    t0 = time.perf_counter()
    rows = phase_kernels(pk, ref)
    secs["kernels"] = time.perf_counter() - t0

    print("phase 3: the slice (yi-6b, full width)")
    t0 = time.perf_counter()
    launches, none_mode = phase_slice(pk)
    secs["slice"] = time.perf_counter() - t0
    for name, row in rows.items():
        row["launches"] = launches[name]

    print("phase 4: the launcher")
    t0 = time.perf_counter()
    phase_launcher(pk)
    secs["launcher"] = time.perf_counter() - t0

    print("phase 5: swa_attention against its plain version")
    t0 = time.perf_counter()
    rows["swa_attention"] = phase_attention(swa, swa_attention_plain)
    secs["attention"] = time.perf_counter() - t0

    print("phase 6: serving gemma2-2b (full width, full depth)")
    t0 = time.perf_counter()
    by_path = {"gemma2-2b serving": phase_serving(swa)}
    secs["serving"] = time.perf_counter() - t0

    print("phase 7: ssd_chunks against its plain version")
    t0 = time.perf_counter()
    rows["ssd_chunks"] = phase_ssd(mk, ssd_ref)
    secs["ssd"] = time.perf_counter() - t0

    print("phase 8: serving zamba2-7b (full width, full depth)")
    t0 = time.perf_counter()
    zamba = phase_zamba2(swa, mk)
    secs["zamba2"] = time.perf_counter() - t0
    # launches on each main path that runs the kernel, and their sum
    rows["swa_attention"]["launches_by_path"] = dict(
        by_path, **{"zamba2-7b serving": zamba["swa_attention"]})
    rows["swa_attention"]["launches"] = sum(
        rows["swa_attention"]["launches_by_path"].values())
    rows["ssd_chunks"]["launches_by_path"] = {
        "zamba2-7b serving": zamba["ssd_chunks"]}
    rows["ssd_chunks"]["launches"] = zamba["ssd_chunks"]

    print("phase 9: slstm_steps against its plain version")
    t0 = time.perf_counter()
    rows["slstm_steps"] = phase_slstm(sk, slstm_ref)
    secs["slstm"] = time.perf_counter() - t0

    print("phase 10: serving xlstm-350m (full width, full depth)")
    t0 = time.perf_counter()
    xl = phase_xlstm(sk)
    secs["xlstm"] = time.perf_counter() - t0
    rows["slstm_steps"]["launches_by_path"] = {"xlstm-350m serving": xl}
    rows["slstm_steps"]["launches"] = xl

    print("phase 11: sq_dist and apply_update against their plain versions")
    t0 = time.perf_counter()
    rows.update(phase_pair(pk, ref))
    secs["pair"] = time.perf_counter() - t0

    print("phase 12: the tree path (yi-6b, full width)")
    t0 = time.perf_counter()
    tree = phase_tree(pk, ref)
    secs["tree"] = time.perf_counter() - t0
    for name in PAIR_REPLACES:
        rows[name]["launches_by_path"] = {
            "yi-6b tree training, 4 Eq. 5 rounds": tree["eq5"][name],
            "yi-6b tree training, 1 easgd round": tree["easgd"][name]}
        rows[name]["launches"] = tree["eq5"][name] + tree["easgd"][name]

    print("phase 13: the overlap modes (yi-6b, full width)")
    t0 = time.perf_counter()
    overlap = phase_overlap(pk, ref, none_mode)
    secs["overlap"] = time.perf_counter() - t0
    rows.update(overlap["rows"])
    for name in REPLACES:
        rows[name]["launches_by_path"] = {
            "yi-6b training, none (phase 3)": launches[name],
            "yi-6b training, overlap modes (phase 13)":
                overlap["launches"][name]}
        rows[name]["launches"] += overlap["launches"][name]
    secs["total"] = time.perf_counter() - t_start
    print("phase seconds " + json.dumps(secs))

    record = list(rows.values())
    print("kernels " + json.dumps([
        {k: r[k] for k in ("name", "launches", "ms", "plain_ms", "bound_ms",
                           "library_ms")} | {"max_err": r["max_rel_err"]}
        for r in record]))
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Where the SSD kernel's time goes, on the card: a clock64 breakdown of
``ssd_kernel`` by phase, and the rate of the tensor-core instruction it
is built on.

    python3 tools/ssd_phases.py

1. A copy of ``src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu``
   with ``clock64()`` stamps (thread 0 of the first 512 blocks) after
   each phase: the prologue's staging (C, B, the sums of a) and the
   forming of G, then per head the products (with their stores) and the
   staging of the next head's x^T. It is built with the port's nvcc flags
   under ``build/``, launched once at zamba2-7b's serving shape (B = 4,
   S = 8160, H = 112, P = N = 64, L = 128), and the median cycles of
   each phase are printed. The stamps cost a few cycles each; the
   kernel's own time is ``chip_smoke.py`` phase 7's.
2. ``mma.sync.m16n8k8`` TF32 (HMMA.1688.F32.TF32) issued back to back
   on 12 independent accumulators by 4 to 32 warps an SM: TFLOP/s over
   the card, to set beside the 495 TFLOP/s TF32 peak of ``wgmma``.

Prints the card's name and power limit, then one JSON line. Needs the
card and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "mamba_scan",
                   "csrc", "mamba_scan.cu")
BUILD = os.path.join(ROOT, "build", "ssd_phases")
SLOTS = 100  # stamps a block: 0-2 prologue, 3 + 3 hh .. per head, 99 end
BLOCKS = 512

# (marker line in the source, stamp placed after it)
MARKS = (
    ("  const int nvT = (nv + 7) / 8;\n", "STAMP(0)"),
    ("  __syncthreads();  // C and B are staged, and each warp's sums of a\n",
     "STAMP(1)"),
    ("  __syncthreads();  // G, la and rem are ready; C's words are free "
     "for x^T\n", "STAMP(2)"),
    ("    // the next head's x loads run under this head's products, in two\n",
     "STAMP(3 + 3 * hh)"),
    ("    // the next head's x^T into the other buffer, which this head "
     "does not\n", "STAMP(4 + 3 * hh)"),
)
END = "    __syncthreads();\n  }\n}\n"

MMA_BENCH = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void hmma(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = threadIdx.x * 7 + i;
  b[0] = threadIdx.x;
  b[1] = threadIdx.x * 3;
  float acc[12][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 12; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]),
            "+f"(acc[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < 12; ++j)
    s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run_hmma(float* out, int blocks, int threads, int iters) {
  hmma<<<blocks, threads>>>(out, iters);
  return cudaGetLastError();
}
"""


def _nvcc(src, lib, flags):
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, *flags, "-o", lib, src], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(lib)


def _stamped_source():
    text = open(SRC).read()
    for mark, stamp in MARKS:
        if text.count(mark) != 1:
            raise SystemExit(f"ssd_phases: marker not found once: {mark!r}")
        text = text.replace(mark, mark + f"  {stamp};\n")
    if text.count(END) != 1:
        raise SystemExit("ssd_phases: the kernel's end was not found")
    text = text.replace(END, "    STAMP(5 + 3 * hh);\n" + END[:-2]
                        + f"  STAMP({SLOTS - 1});\n}}\n")
    lin = "(blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z))"
    text = text.replace("namespace {\n", f"""namespace {{
__device__ unsigned long long g_stamps[{BLOCKS * SLOTS}];
#define STAMP(i) if (threadIdx.x == 0 && {lin} < {BLOCKS}) \\
  g_stamps[{lin} * {SLOTS} + (i)] = clock64()
""", 1)
    return text + f"""
extern "C" int get_stamps(unsigned long long* out) {{
  return cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}}
"""


def phases():
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import importlib
    from repro_torch.kernels import _build
    mk = importlib.import_module("repro_torch.kernels.mamba_scan.mamba_scan")
    os.makedirs(BUILD, exist_ok=True)
    src = os.path.join(BUILD, "stamped.cu")
    with open(src, "w") as f:
        f.write(_stamped_source())
    lib = _nvcc(src, os.path.join(BUILD, "libstamped.so"),
                _build.NVCC_FLAGS[:-2])
    mk._bind(lib)
    lib.get_stamps.argtypes = [ctypes.c_void_p]
    Bt, S, H, P, N, L = 4, 8160, 112, 64, 64, 128
    gen = torch.Generator(device="cuda").manual_seed(5)
    xh = torch.randn((Bt, S, H, P), generator=gen, device="cuda")
    conv = torch.randn((Bt, S, 2 * N + 64), generator=gen, device="cuda")
    a = -torch.nn.functional.softplus(torch.randn(
        (Bt, S, H), generator=gen, device="cuda")) * torch.linspace(
        1.0, 8.0, H, device="cuda")
    real = mk.build
    mk.build = lambda: lib
    try:
        mk.ssd_chunks_seq(xh, conv[..., :N], conv[..., N:2 * N], a, L)
        torch.cuda.synchronize()
    finally:
        mk.build = real
    buf = np.zeros(BLOCKS * SLOTS, dtype=np.uint64)
    if lib.get_stamps(buf.ctypes.data) != 0:
        raise SystemExit("ssd_phases: reading the stamps failed")
    t = buf.reshape(BLOCKS, SLOTS).astype(np.int64)
    hpb = mk.geometry(Bt, S, H, L, P, N).heads_per_block

    def med(i, j):
        return float(np.median(t[:, j] - t[:, i]))
    heads = {hh: {"products": med(3 + 3 * hh, 4 + 3 * hh),
                  "next_x_and_barrier": med(4 + 3 * hh, 5 + 3 * hh)}
             for hh in (0, 1, hpb // 2, hpb - 1)}
    return {"shape": [Bt, S, H, P, N, L], "heads_per_block": hpb,
            "blocks_sampled": BLOCKS, "staging_cycles": med(0, 1),
            "g_cycles": med(1, 2), "heads_cycles": heads,
            "block_cycles": med(0, SLOTS - 1)}


def hmma_rate():
    os.makedirs(BUILD, exist_ok=True)
    src = os.path.join(BUILD, "hmma.cu")
    with open(src, "w") as f:
        f.write(MMA_BENCH)
    lib = _nvcc(src, os.path.join(BUILD, "libhmma.so"),
                ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                 "-shared", "-Xcompiler", "-fPIC"))
    lib.run_hmma.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 1024, device="cuda")
    rates, iters = {}, 4096
    for threads in (128, 256, 512, 1024):
        lib.run_hmma(out.data_ptr(), sms, threads, iters)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        lib.run_hmma(out.data_ptr(), sms, threads, iters)
        e1.record()
        torch.cuda.synchronize()
        flops = sms * threads / 32 * iters * 12 * 2 * 16 * 8 * 8
        rates[f"{threads // 32} warps/SM"] = (
            flops / (e0.elapsed_time(e1) * 1e-3) / 1e12)
    return rates


def main():
    if not torch.cuda.is_available():
        raise SystemExit("ssd_phases: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ssd_kernel_phases": phases(),
                      "hmma_tf32_tflops": hmma_rate()}))


if __name__ == "__main__":
    main()

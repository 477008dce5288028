// Mamba2 SSD intra-chunk kernel on Hopper (sm_90a): the port of
// src/repro/kernels/mamba_scan/mamba_scan.py:46 ssd_chunks (body _kernel).
//
// Per (batch b, head h, chunk c) with chunk length L, head dim P and state
// dim N, all in fp32:
//   la[t]      = a[0] + ... + a[t]                   (within the chunk)
//   y[t, :]    = sum_{s <= t} exp(la[t] - la[s]) (C[t] . B[s]) x[s, :]
//   state[p, n] = sum_s exp(la[L-1] - la[s]) B[s, n] x[s, p]
// Pairs with s > t never enter: they are zeroed before exp, where the
// reference masks them to -1e30 (la[t] - la[s] > 0 there and exp would
// overflow). exp(la[t] - la[s]) is never factored into exp(la[t]) and
// exp(-la[s]): at zamba2's A = 1..8, la falls to about -700 over a chunk
// and the factors overflow. Tokens at or past t_valid (the ragged last
// chunk) read as zero x, B, C and a, exactly as the reference's zero
// padding: a = 0 leaves la flat, and zero x and B add nothing. Their rows
// of y are not written, so the caller's tensor needs no padded tail.
//
// Route: the three products run on the tensor cores as
// mma.sync.m16n8k8 .tf32 in error-compensated TF32 (3xTF32). Each fp32
// operand v is split in registers into hi = tf32(v) and lo = tf32(v - hi)
// (the rounding of cvt.rna.tf32.f32, then a subtraction), and a product
// takes hi.hi + hi.lo + lo.hi with fp32 accumulation: about 21 bits of each
// operand, close to fp32 (a single TF32 pass keeps 11 and misses the
// 1e-4 bar; tests/test_torch_mamba_scan.py emulates both). mma.sync and
// not wgmma: wgmma takes .tf32 operands K-major only and its B from
// shared memory, while here the B operands are formed in registers per
// head (S^T's decay weights, B o rem) and split there. mma.sync's TF32
// rate on an H100 is about two thirds of wgmma's 495 TFLOP/s
// (tools/ssd_phases.py), so the 3 x 6.05e10 FLOP would take ~0.57 ms,
// under the 0.71 ms the bytes take; PERF.md records how far the kernel
// is from both. Fragments are laid out so that every operand a warp reads
// from shared memory is one contiguous vector per lane.
//
// Design. y is taken transposed, y^T = x^T S^T, so that x^T is the A
// operand of both products that read it: y^T (M = p, N = t, K = s) and
// state = x^T (B o rem) (M = p, N = n, K = s). A warp loads each x^T
// fragment once per k-step and uses it for all its output tiles. The
// B operands are formed in registers: S^T[s][t] = G[t][s] exp(la[t] -
// la[s]) (zero where s > t) and B[s][n] rem[s]. G = C B^T (L x L) does not
// depend on the head, so one block of 256 threads takes one (chunk, group
// of heads, batch), forms G's causal 8 x 8 blocks once on the tensor cores
// (M = t, N = s, K = n, also 3xTF32) and keeps them in shared memory, then
// loops over its heads. Per head the block stages x^T split into hi and lo
// in fragment order, and each of the 8 warps computes y^T for a pair of
// 8-row t tiles (w, 15 - w: 17 causal k-steps in all, so the warps are
// balanced) and the state for one 8-column n tile (16 k-steps); each tile
// is written to global memory as soon as its last k-step is done. The
// next head's x is loaded into registers while this head's products run
// (in two halves) and staged into the other of two buffers, so one
// barrier a head suffices. la is summed for all the group's heads at once
// before the head loop (a lane per head, so that a load reads one row of
// neighbouring heads; a warp per 16 steps, then the warps' sums in
// order). Shared
// memory at L = 128, P = N = 64 and 28 heads: x^T of two heads, hi and
// lo, 4 x 32 KiB, G's 136 causal blocks 34 KiB, B 32 KiB, la and rem
// (rows of 29 heads) 29 KiB: 228,352 bytes, one block (8 warps, two
// warpgroups of work) per SM. The wrapper sizes the group of heads from
// the grid (mamba_scan.py::geometry) and passes heads per block, threads
// and shared bytes; this entry refuses any other geometry.
//
// Shapes: L <= 128 in multiples of 8, P <= 64 in multiples of 16 (an m16
// tile), N <= 64 in multiples of 8 (an n8 tile); the wrapper checks them.
// All inputs are read through their strides (the last axis contiguous),
// so the model's (Bt, S, H, P) / (Bt, S, N) / (Bt, S, H) tensors and the
// column slices of the conv output need no copy; x and C are read in
// pairs of floats, so they start on 8-byte boundaries with even strides
// (the wrapper checks).
//
// Bound: at zamba2-7b's prefill shape (B = 4, S = 8160, H = 112,
// P = N = 64, L = 128, a 96-token last chunk) the inputs and outputs move
// 2.37 GB (0.71 ms at 3.35 TB/s) and the function needs 6.05e10 FLOP:
// 0.90 ms at the 67 TFLOP/s fp32 CUDA-core rate, 0.12 ms in one TF32 pass
// at 495 TFLOP/s and 0.37 ms in 3xTF32. So on this route bytes bound the
// kernel; chip_smoke.py computes both bounds from its inputs and PERF.md
// records how far the kernel is from them.
//
// The C entry returns cudaGetLastError() after the launch; the Python
// wrapper raises when it is not cudaSuccess.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kMaxL = 128, kMaxP = 64, kMaxN = 64, kMaxHeads = 32;
constexpr float kNegInf = -1e30f;  // the reference's mask (ref.py NEG_INF)
// x^T fragment blocks (8 s x 16 p) a warp stages per head
constexpr int kXBlocks = (kMaxL / 8) * (kMaxP / 16) / kWarps;

struct Strides4 {  // element strides of (b, h, c, l); the last axis is 1
  long long b, h, c, l;
};
struct Strides3 {  // element strides of (b, c, l)
  long long b, c, l;
};

// Shared-memory regions, in 4-byte words from the base. Every region
// starts on a 16-byte boundary (all sizes are multiples of 4 words).
//   x0, x1: x^T of one head each (double-buffered: the next head is
//     staged while this one's products run), split into TF32 hi and lo, in
//     A-fragment order: block (ks, mp) (s in [8 ks, 8 ks + 8), p in
//     [16 mp, 16 mp + 16)) holds, for lane (g, q) (g = lane / 4,
//     q = lane % 4), a uint4 of hi and one of lo of (x[8ks+q][16mp+2g],
//     x[8ks+q][16mp+2g+1], x[8ks+q+4][16mp+2g], x[8ks+q+4][16mp+2g+1]):
//     the m16 tile's rows g and g + 8 are p = 2g and 2g + 1, so that a
//     lane's values are neighbours in memory. Before the head loop x0
//     holds C split the same way, block (mt, kn) for t in [16 mt, 16 mt +
//     16) and n in [8 kn, 8 kn + 8) (t up to L rounded to 16), with G's k
//     slots q and q + 4 at n = 2q and 2q + 1; x1 holds each warp's sums
//     of a.
//   g: G[t][s] raw for the causal 8 x 8 blocks (nt, ks), ks <= nt, at
//     block nt (nt + 1) / 2 + ks: lane (g, q) holds the float2
//     (G[8nt+g][8ks+q], G[8nt+g][8ks+q+4]), the B fragment of S^T.
//   b: B raw in B-fragment order: block (ks, nn) holds for lane (g, q)
//     the float2 (B[8ks+q][8nn+g], B[8ks+q+4][8nn+g]).
//   la, rem: la and exp(la[L-1] - la) of each head of the group, step l
//     of head hh at l * lp + hh (lp = hpb | 1, odd, so that neither the
//     writes of a row of heads nor the reads of a head's steps collide in
//     a bank).
struct Layout {
  int nT, nN, L16, lp;
  size_t xw, x0, x1, g, b, la, rem, total;  // xw: words of hi (or of lo)
  __host__ __device__ Layout(int L, int P, int N, int hpb)
      : nT(L / 8), nN(N / 8), L16((L + 15) / 16 * 16), lp(hpb | 1) {
    const size_t cw = size_t(L16) * N;
    xw = size_t(L) * P > cw ? size_t(L) * P : cw;
    x0 = 0;
    x1 = 2 * xw;
    g = x1 + 2 * xw;
    b = g + size_t(nT) * (nT + 1) / 2 * 64;
    la = b + size_t(L) * N;
    rem = la + size_t(L) * lp;
    total = rem + size_t(L) * lp;
  }
};

// The rounding of cvt.rna.tf32.f32 (to nearest, ties away from zero, the
// 13 low mantissa bits cleared) for finite v, in two integer instructions:
// half of the dropped range added to the magnitude's bits carries into
// the kept ones. ptxas expands cvt.rna itself into four, guarding inf and
// NaN, which the kernel's finite operands do not need.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo to about 21 bits, each part a TF32 value. lo's low bits are
// left uncleared: the tensor cores ignore a .tf32 operand's 13 low bits,
// so adding the half step is its whole rounding.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = __float_as_uint(v - __uint_as_float(hi)) + 0x1000u;
}

// d += a b on the tensor cores (16 x 8 x 8, TF32 in, fp32 accumulate)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// (row, col) of a thread's k-th element of a (rows x cols) walk whose
// step is `step` elements, starting at element `first`: the divisions
// once, then additions
struct Walk {
  int r, c, dr, dc, cols;
  __device__ explicit Walk(int cols_, int step = kThreads,
                           int first = threadIdx.x)
      : r(first / cols_), c(first % cols_), dr(step / cols_),
        dc(step % cols_), cols(cols_) {}
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

// An A fragment's hi and lo parts, read from shared memory (lo lies xw
// words after hi)
__device__ __forceinline__ void load_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                       const uint32_t* p, size_t xw) {
  const uint4 h = *reinterpret_cast<const uint4*>(p);
  const uint4 l = *reinterpret_cast<const uint4*>(p + xw);
  hi[0] = h.x;
  hi[1] = h.y;
  hi[2] = h.z;
  hi[3] = h.w;
  lo[0] = l.x;
  lo[1] = l.y;
  lo[2] = l.z;
  lo[3] = l.w;
}

// The B fragment of S^T at block (nt, ks): G o exp(la[t] - la[s]), split
// into hi and lo. Where s > t the exponent is masked to -1e30 before exp,
// as the reference does (la[t] - la[s] > 0 there and exp would overflow),
// and exp gives 0; a select and not a branch, so that the warp does not
// diverge.
__device__ __forceinline__ void s_frag(const float* sG, int nt, int ks,
                                       int lane, float la_t, float la_s0,
                                       float la_s1, uint32_t (&bh)[2],
                                       uint32_t (&bl)[2]) {
  const float2 gv = reinterpret_cast<const float2*>(
      sG)[(nt * (nt + 1) / 2 + ks) * 32 + lane];
  const int t = 8 * nt + lane / 4, s0 = 8 * ks + lane % 4;
  const float v0 = gv.x * expf(s0 <= t ? la_t - la_s0 : kNegInf);
  const float v1 = gv.y * expf(s0 + 4 <= t ? la_t - la_s1 : kNegInf);
  split(v0, bh[0], bl[0]);
  split(v1, bh[1], bl[1]);
}

template <bool V>
using Flag = std::integral_constant<bool, V>;

// MP = P / 16, the m16 tiles of the head dim: a template parameter so that
// no product hangs on a run-time condition (ptxas then keeps the
// accumulators' chains interleaved).
template <int MP>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ a,
               float* __restrict__ y, float* __restrict__ st, Strides4 sx,
               Strides3 sb, Strides3 sc, Strides4 sa, Strides4 sy,
               Strides4 sst, int H, int L, int N, int t_valid, int hpb) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout lay(L, 16 * MP, N, hpb);
  const int nN = lay.nN;
  // x^T's two buffers (hi, then lo) at sX + buffer * 2 xw; C in the
  // first before the head loop, the a sums' scratch in the second
  uint32_t* sX = reinterpret_cast<uint32_t*>(smem + lay.x0);
  uint32_t* sC = sX;
  float* sTot = smem + lay.x1;
  float* sG = smem + lay.g;
  float* sB = smem + lay.b;
  float* sLa = smem + lay.la;
  float* sRem = smem + lay.rem;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int c = blockIdx.x, b = blockIdx.z;
  const int h0 = blockIdx.y * hpb, nh = min(hpb, H - h0);
  // rows of this chunk that hold tokens (the rest read as zero), and the
  // 8-row tiles that hold them: later tiles are neither read nor written
  const int nv = max(0, min(L, t_valid - c * L));
  const int nvT = (nv + 7) / 8;

  // Operands staged in A-fragment order: warp w takes blocks w, w + 8, ...
  // The loaders issue a thread's loads into registers (rows at or past nv
  // read as zero; pairs of neighbours as one 8-byte load), store_frags
  // splits them and writes hi and lo as uint4s.
  float fr[kXBlocks][4];
  auto at2 = [&](const float* src, long long row, int r, int col,
                 bool in) {
    return in && r < nv
               ? *reinterpret_cast<const float2*>(src + r * row + col)
               : make_float2(0.f, 0.f);
  };
  // x^T of head h: block (ks, mp) with the m16 tile's rows g and g + 8 at
  // p = 16 mp + 2g and 2g + 1, so that a lane's two columns are
  // neighbours: lane (g, q) holds x[s][p], x[s][p + 1], x[s + 4][p],
  // x[s + 4][p + 1] for s = 8 ks + q, p = 16 mp + 2g. The warp's blocks
  // k0 <= k < k1 only.
  auto load_x = [&](int h, int k0 = 0, int k1 = kXBlocks) {
    const float* xb = x + b * sx.b + h * sx.h + c * sx.c;
    Walk w(MP, kWarps, warp);
#pragma unroll
    for (int k = 0; k < kXBlocks; ++k, w.next()) {
      if (k < k0 || k >= k1) continue;
      const bool in = warp + kWarps * k < nvT * MP;
      const int s0 = 8 * w.r + q, p0 = 16 * w.c + 2 * g;
      const float2 v0 = at2(xb, sx.l, s0, p0, in);
      const float2 v1 = at2(xb, sx.l, s0 + 4, p0, in);
      fr[k][0] = v0.x;
      fr[k][1] = v0.y;
      fr[k][2] = v1.x;
      fr[k][3] = v1.y;
    }
  };
  // C: block (mt, kn) with the k8 step's slots q and q + 4 at n = 8 kn +
  // 2q and 2q + 1 (G's K may be taken in any order): lane (g, q) holds
  // C[t][n], C[t + 8][n], C[t][n + 1], C[t + 8][n + 1] for t = 16 mt + g,
  // n = 8 kn + 2q
  auto load_c = [&]() {
    const float* Cb = Cm + b * sc.b + c * sc.c;
    Walk w(nN, kWarps, warp);
#pragma unroll
    for (int k = 0; k < kXBlocks; ++k, w.next()) {
      const bool in = warp + kWarps * k < (nvT + 1) / 2 * nN;
      const int t0 = 16 * w.r + g, n0 = 8 * w.c + 2 * q;
      const float2 v0 = at2(Cb, sc.l, t0, n0, in);
      const float2 v1 = at2(Cb, sc.l, t0 + 8, n0, in);
      fr[k][0] = v0.x;
      fr[k][1] = v1.x;
      fr[k][2] = v0.y;
      fr[k][3] = v1.y;
    }
  };
  auto store_frags = [&](uint32_t* dst, int n_blocks) {
#pragma unroll
    for (int k = 0; k < kXBlocks; ++k) {
      const int blk = warp + kWarps * k;
      if (blk < n_blocks) {
        uint4 hi, lo;
        split(fr[k][0], hi.x, lo.x);
        split(fr[k][1], hi.y, lo.y);
        split(fr[k][2], hi.z, lo.z);
        split(fr[k][3], hi.w, lo.w);
        reinterpret_cast<uint4*>(dst)[blk * 32 + lane] = hi;
        reinterpret_cast<uint4*>(dst + lay.xw)[blk * 32 + lane] = lo;
      }
    }
  };

  // Every global load of the prologue in flight at once: C, B, and a of
  // every head of the group (lane = head, warp w steps 16 w .. 16 w + 15,
  // so that a load reads one row of neighbouring heads)
  load_c();
  const float* Bb = Bm + b * sb.b + c * sb.c;
  constexpr int kBLoads = kMaxL * kMaxN / 2 / kThreads;
  float2 bv[kBLoads];
  {
    // B: float2 e = tid + 256 k is lane e % 32 of block e / 32 = (ks, nn)
    Walk wb(nN, kWarps, warp);
#pragma unroll
    for (int k = 0; k < kBLoads; ++k, wb.next()) {
      const int s0 = 8 * wb.r + q, n = 8 * wb.c + g;
      bv[k] = make_float2(s0 < nv ? Bb[s0 * sb.l + n] : 0.f,
                          s0 + 4 < nv ? Bb[(s0 + 4) * sb.l + n] : 0.f);
    }
  }
  constexpr int kSteps = kMaxL / kWarps;  // a's steps per warp
  static_assert(kMaxHeads <= 32, "one lane per head");
  float run[kSteps];  // a's running sum over the warp's steps
  {
    const float* ab = a + b * sa.b + (h0 + lane) * sa.h + c * sa.c;
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int l = kSteps * warp + k;
      run[k] = sum += lane < nh && l < nv ? ab[l * sa.l] : 0.f;
    }
  }
  store_frags(sC, (nvT + 1) / 2 * nN);
  load_x(h0);  // in flight while G is formed
#pragma unroll
  for (int k = 0; k < kBLoads; ++k)
    if (tid + kThreads * k < L * N / 2)
      reinterpret_cast<float2*>(sB)[tid + kThreads * k] = bv[k];
  sTot[warp * 32 + lane] = run[kSteps - 1];
  __syncthreads();  // C and B are staged, and each warp's sums of a

  // la = the warps' sums before this one, in warp order, plus the running
  // sum; la[L - 1] by the same additions (steps past L add zero), so that
  // rem = exp(la[L - 1] - la) sees the la the products see
  if (lane < nh) {
    const int w_last = (L - 1) / kSteps;
    float off = 0.f, last = 0.f;
    for (int w = 0; w <= w_last; ++w) {
      if (w == warp) off = last;
      last += sTot[w * 32 + lane];
    }
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int l = kSteps * warp + k;
      if (l < L) {
        const float v = off + run[k];
        sLa[l * lay.lp + lane] = v;
        sRem[l * lay.lp + lane] = expf(last - v);
      }
    }
  }

  // G = C B^T on its causal blocks: 16 x 8 tiles (mt, ns) of t x s,
  // K = n, taken round-robin by the warps; the three terms of 3xTF32 in
  // three accumulators, so that no product waits for the one before
  {
    const int nMt = (nvT + 1) / 2;
    int idx = 0;
    for (int mt = 0; mt < nMt; ++mt) {
      const int ns_end = min(2 * mt + 1, nvT - 1);
      for (int ns = 0; ns <= ns_end; ++ns, ++idx) {
        if (idx % kWarps != warp) continue;
        float acc[3][4] = {};
#pragma unroll 4
        for (int kn = 0; kn < nN; ++kn) {
          uint32_t ah[4], al[4], bh[2], bl[2];
          load_a(ah, al, sC + ((mt * nN + kn) * 32 + lane) * 4, lay.xw);
          // B[8ns + g][8kn + 2q (+ 1)] from B's fragment order
          const float* b0 =
              sB + ((ns * nN + kn) * 32 + 8 * q + g % 4) * 2 + g / 4;
          split(b0[0], bh[0], bl[0]);
          split(b0[8], bh[1], bl[1]);
          mma(acc[0], al, bh);
          mma(acc[1], ah, bl);
          mma(acc[2], ah, bh);
        }
        // acc = G[16mt + g (+ 8)][8ns + 2q (+ 1)]: keep the causal blocks
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = 16 * mt + g + 8 * (i / 2);
          const int s = 8 * ns + 2 * q + i % 2;
          const int nt = t / 8, ks = s / 8;
          if (ks <= nt && nt < nvT)
            sG[((nt * (nt + 1) / 2 + ks) * 32 + (t % 8) * 4 + s % 4) * 2 +
               (s / 4) % 2] = (acc[0][i] + acc[1][i]) + acc[2][i];
        }
      }
    }
  }
  __syncthreads();  // G, la and rem are ready; C's words are free for x^T
  store_frags(sX, nvT * MP);
  __syncthreads();  // x^T of the first head is staged

  // this warp's output tiles: t tiles ta < tb of y^T (a pair w, nvT-1-w;
  // the middle tile of an odd count alone as tb; < 0: none) and n tile nn
  // of the state (none when nn >= nN)
  const int npair = nvT / 2;
  const int ta = warp < npair ? warp : -1;
  const int tb = warp < npair ? nvT - 1 - warp
                              : (nvT % 2 && warp == npair ? warp : -1);
  const int nn = warp;
  const bool has_s = nn < nN;

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    // the next head's x loads run under this head's products, in two
    // halves (here and after the first phase): issued at once they slowed
    // the products by ~6% (the loads and the shared reads share the
    // memory pipe)
    constexpr int kHalf = kXBlocks / 2;
    if (hh + 1 < nh) load_x(h + 1, 0, kHalf);

    const uint32_t* sXh = sX + (hh % 2) * 2 * lay.xw;
    const int lp = lay.lp;  // la[l * lp], rem[l * lp]: this head's steps
    const float* la = sLa + hh;
    const float* rem = sRem + hh;
    const float la_a = ta >= 0 ? la[(8 * ta + g) * lp] : 0.f;
    const float la_b = tb >= 0 ? la[(8 * tb + g) * lp] : 0.f;
    float acc[3][MP][4] = {};  // y^T of ta and tb, the state of nn

    // One k-step for the tiles the flags name: their B fragments (S^T,
    // B o rem) formed and split in registers, x^T's A fragments read once,
    // then the three terms of 3xTF32 as three passes over every (tile,
    // m16 tile), so that no two products on one accumulator are adjacent.
    auto kstep = [&](auto use_a, auto use_b, auto use_s, int ks) {
      constexpr bool kA = decltype(use_a)::value;
      constexpr bool kB = decltype(use_b)::value;
      constexpr bool kS = decltype(use_s)::value;
      const int s0 = 8 * ks + q;
      const float la_s0 = la[s0 * lp], la_s1 = la[(s0 + 4) * lp];
      uint32_t fh[3][2], fl[3][2];
      if (kA) s_frag(sG, ta, ks, lane, la_a, la_s0, la_s1, fh[0], fl[0]);
      if (kB) s_frag(sG, tb, ks, lane, la_b, la_s0, la_s1, fh[1], fl[1]);
      if (kS) {
        const float2 bv =
            reinterpret_cast<const float2*>(sB)[(ks * nN + nn) * 32 + lane];
        split(bv.x * rem[s0 * lp], fh[2][0], fl[2][0]);
        split(bv.y * rem[(s0 + 4) * lp], fh[2][1], fl[2][1]);
      }
      uint32_t xh[MP][4], xl[MP][4];
#pragma unroll
      for (int mp = 0; mp < MP; ++mp)
        load_a(xh[mp], xl[mp], sXh + ((ks * MP + mp) * 32 + lane) * 4,
               lay.xw);
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)
#pragma unroll
        for (int mp = 0; mp < MP; ++mp) {
          const uint32_t(&xa)[4] = pass == 0 ? xl[mp] : xh[mp];
          if (kA) mma(acc[0][mp], xa, pass == 1 ? fl[0] : fh[0]);
          if (kB) mma(acc[1][mp], xa, pass == 1 ? fl[1] : fh[1]);
          if (kS) mma(acc[2][mp], xa, pass == 1 ? fl[2] : fh[2]);
        }
    };
    // k-steps [ks, end) for a fixed set of tiles, two at a time so that
    // ptxas can overlap one's exp chain with the other's products
    auto run = [&](auto use_a, auto use_b, auto use_s, int ks, int end) {
#pragma unroll 2
      for (; ks < end; ++ks) kstep(use_a, use_b, use_s, ks);
    };
    // acc[k][mp] = y^T[16mp + 2g (+ 1)][8nt + 2q (+ 1)]: y[t][p], y[t][p + 1]
    // is (acc[k][mp][0], [2]) at t = 8nt + 2q and ([1], [3]) at t + 1.
    // Rows t < nv; each tile written as soon as its last k-step is done,
    // so that the stores drain under the products that follow.
    float* yb = y + b * sy.b + h * sy.h + c * sy.c + 2 * g;
    auto store_y = [&](int k, int nt) {
      const int t = 8 * nt + 2 * q;
#pragma unroll
      for (int mp = 0; mp < MP; ++mp) {
        if (t < nv)
          *reinterpret_cast<float2*>(yb + t * sy.l + 16 * mp) =
              make_float2(acc[k][mp][0], acc[k][mp][2]);
        if (t + 1 < nv)
          *reinterpret_cast<float2*>(yb + (t + 1) * sy.l + 16 * mp) =
              make_float2(acc[k][mp][1], acc[k][mp][3]);
      }
    };
    // three phases, each with a fixed set of tiles: ks <= ta takes all
    // three, ta < ks <= tb the pair's far tile and the state, then the
    // state alone
    constexpr Flag<true> on{};
    constexpr Flag<false> off{};
    if (has_s) {
      run(on, on, on, 0, ta + 1);
      if (hh + 1 < nh) load_x(h + 1, kHalf, kXBlocks);
      if (ta >= 0) store_y(0, ta);
      run(off, on, on, ta + 1, tb + 1);
      if (tb >= 0) store_y(1, tb);
      run(off, off, on, tb + 1, nvT);
      // acc[2][mp] = state[16mp + 2g (+ 1)][8nn + 2q (+ 1)]
      float* stb = st + b * sst.b + h * sst.h + c * sst.c + 8 * nn + 2 * q;
#pragma unroll
      for (int mp = 0; mp < MP; ++mp) {
        const int p = 16 * mp + 2 * g;
        *reinterpret_cast<float2*>(stb + p * sst.l) =
            make_float2(acc[2][mp][0], acc[2][mp][1]);
        *reinterpret_cast<float2*>(stb + (p + 1) * sst.l) =
            make_float2(acc[2][mp][2], acc[2][mp][3]);
      }
    } else {
      run(on, on, off, 0, ta + 1);
      if (hh + 1 < nh) load_x(h + 1, kHalf, kXBlocks);
      if (ta >= 0) store_y(0, ta);
      run(off, on, off, ta + 1, tb + 1);
      if (tb >= 0) store_y(1, tb);
    }
    // the next head's x^T into the other buffer, which this head does not
    // read; one barrier then covers both buffers
    if (hh + 1 < nh) store_frags(sX + ((hh + 1) % 2) * 2 * lay.xw, nvT * MP);
    __syncthreads();
  }
}

using Kernel = decltype(&ssd_kernel<1>);
constexpr Kernel kKernels[kMaxP / 16] = {ssd_kernel<1>, ssd_kernel<2>,
                                         ssd_kernel<3>, ssd_kernel<4>};

}  // namespace

extern "C" {

// strides (22 element strides): x (b, h, c, l), B (b, c, l), C (b, c, l),
// a (b, h, c, l), y (b, h, c, l), state (b, h, c, p); the last axis of x,
// B, C, y and state is contiguous, and x, C, y and the state start on
// 8-byte boundaries with even strides (pairs of floats move as one).
// Token c * L + l is valid when it is below t_valid. heads_per_block
// heads share one G; threads and smem_bytes are the wrapper's geometry,
// refused unless they are this instance's.
int ssd_chunks_fwd(const float* x, const float* B, const float* C,
                   const float* a, float* y, float* st,
                   const long long* s, int Bt, int H, int nc, int L, int P,
                   int N, int t_valid, int heads_per_block, int threads,
                   int smem_bytes, void* stream) {
  if (L < 8 || L > kMaxL || L % 8 || P < 16 || P > kMaxP || P % 16 ||
      N < 8 || N > kMaxN || N % 8 || heads_per_block < 1 ||
      heads_per_block > kMaxHeads || threads != kThreads ||
      (s[0] | s[1] | s[2] | s[3] | s[7] | s[8] | s[9]) % 2 ||
      (s[14] | s[15] | s[16] | s[17] | s[18] | s[19] | s[20] | s[21]) % 2 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(C) |
       reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(st)) %
          8)
    return int(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * Layout(L, P, N, heads_per_block).total;
  if (size_t(smem_bytes) != smem) return int(cudaErrorInvalidValue);
  const Strides4 sx{s[0], s[1], s[2], s[3]};
  const Strides3 sb{s[4], s[5], s[6]};
  const Strides3 sc{s[7], s[8], s[9]};
  const Strides4 sa{s[10], s[11], s[12], s[13]};
  const Strides4 sy{s[14], s[15], s[16], s[17]};
  const Strides4 sst{s[18], s[19], s[20], s[21]};
  const Kernel kernel = kKernels[P / 16 - 1];
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(nc, (H + heads_per_block - 1) / heads_per_block, Bt);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, B, C, a, y, st, sx, sb, sc, sa, sy, sst, H, L, N, t_valid,
      heads_per_block);
  return int(cudaGetLastError());
}

const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Sliding-window flash attention, forward only, on Hopper (sm_90a): the
// port of src/repro/kernels/swa_attention/swa_attention.py::swa_attention
// (body _kernel).
//
// It computes swa_attention_ref: for q (B, H, Sq, hd) and k, v
// (B, Hkv, Skv, hd), query head h reads kv head h / (H / Hkv); the scores
// (q . k) * hd^-0.5 are softcapped (tanh(s / cap) * cap when cap > 0) and
// masked to kpos < Skv, kpos <= qpos (causal) and kpos > qpos - window
// (window > 0); softmax and the product with v accumulate in fp32, and the
// output is written in the inputs' type. Rows whose band is empty give 0.
//
// Two kernels, one per dtype. Both walk only the kv band of their q tile,
// from max(0, q0 - window + 1) to min(q_last, Skv - 1) (the TPU kernel
// visits every kv grid step and skips the out-of-band ones with pl.when),
// visit q tiles latest first so the causally heaviest blocks start in the
// first wave, pad nothing (the Pallas wrapper pads with jnp.pad) and mask
// keys at kpos >= Skv, so they never enter the softmax. Both read the
// tensors through their strides (head_dim contiguous): the model's
// (B, S, H, hd) layout needs no transposed copy.
//
// bf16, the serving path: swa_wgmma_kernel<HD>. Bound: operations. At the
// serving shapes (S = 8160, hd 256 or 112) the in-band pairs need 4 hd
// FLOPs each against ~4 hd bytes of q/k/v/out per query row, far above the
// card's ~295 FLOP/byte balance, so the tensor cores' bf16 rate (989
// TFLOP/s) is the bound. The design (FlashAttention-3's structure):
//   * a block of one producer warpgroup and consumer warpgroups of 64
//     query rows each: three (192 rows of one head) below hd 256; two at
//     hd 256, where the O accumulator takes 128 registers a thread: 128
//     rows of one head or, where H / Hkv is even, 64 rows of the two
//     query heads of one kv group, so each K/V tile is loaded once for
//     both. setmaxnreg gives the producer's registers to the consumers;
//   * one producer thread issues every load by TMA (cp.async.bulk.tensor,
//     128-byte swizzle, boxes of 64 columns; hd 112 takes two boxes, the
//     second's columns 112-127 zero-filled and never read by a product):
//     Q once, K and V tiles of 64 keys into two rings (2 stages at hd 256,
//     4 below), each slot with a full and an empty mbarrier. The tensor
//     maps are built by the C entry point with cuTensorMapEncodeTiled,
//     taken through cudaGetDriverEntryPoint (no -lcuda), over the strided
//     4-D views (hd, S, H, B) as they are;
//   * S = Q K^T runs on wgmma m64n64k16 (bf16 in, fp32 accumulate), Q and
//     K from shared memory; the scale is applied to the fp32 score;
//   * P, converted from the S accumulators to bf16 in registers, is the A
//     operand of O += P V (wgmma m64n64k16 / m64n48k16 over 64-column
//     slices of hd), V the B operand from shared memory in its natural
//     (keys, hd) layout, read transposed;
//   * a consumer issues S_j and P_{j-1} V_{j-1} together and runs the
//     softmax of S_j while P V runs; at hd 256 the two consumers take
//     turns issuing (two named barriers), so one's softmax also runs
//     under the other's products;
//   * the online softmax stays in registers: per-row max and sum reduced
//     over the accumulator's quads, log2(e) folded into one multiply,
//     exp2 on ex2.approx, and a row's max moves only when a tile passes
//     it by more than 2^8 (FlashAttention-4's lazy rescale: P stays below
//     256, and a warp whose rows did not move skips the O rescale); the
//     softcap is cap * (1 - 2 / (1 + 2^(2 log2e
//     x / cap))) on ex2.approx and rcp.approx (absolute error ~1e-7 cap;
//     tanh.approx's 2^-11 relative error would reach ~0.024 at cap 50);
//     only tiles that cross the band's edge or Skv are masked, and a
//     consumer skips the products of tiles wholly outside its rows' band;
//   * the output goes from registers to global memory, rows past Sq
//     never written.
//
// float32: swa_kernel<HD>, the first port, kept for exact checks (a
// bf16 or TF32 product cannot meet fp32's tolerance). One block of 256
// threads per (q tile of 64 rows, head, batch): Q, K, V tiles staged in
// shared memory as fp32 (rows padded to hd + 1), 4 x 4 register
// micro-tiles for S = Q K^T and P V on the CUDA cores (bound: the 67
// TFLOP/s fp32 rate), the softmax in shared memory, four lanes a row.
//
// The C entry returns cudaGetLastError() after the launch, or a code of
// its own when a tensor map cannot be built; the Python wrapper raises
// when it is not 0.

#include <cuda.h>  // CUtensorMap and the driver's enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMInit = -1e30f;  // the reference's NEG_INF as the start of m

struct Strides {  // element strides of (B, H, S); the hd dim has stride 1
  long long b, h, s;
};

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per kv tile (both kernels)
constexpr int kLDS = kBK + 1;    // padded row stride of the score tile

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(kBQ + 2 * kBK) * (HD + 1) + size_t(kBQ) * kLDS + 3 * kBQ);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    swa_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               Strides sq, Strides sk, Strides sv, Strides so, int group,
               int Sq, int Skv, int causal, int window, float cap,
               float scale) {
  constexpr int LD = HD + 1;     // padded row stride of the Q / K / V tiles
  constexpr int RI = kBQ / 16;   // rows per thread
  constexpr int CJ = kBK / 16;   // score columns per thread
  constexpr int DJ = HD / 16;    // accumulator columns per thread

  extern __shared__ float smem[];
  float* sQ = smem;              // kBQ x LD
  float* sK = sQ + kBQ * LD;     // kBK x LD
  float* sV = sK + kBK * LD;     // kBK x LD
  float* sS = sV + kBK * LD;     // kBQ x kLDS: scores, then P
  float* sM = sS + kBQ * kLDS;   // running max per row
  float* sL = sM + kBQ;          // running sum per row
  float* sC = sL + kBQ;          // this tile's correction per row

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + hk * sk.h;
  const float* vb = v + b * sv.b + hk * sv.h;
  float* ob = o + b * so.b + h * so.h;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, qp = q0 + r;
    sQ[r * LD + d] = qp < Sq ? qb[qp * sq.s + d] * scale : 0.f;
  }
  if (tid < kBQ) {
    sM[tid] = kMInit;
    sL[tid] = 0.f;
  }

  float acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // the band of keys any row of this tile may see
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(q_last, Skv - 1) : Skv - 1;

  for (int k0 = k_lo; k0 <= k_hi; k0 += kBK) {
    __syncthreads();  // the last tile's K / V / P reads are done
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD, kp = k0 + r;
      const bool in = kp < Skv;
      sK[r * LD + d] = in ? kb[kp * sk.s + d] : 0.f;
      sV[r * LD + d] = in ? vb[kp * sv.s + d] : 0.f;
    }
    __syncthreads();

    // S = Q K^T on the 4 x 4 micro-tile, softcap and mask
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = sQ[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i, qp = q0 + r;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = tx + 16 * j, kp = k0 + c;
        const bool ok = qp < Sq && kp < Skv && (!causal || kp <= qp) &&
                        (window <= 0 || kp > qp - window);
        float x = s[i][j];
        if (cap > 0.f) x = tanhf(x / cap) * cap;
        sS[r * kLDS + c] = ok ? x : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax, four neighbouring lanes per row
    {
      const int r = tid / 4, part = tid % 4;
      float mx = -INFINITY;
      for (int c = part; c < kBK; c += 4) mx = fmaxf(mx, sS[r * kLDS + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);  // masked scores are -inf
      float sum = 0.f;
      for (int c = part; c < kBK; c += 4) {
        const float x = sS[r * kLDS + c];
        const float p = x == -INFINITY ? 0.f : expf(x - m_new);
        sS[r * kLDS + c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_old - m_new);
        sM[r] = m_new;
        sL[r] = sL[r] * corr + sum;
        sC[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float c = sC[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= c;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = sS[(ty + 16 * i) * kLDS + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = sV[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();  // sL is final (and initialised when the band is empty)

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i, qp = q0 + r;
    if (qp >= Sq) continue;
    const float l = fmaxf(sL[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) ob[qp * so.s + tx + 16 * j] = acc[i][j] / l;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), K/V by TMA
// ---------------------------------------------------------------------------

constexpr int kWG = 128;                // threads of a warpgroup
constexpr int kRows = 64;               // query rows of a warpgroup
constexpr int kCols = 64;               // bf16 columns of a 128-byte row
constexpr int kBox = 64 * kCols * 2;    // one 64-row box: 8 KiB
constexpr float kLog2e = 1.4426950408889634f;
// a row's running max moves only when a tile's max passes it by more than
// this (log2 units), so P stays below 2^8 and most tiles leave O as it is
constexpr float kLazy = 8.f;

template <int HD>
struct Cfg {
  // consumer warpgroups a block, beside one producer warpgroup: registers
  // allow three below hd 256
  static constexpr int kWGs = HD > 128 ? 2 : 3;
  static constexpr int kThreads = (kWGs + 1) * kWG;
  // registers a thread after setmaxnreg: the producer's 128 threads give
  // theirs to the consumers (65,536 a block)
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = kWGs == 2 ? 240 : 160;
  static constexpr int kChunks = (HD + kCols - 1) / kCols;  // boxes a row
  static constexpr int kStages = HD > 128 ? 2 : 4;
  static constexpr int kQBytes = kWGs * kChunks * kBox;
  static constexpr int kKBytes = kChunks * kBox;   // one K (or V) slot
  static constexpr int kBars = 1 + 4 * kStages;    // Q; K, V full / empty
  // 1 KiB of slack aligns the swizzled tiles to 1024 bytes
  static constexpr size_t kSmem =
      1024 + kQBytes + size_t(kStages) * 2 * kKBytes + 8 * kBars;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Arrives where `pred` holds, as one predicated instruction: no branch
// that would split the warpgroup between its asynchronous products.
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(int(pred))
      : "memory");
}

// Waits for the phase of the given parity to complete, the loop inside
// one asm block. A TMA transaction that never lands would otherwise spin
// forever: after 2^26 tries (seconds) the kernel traps, so the launch
// fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.lt.u32 p, n, 67108864;\n"
      "@p bra WAIT;\n"
      "trap;\n"
      "DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One box of a 4-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (in 16-byte units), swizzle 1.
// K-major operands (Q, K) step 8-row groups by `sbo`; V, read transposed,
// steps its 8-key groups by `sbo` too, and each product touches one
// 64-column slice of it, so `lbo` (the next slice) is never used.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
// pins registers to this point of the program: accumulators after a wait
// are not read before it, in-flight operands are not reused before it
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define D8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64, fp32) (+)= A (64 x 16) B (16 x 64); A and B K-major in
// shared memory; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64) += A (64 x 16, bf16 pairs in registers) B (16 x 64), B
// MN-major (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the same with N = 48: the last 48 columns of hd 112
__device__ __forceinline__ void wgmma_rs_n48(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef D8

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Grid (q tiles, head units, B), latest q tile first. Warpgroup 0 loads;
// consumer warpgroup c takes 64 query rows: in pair mode (two consumers,
// H / Hkv even) rows q0..q0+63 of query head 2 y + c, otherwise rows
// q0 + 64 c.. of head y.
template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::kThreads, 1)
    swa_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     __nv_bfloat16* __restrict__ o, Strides so, int group,
                     int pair, int Sq, int Skv, int causal, int window,
                     float cap, float scale) {
  using C = Cfg<HD>;
  constexpr int NWG = C::kWGs, NCH = C::kChunks, ST = C::kStages;
  constexpr int KS = HD / 16;      // k16 steps of S = Q K^T
  constexpr int NO = HD / 2;       // O accumulators a thread (HD / 8 x 4)

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = base;                         // [consumer][chunk] boxes
  uint8_t* sK = sQ + C::kQBytes;              // [stage][chunk] boxes
  uint8_t* sV = sK + ST * C::kKBytes;         // [stage][chunk] boxes
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sV + ST * C::kKBytes);
  uint64_t* full_k = qbar + 1;
  uint64_t* full_v = full_k + ST;
  uint64_t* empty_k = full_v + ST;
  uint64_t* empty_v = empty_k + ST;

  // the warpgroup and warp indices through a shuffle, so the compiler
  // knows them uniform and the branches on them split no warpgroup
  const int tid = threadIdx.x, t = tid % kWG;
  const int wg = __shfl_sync(0xffffffffu, tid / kWG, 0);
  const int rows_blk = pair ? kRows : NWG * kRows;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * rows_blk;
  const int h0 = pair ? 2 * blockIdx.y : blockIdx.y;   // the block's first head
  const int b = blockIdx.z, hk = h0 / group;

  // the band of keys any row of the block may see
  const int q_last = min(q0 + rows_blk, Sq) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(q_last, Skv - 1) : Skv - 1;
  const int n_tiles = k_hi >= k_lo ? (k_hi - k_lo) / kBK + 1 : 0;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], NWG);
      mbar_init(&empty_v[s], NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every load, K and V rings ST deep
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(C::kProducerRegs));
    if (t == 0) {
      const int live = pair ? 2 : min(NWG, (Sq - q0 + kRows - 1) / kRows);
      mbar_expect_tx(qbar, live * NCH * kBox);
      for (int c = 0; c < live; ++c)
        for (int x = 0; x < NCH; ++x)
          tma_load(sQ + (c * NCH + x) * kBox, &tq, qbar, x * kCols,
                   pair ? q0 : q0 + c * kRows, pair ? h0 + c : h0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST, k0 = k_lo + j * kBK;
        const uint32_t free_ph = ((j / ST) & 1) ^ 1;  // tile j - ST's release
        if (j >= ST) mbar_wait(&empty_k[s], free_ph);
        mbar_expect_tx(&full_k[s], C::kKBytes);
        for (int x = 0; x < NCH; ++x)
          tma_load(sK + s * C::kKBytes + x * kBox, &tk, &full_k[s],
                   x * kCols, k0, hk, b);
        if (j >= ST) mbar_wait(&empty_v[s], free_ph);
        mbar_expect_tx(&full_v[s], C::kKBytes);
        for (int x = 0; x < NCH; ++x)
          tma_load(sV + s * C::kKBytes + x * kBox, &tv, &full_v[s],
                   x * kCols, k0, hk, b);
      }
    }
    return;
  }

  // consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(C::kConsumerRegs));
  const int cw = wg - 1, lane = t % 32;
  const int warp = __shfl_sync(0xffffffffu, t / 32, 0);
  const int h = pair ? h0 + cw : h0;                   // this warpgroup's
  const int qa = pair ? q0 : q0 + cw * kRows;
  const int qb = min(qa + kRows, Sq) - 1;              // its last real row
  const bool live = qa < Sq;

  // the tiles this warpgroup computes, [jf, jl]: the others are wholly
  // outside its rows' band (past the causal edge or before the window)
  int jf = n_tiles, jl = -1;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_lo + j * kBK;
    const bool out = !live || (causal && k0 > qb) ||
                     (window > 0 && k0 + kBK - 1 <= qa - window);
    if (!out) {
      jf = min(jf, j);
      jl = j;
    }
  }

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m0 = kMInit, m1 = kMInit, l0 = 0.f, l1 = 0.f;  // log2 domain
  const int r0 = qa + warp * 16 + lane / 4, r1 = r0 + 8;  // my two rows
  const int cq = 2 * (lane % 4);   // my first column of each n8 block
  // scores in the log2 domain: t = x * sl, or with the softcap
  // t = cap log2e - 2 cap log2e / (1 + 2^(x * su))
  const float sl = scale * kLog2e;
  const float su = cap > 0.f ? 2.f * scale * kLog2e / cap : 0.f;
  const float c1 = cap * kLog2e, c2 = 2.f * cap * kLog2e;
  const uint32_t q_base = smem_u32(sQ + cw * NCH * kBox);
  const bool leader = t == 0;   // arrives for the warpgroup

  // the consumers take turns issuing their products, round robin (named
  // barrier 1 + c is consumer c's turn; one turn a tile, in every path),
  // so one's softmax runs under the others' products; the last consumer
  // lets consumer 0 go first
  auto turn_begin = [&] { named_sync(1 + cw, 2 * kWG); };
  auto turn_end = [&] { named_arrive(1 + (cw + 1) % NWG, 2 * kWG); };
  if (cw == NWG - 1) named_arrive(1, 2 * kWG);

  float sc[32];      // S of the newest tile, then its P in fp32
  uint32_t pa[16];   // P of the tile whose P V is next, bf16 pairs
  // S = Q K^T of tile j, issued and committed
  auto issue_s = [&](int j) {
    const uint32_t k_base = smem_u32(sK + (j % ST) * C::kKBytes);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
      wgmma_ss_n64(sc, sw128_desc(q_base + off, 16, 1024),
                   sw128_desc(k_base + off, 16, 1024), kk > 0);
    }
    wg_commit();
  };
  // O += P V of tile j, issued and committed
  auto issue_pv = [&](int j) {
    const uint32_t v_base = smem_u32(sV + (j % ST) * C::kKBytes);
    pin<NO>(acc);
    wg_fence();
#pragma unroll
    for (int x = 0; x < NCH; ++x) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv =
            sw128_desc(v_base + x * kBox + kk * 16 * 128, 1024, 1024);
        if (x * kCols + kCols <= HD)
          wgmma_rs_n64(acc + 32 * x, pa + 4 * kk, dv);
        else
          wgmma_rs_n48(acc + 32 * x, pa + 4 * kk, dv);
      }
    }
    wg_commit();
  };
  // S of tile j (landed in sc) -> P in sc; returns the rows' corrections
  // and whether any row of the warp moved its max
  auto softmax = [&](int j, float& corr0, float& corr1, bool& moved) {
    const int k0 = k_lo + j * kBK;
    // softcap (sc becomes t, mul = 1) or not (sc stays x, mul = sl: the
    // scale rides in the exponent's FFMA); mask only where the tile
    // crosses the band's edge
    float mul = 1.f;
    if (cap > 0.f) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        sc[i] = c1 - c2 * rcp(1.f + ex2(sc[i] * su));
    } else {
      mul = sl;
    }
    const bool clean = k0 + kBK <= Skv && (!causal || k0 + kBK - 1 <= qa) &&
                       (window <= 0 || k0 > qb - window);
    if (!clean) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = (i & 2) ? r1 : r0;
        const int key = k0 + 8 * (i / 4) + cq + (i & 1);
        const bool ok = key < Skv && (!causal || key <= row) &&
                        (window <= 0 || key > row - window);
        if (!ok) sc[i] = -INFINITY;
      }
    }
    // online softmax over my two rows; a quad of lanes shares a row. mul
    // > 0, so the max of sc times mul is the max of t
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      mx0 = fmaxf(mx0, fmaxf(sc[i], sc[i + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[i + 2], sc[i + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    mx0 *= mul;
    mx1 *= mul;
    mx0 = mx0 > m0 + kLazy ? mx0 : m0;   // m0 + kLazy is m0 at -1e30
    mx1 = mx1 > m1 + kLazy ? mx1 : m1;
    moved = __any_sync(0xffffffffu, mx0 != m0 || mx1 != m1);
    corr0 = ex2(m0 - mx0);
    corr1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      sc[i] = ex2(fmaf(sc[i], mul, -mx0));
      sc[i + 1] = ex2(fmaf(sc[i + 1], mul, -mx0));
      sc[i + 2] = ex2(fmaf(sc[i + 2], mul, -mx1));
      sc[i + 3] = ex2(fmaf(sc[i + 3], mul, -mx1));
      sum0 += sc[i] + sc[i + 1];
      sum1 += sc[i + 2] + sc[i + 3];
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
  };
  // O waits for P V of the newest tile at its running max (a warp none
  // of whose rows moved skips the rescale); P as the A fragments of four
  // k16 steps (the accumulator layout of n8 blocks 2kk and 2kk + 1 is the
  // A layout of k16 step kk)
  auto rescale_and_pack = [&](float corr0, float corr1, bool moved) {
    if (moved) {
#pragma unroll
      for (int i = 0; i < NO; i += 4) {
        acc[i] *= corr0;
        acc[i + 1] *= corr0;
        acc[i + 2] *= corr1;
        acc[i + 3] *= corr1;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[4 * kk + 0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[4 * kk + 1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[4 * kk + 2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[4 * kk + 3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };
  // a tile outside [jf, jl]: its phases waited in order, its slots freed
  auto pass = [&](int j) {
    const int s = j % ST;
    const uint32_t ph = (j / ST) & 1;
    mbar_wait(&full_k[s], ph);
    turn_begin();
    turn_end();
    mbar_arrive_if(&empty_k[s], leader);
    mbar_wait(&full_v[s], ph);
    mbar_arrive_if(&empty_v[s], leader);
  };

  mbar_wait(qbar, 0);
  for (int j = 0; j < jf; ++j) pass(j);
  if (jf <= jl) {
    float corr0, corr1;
    bool moved;
    {   // the first tile: S only
      const int s = jf % ST;
      mbar_wait(&full_k[s], (jf / ST) & 1);
      turn_begin();
      issue_s(jf);
      turn_end();
      wg_wait<0>();
      pin<32>(sc);
      mbar_arrive_if(&empty_k[s], leader);
      softmax(jf, corr0, corr1, moved);
      rescale_and_pack(corr0, corr1, moved);
    }
    for (int j = jf + 1; j <= jl; ++j) {
      // S of tile j and P V of tile j - 1 together; the softmax of S
      // runs while P V does
      const int s = j % ST, sp = (j - 1) % ST;
      mbar_wait(&full_k[s], (j / ST) & 1);
      mbar_wait(&full_v[sp], ((j - 1) / ST) & 1);
      turn_begin();
      issue_s(j);
      issue_pv(j - 1);
      turn_end();
      wg_wait<1>();
      pin<32>(sc);
      mbar_arrive_if(&empty_k[s], leader);
      softmax(j, corr0, corr1, moved);
      wg_wait<0>();
      pin<NO>(acc);
      pin<16>(pa);
      mbar_arrive_if(&empty_v[sp], leader);
      rescale_and_pack(corr0, corr1, moved);
    }
    {   // the last tile's P V
      const int sp = jl % ST;
      mbar_wait(&full_v[sp], (jl / ST) & 1);
      issue_pv(jl);
      wg_wait<0>();
      pin<NO>(acc);
      pin<16>(pa);
      mbar_arrive_if(&empty_v[sp], leader);
    }
  }
  for (int j = max(jl + 1, jf); j < n_tiles; ++j) pass(j);

  // O / l, rows past Sq never written
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < NO; i += 4) {
    const int col = 8 * (i / 4) + cq;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * so.s + col) =
          __floats2bfloat162_rn(acc[i] * inv0, acc[i + 1] * inv0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * so.s + col) =
          __floats2bfloat162_rn(acc[i + 2] * inv1, acc[i + 3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// codes of this file's own, above any cudaError_t
constexpr int kErrNoEncode = 10000;    // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = 10001;      // + the CUresult it returned

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map (hd, S, H, B) over a strided bf16 view, boxes of 64 columns
// x 64 rows, 128-byte swizzle, out-of-bounds elements read as zero.
int make_map(CUtensorMap* map, const void* ptr, int hd, int S, int H, int B,
             Strides st) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return kErrNoEncode;
  const cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(S), cuuint64_t(H),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(st.s) * 2, cuuint64_t(st.h) * 2,
                                 cuuint64_t(st.b) * 2};
  const cuuint32_t box[4] = {kCols, 64, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + int(r);
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               Strides sq, Strides sk, Strides sv, Strides so, int B, int H,
               int Hkv, int Sq, int Skv, int causal, int window, float cap,
               float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      swa_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  swa_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk, sv, so,
      H / Hkv, Sq, Skv, causal, window, cap, scale);
  return int(cudaGetLastError());
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                Strides sq, Strides sk, Strides sv, Strides so, int B, int H,
                int Hkv, int Sq, int Skv, int causal, int window, float cap,
                float scale, cudaStream_t stream) {
  using C = Cfg<HD>;
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, HD, Sq, H, B, sq);
  if (!err) err = make_map(&tk, k, HD, Skv, Hkv, B, sk);
  if (!err) err = make_map(&tv, v, HD, Skv, Hkv, B, sv);
  if (err) return err;
  err = int(cudaFuncSetAttribute(swa_wgmma_kernel<HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 int(C::kSmem)));
  if (err) return err;
  const int group = H / Hkv, pair = C::kWGs == 2 && group % 2 == 0;
  const int rows = pair ? kRows : C::kWGs * kRows;
  const dim3 grid((Sq + rows - 1) / rows, pair ? H / 2 : H, B);
  swa_wgmma_kernel<HD><<<grid, C::kThreads, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), so, group, pair, Sq, Skv,
      causal, window, cap, scale);
  return int(cudaGetLastError());
}

template <bool BF16>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                Strides sq, Strides sk, Strides sv, Strides so, int B, int H,
                int Hkv, int Sq, int Skv, int causal, int window, float cap,
                float scale, cudaStream_t stream) {
#define SWA_CASE(HD)                                                        \
  case HD:                                                                  \
    return BF16 ? launch_bf16<HD>(q, k, v, o, sq, sk, sv, so, B, H, Hkv,   \
                                  Sq, Skv, causal, window, cap, scale,     \
                                  stream)                                  \
                : launch_f32<HD>(q, k, v, o, sq, sk, sv, so, B, H, Hkv, Sq,\
                                 Skv, causal, window, cap, scale, stream);
  switch (hd) {
    SWA_CASE(64)
    SWA_CASE(112)  // zamba2-7b's shared attention
    SWA_CASE(128)
    SWA_CASE(256)
    default:
      return int(cudaErrorInvalidValue);
  }
#undef SWA_CASE
}

}  // namespace

extern "C" {

// strides: 4 x (b, h, s) element strides for q, k, v, o; dtype 0 = float32,
// 1 = bfloat16 (the wgmma kernel: 16-byte aligned bases and strides that
// are multiples of 8 elements, which the wrapper checks); scale = hd^-0.5
// rounded to float by the caller, as the reference rounds it.
int swa_attention_fwd(const void* q, const void* k, const void* v, void* o,
                      const long long* strides, int B, int H, int Hkv, int Sq,
                      int Skv, int hd, int dtype, int causal, int window,
                      float cap, float scale, void* stream) {
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<false>(hd, q, k, v, o, sq, sk, sv, so, B, H, Hkv, Sq,
                              Skv, causal, window, cap, scale, st);
  if (dtype == 1)
    return dispatch_hd<true>(hd, q, k, v, o, sq, sk, sv, so, B, H, Hkv, Sq,
                             Skv, causal, window, cap, scale, st);
  return int(cudaErrorInvalidValue);
}

const char* swa_error_string(int code) {
  if (code == kErrNoEncode)
    return "cuTensorMapEncodeTiled is not available from the driver";
  if (code >= kErrEncode)
    return "cuTensorMapEncodeTiled refused a tensor map (the CUresult is "
           "the code minus 10001)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

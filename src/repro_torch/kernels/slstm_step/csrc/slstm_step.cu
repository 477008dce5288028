// sLSTM recurrence on Hopper (sm_90a): the port of
// src/repro/kernels/slstm_step/slstm_step.py:79 slstm_steps (body _kernel).
//
// Inputs: the pre-computed input gate projections g_in (B, T, H, 4P), the
// block-diagonal recurrent weights R (H, P, 4P) and the state (c, n, h, m),
// each (B, H, P), all fp32. Per step t, per (b, head):
//   g  = g_in[b, t, head] + h @ R[head]           (4P: z, i, f, o)
//   m' = max(f + m, i);  ie = exp(i - m');  fe = exp(f + m - m')
//   c  = fe c + ie tanh(z);  n = fe n + ie;  h = sigmoid(o) c / max(n, 1e-6)
// h_t goes to out[b, t, head] (B, T, H, P) and the final state is written
// once. The math is fp32 with expf / tanhf (this source is not built with
// --use_fast_math): with m = -1e30 at the start, exp(f + m - m') is exactly
// 0, as in the reference.
//
// Design. The TPU kernel walks a grid (B, H, T / t_blk) in order, with R
// pinned in VMEM and the state carried across grid steps in scratch. Here
// the time loop lives inside the kernel (one launch runs exactly T steps:
// no padding, no t_valid mask), and each head's R stays on chip for the
// whole launch, split across the C blocks of a thread-block cluster. One
// head's R is 4P^2 floats (4 MiB at P = 512), more than one SM's 227 KB.
//   - Partition by state slice. Block r of a head's cluster owns the S =
//     P / C state elements [r S, (r + 1) S) and holds R's 4S columns for
//     them (z, i, f, o at p, P + p, 2P + p, 3P + p) over all P rows k, so
//     it finishes its own gates with no reduction across blocks.
//   - All G = 4 batch rows of a batch group in one cluster: they share R,
//     so each element of R read from shared memory or a register feeds G
//     FMAs. A B above G runs further clusters (grid z), which run
//     independently; the tail group's missing rows hold h = 0 and are
//     never stored.
//   - One thread per block column (4S threads): it forms the column of
//     h @ R for the G rows as G fmaf chains, each over k = 0 .. P - 1 in
//     order from 0, and the gate step adds it to g_in. That is the order
//     of a single sequential dot product, so the kernel gives the same
//     bits as a kernel that walks every k for one column (its sums are
//     not split, and the recurrence's chaotic heads amplify any change of
//     rounding over thousands of steps). The G chains are the thread's
//     independent work: with one warp per scheduler at 128 threads, the
//     chains' latency, not the FMA rate, sets the pace.
//   - R on chip, loaded once a launch. Rows k < KR live in registers
//     (rr[KR] per thread, statically indexed in a fully unrolled loop),
//     rows k >= KR in shared memory (cp.async, 16 B each). At P = 512,
//     C = 16: 128 columns a block; rows 0-127 in registers (128 a thread),
//     rows 128-511 in shared memory (192 KiB), plus h's double buffer
//     (16 KiB), the columns' sums (2 KiB) and two mbarriers.
//   - h through distributed shared memory. Each block keeps the whole h
//     of its G rows, double-buffered, and one mbarrier per buffer. After
//     its gates, gate thread (b, j) stores its h into buffer (t + 1) & 1
//     of every block of the cluster with st.async (mapa gives the peer's
//     address; a warp's 32 lanes send 128 contiguous bytes to each peer),
//     and each store counts its 4 bytes on that peer's mbarrier for the
//     buffer (complete_tx). A block starts step t + 1 when its mbarrier
//     has counted all nb P 4 bytes of h_t, from every block: each block
//     waits only for the data it needs, not on a barrier across the
//     cluster. That is the whole synchronisation of a step:
//       * one thread re-arms a buffer's mbarrier (arrive.expect_tx) right
//         after the wait for it, before the block sends anything, so no
//         store of the next use can reach the mbarrier before it is armed;
//       * a block writes a peer's buffer (t + 1) & 1 only after it has
//         received that peer's h_t, which the peer sent after it had read
//         the buffer for the last time (step t - 1): double-buffering is
//         enough, with no barrier against overwriting;
//       * each block passes one cluster barrier before the loop (every
//         block of the cluster running and its mbarriers set) and one
//         after it (no store still in flight into a block that exits).
//     The alternative, st.shared::cluster stores and one barrier.cluster
//     arrive.release / wait.acquire a step, is slower: the cluster barrier
//     costs more than the exchange it guards (chip_smoke.py times both
//     with slstm_exchange_probe).
//   - The state of element (b, p) lives in gate thread (b, j)'s registers
//     for the whole launch; it reads (c, n, m) before the loop and writes
//     the final state after it, and each block reads all of h0 for its
//     rows before the first cluster barrier, which every block passes
//     before any writes its final h: the final state may alias the
//     initial one. g_in is read through its strides (the last axis
//     contiguous; the model's GEMM output stays a view), one step ahead.
//   - The instances: P = 8, 16, 32 (the reference's test cases; C = 1),
//     128 (the reduced config; C = 4) and 512 (xlstm-350m; C = 16, a
//     non-portable cluster size). slstm_step.py's geometry() states the
//     same table; the C entry refuses a geometry that does not match its
//     instance. No value passes through an atomic and every sum has a
//     fixed order, so two launches give the same bits.
//
// Bound: at the serving shape (B = 4, T = 4096, H = 4, P = 512) the
// function needs 2 B T H P 4P = 1.374e11 FLOP for h @ R (2.05 ms at the
// 67 TFLOP/s fp32 CUDA-core rate) and moves g_in 537 MB, out 134 MB and R
// 16.8 MB (0.21 ms at 3.35 TB/s): operations bound it. The steps are
// sequential, though, and the serving shape's one batch group fills H C =
// 64 of the 132 SMs: each SM does 2 G P 4S = 524,288 FLOP a step, 2048
// clocks at 128 fp32 FMA a clock (1.03 us at 1.98 GHz; 4.2 ms over 4096
// steps). Here each warp also issues a shared load of R and one of h per
// k (2944 issue slots a step at P = 512), and each chain's FMAs wait on
// each other. Above that each step pays the gate math (expf, tanhf, a
// division) on one thread per element, and the h exchange's latency,
// which no work of the step can hide: the next step's products all need
// the whole h_t.
//
// The C entries return cudaGetLastError() after the launch (or the first
// error before it); the Python wrapper raises when it is not cudaSuccess.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int G = 4;  // batch rows per cluster (a batch group)

// The geometry of one instance (slstm_step.py::geometry states it too).
template <int P>
struct Geo {
  static constexpr int C = P >= 512 ? 16 : (P >= 128 ? 4 : 1);  // cluster
  static constexpr int S = P / C;             // state elements a block owns
  static constexpr int NC = 4 * S;            // columns of R a block holds
  static constexpr int NT = NC;               // a thread per column
  static constexpr int KR = P >= 512 ? 128 : 0;   // rows k < KR: registers
  static constexpr int KS = P - KR;               // rows k >= KR: shared
  // R's shared rows, h's two buffers, the columns' sums, two mbarriers
  static constexpr int SMEM = 4 * (KS * NC + 2 * G * P + G * NC) + 16;
  static_assert(S % 4 == 0 && KR % 4 == 0 && KS % 4 == 0 && KS > 0 &&
                NT % 32 == 0, "rows and columns go in fours");
  static_assert(SMEM <= 232448, "more shared memory than a block may use");
};

struct Strides3 {  // element strides of (b, t, head); the last axis is 1
  long long b, t, h;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// the same shared address in block `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" :: "r"(addr), "f"(v)
               : "memory");
}

// every thread of every block of the cluster: writes before, reads after
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;"
               ::: "memory");
}

// an mbarrier with one arrival a phase: the arming thread's
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar)
               : "memory");
}

// arm the next phase: it completes when `bytes` have landed
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// wait for the phase of this parity; a phase that never completes (a
// fault) traps after ~2^26 tries instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long tries = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n\tselp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && ++tries > (1LL << 26)) __trap();
  } while (!done);
}

// store v at a peer's shared address and count its 4 bytes on the peer's
// mbarrier (both addresses from map_rank)
__device__ __forceinline__ void st_async(uint32_t addr, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" :: "r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

// grid (C, H, batch groups), clusters of (C, 1, 1): block r = cluster rank
// of head blockIdx.y, batch rows [G z, G z + G) of B
template <int P>
__global__ void __launch_bounds__(Geo<P>::NT, 1)
slstm_cluster_kernel(const float* __restrict__ g, const float* __restrict__ R,
                     const float* c0, const float* n0, const float* h0,
                     const float* m0, float* __restrict__ out, float* cf,
                     float* nf, float* hf, float* mf, Strides3 sg,
                     Strides3 so, int B, int H, int T) {
  using Q = Geo<P>;
  constexpr int S = Q::S, NC = Q::NC, KR = Q::KR, KS = Q::KS;
  extern __shared__ __align__(16) float smem[];
  float* Rs = smem;                    // [KS][NC]: rows KR.. of the slice
  float* hs = Rs + KS * NC;            // [2][G][P]: h, double-buffered
  float* gs = hs + 2 * G * P;          // [G][NC]: each column's h @ R
  const uint32_t bars = smem_u32(gs + G * NC);  // 2 mbarriers
  const int tid = threadIdx.x;
  const int r = static_cast<int>(cluster_rank());
  const int head = blockIdx.y;
  const int b0 = blockIdx.z * G;
  const int nb = min(G, B - b0);
  const float* Rh = R + static_cast<long long>(head) * P * 4 * P;

  // this block's rows KR.. of R into shared memory, 16 B a copy; block
  // column lc = q S + j is R's column q P + r S + j
  for (int e = tid; e < KS * NC / 4; e += Q::NT) {
    const int kk = e / (NC / 4), lc = e % (NC / 4) * 4;
    cp_async16(Rs + kk * NC + lc, Rh + static_cast<long long>(KR + kk) * 4 * P
                                      + lc / S * P + r * S + lc % S);
  }
  // h0 of the group's rows into buffer 0; rows past B and buffer 1 zero
  for (int e = tid; e < 2 * G * P; e += Q::NT) {
    const int buf = e / (G * P), b = e / P % G, k = e % P;
    hs[e] = buf == 0 && b < nb
                ? h0[(static_cast<long long>(b0 + b) * H + head) * P + k]
                : 0.f;
  }
  // column thread tid: block column tid, R's column q P + r S + j; its
  // rows k < KR in registers
  const float* Rc = Rh + tid / S * P + r * S + tid % S;
  float rr[KR > 0 ? KR : 1];
#pragma unroll
  for (int k = 0; k < KR; ++k) rr[k] = __ldg(Rc + k * 4 * P);
  // gate thread (gb, gj), the same threads: state element r S + gj of
  // batch row b0 + gb
  const int gb = tid / S, gj = tid % S;
  const bool live = gb < nb;
  long long si = 0;
  const float* gp = g;
  float* op = out;
  float c = 0.f, n = 0.f, h = 0.f, m = 0.f;
  float gz = 0.f, gi = 0.f, gf = 0.f, go = 0.f;
  if (live) {
    si = (static_cast<long long>(b0 + gb) * H + head) * P + r * S + gj;
    c = c0[si];
    n = n0[si];
    m = m0[si];
    gp = g + (b0 + gb) * sg.b + head * sg.h + r * S + gj;
    op = out + (b0 + gb) * so.b + head * so.h + r * S + gj;
    gz = gp[0];
    gi = gp[P];
    gf = gp[2 * P];
    go = gp[3 * P];
  }
  const uint32_t tx = static_cast<uint32_t>(nb) * P * 4;  // h_t's bytes
  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (T > 1) mbar_expect(bars + 8, tx);  // step 1's h
    if (T > 2) mbar_expect(bars, tx);      // step 2's h
  }
  cp_async_wait_all();
  __syncthreads();
  // every block of the cluster is running, its buffers are set, and every
  // block has read h0 before any block can write its final h
  cluster_sync();

  const float* Rt = Rs + tid;
  for (int t = 0; t < T; ++t) {
    const float* hc = hs + (t & 1) * G * P;
    const bool more = t + 1 < T;
    if (t > 0) {  // h_t from every block; re-arm for step t + 2's h
      mbar_wait(bars + 8 * (t & 1), ((t - 1) >> 1) & 1);
      if (tid == 0 && t + 2 < T) mbar_expect(bars + 8 * (t & 1), tx);
    }
    float nz = 0.f, ni = 0.f, nf_ = 0.f, no = 0.f;
    if (live && more) {  // the next step's inputs, a step ahead
      const float* gt = gp + (t + 1) * sg.t;
      nz = gt[0];
      ni = gt[P];
      nf_ = gt[2 * P];
      no = gt[3 * P];
    }
    // the column's dot product for the G rows: one fmaf chain each over
    // k = 0 .. P - 1 in order, register rows then shared rows
    float acc[G];
#pragma unroll
    for (int b = 0; b < G; ++b) acc[b] = 0.f;
#pragma unroll
    for (int k = 0; k < KR; k += 4) {
      float4 hv[G];
#pragma unroll
      for (int b = 0; b < G; ++b)
        hv[b] = *reinterpret_cast<const float4*>(hc + b * P + k);
#pragma unroll
      for (int b = 0; b < G; ++b) acc[b] = fmaf(hv[b].x, rr[k], acc[b]);
#pragma unroll
      for (int b = 0; b < G; ++b) acc[b] = fmaf(hv[b].y, rr[k + 1], acc[b]);
#pragma unroll
      for (int b = 0; b < G; ++b) acc[b] = fmaf(hv[b].z, rr[k + 2], acc[b]);
#pragma unroll
      for (int b = 0; b < G; ++b) acc[b] = fmaf(hv[b].w, rr[k + 3], acc[b]);
    }
#pragma unroll 8  // a full unroll holds more registers and runs slower
    for (int k = 0; k < KS; k += 4) {
      float4 hv[G];
#pragma unroll
      for (int b = 0; b < G; ++b)
        hv[b] = *reinterpret_cast<const float4*>(hc + b * P + KR + k);
      const float r0 = Rt[k * NC], r1 = Rt[(k + 1) * NC],
                  r2 = Rt[(k + 2) * NC], r3 = Rt[(k + 3) * NC];
#pragma unroll
      for (int b = 0; b < G; ++b) acc[b] = fmaf(hv[b].x, r0, acc[b]);
#pragma unroll
      for (int b = 0; b < G; ++b) acc[b] = fmaf(hv[b].y, r1, acc[b]);
#pragma unroll
      for (int b = 0; b < G; ++b) acc[b] = fmaf(hv[b].z, r2, acc[b]);
#pragma unroll
      for (int b = 0; b < G; ++b) acc[b] = fmaf(hv[b].w, r3, acc[b]);
    }
#pragma unroll
    for (int b = 0; b < G; ++b) gs[b * NC + tid] = acc[b];
    __syncthreads();
    if (live) {
      const float* gr = gs + gb * NC + gj;
      const float z_r = gz + gr[0], i_r = gi + gr[S], f_r = gf + gr[2 * S],
                  o_r = go + gr[3 * S];
      const float m_new = fmaxf(f_r + m, i_r);
      const float ie = expf(i_r - m_new);
      const float fe = expf(f_r + m - m_new);
      c = fe * c + ie * tanhf(z_r);
      n = fe * n + ie;
      h = (1.f / (1.f + expf(-o_r))) * c / fmaxf(n, 1e-6f);
      m = m_new;
      op[t * so.t] = h;
      if (more) {
        const uint32_t dst =
            smem_u32(hs + ((t + 1) & 1) * G * P + gb * P + r * S + gj);
        const uint32_t bar = bars + 8 * ((t + 1) & 1);
#pragma unroll
        for (int peer = 0; peer < Q::C; ++peer)
          st_async(map_rank(dst, peer), h, map_rank(bar, peer));
      }
      gz = nz;
      gi = ni;
      gf = nf_;
      go = no;
    }
  }
  if (T > 1) cluster_sync();  // no store in flight into a block that exits
  if (live) {
    cf[si] = c;
    nf[si] = n;
    hf[si] = h;
    mf[si] = m;
  }
}

// What a step of the P = 512 geometry pays to pass h around, with no
// arithmetic: grid (16, H, 1) in clusters of 16, 256 threads, the 128 gate
// threads of a block each sending one float to every block, one
// __syncthreads a step (the kernel's partial-sum pass), T steps. mode 0:
// a cluster barrier alone (no h sent); 1: st.shared::cluster into every
// peer, then a cluster barrier (a barrier-per-step design); 2: the
// kernel's exchange, st.async completing each peer's mbarrier, and a wait
// on its own.
__global__ void __launch_bounds__(256, 1)
slstm_exchange_probe_kernel(float* sink, int T, int mode) {
  constexpr int P = 512, S = 32, C = 16;
  __shared__ __align__(16) float hs[2][G][P];
  __shared__ __align__(8) unsigned long long bar_mem[2];
  const uint32_t bars = smem_u32(bar_mem);
  const uint32_t tx = G * P * 4;
  const int tid = threadIdx.x;
  for (int e = tid; e < 2 * G * P; e += 256) (&hs[0][0][0])[e] = 0.f;
  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (mode == 2 && T > 1) mbar_expect(bars + 8, tx);
    if (mode == 2 && T > 2) mbar_expect(bars, tx);
  }
  __syncthreads();
  cluster_sync();
  const int r = static_cast<int>(cluster_rank());
  const int gb = tid / S, gj = tid % S;
  float h = static_cast<float>(tid);
  for (int t = 0; t < T; ++t) {
    const bool more = t + 1 < T;
    if (mode == 2 && t > 0) {
      mbar_wait(bars + 8 * (t & 1), ((t - 1) >> 1) & 1);
      if (tid == 0 && t + 2 < T) mbar_expect(bars + 8 * (t & 1), tx);
    }
    __syncthreads();
    if (tid < G * S) {
      h = 0.5f * h + hs[t & 1][gb][r * S + gj];
      const uint32_t dst = smem_u32(&hs[(t + 1) & 1][gb][r * S + gj]);
      const uint32_t bar = bars + 8 * ((t + 1) & 1);
      if (more && mode == 1) {
#pragma unroll
        for (int peer = 0; peer < C; ++peer)
          st_cluster(map_rank(dst, peer), h);
      } else if (more && mode == 2) {
#pragma unroll
        for (int peer = 0; peer < C; ++peer)
          st_async(map_rank(dst, peer), h, map_rank(bar, peer));
      }
    }
    if (more && mode != 2) cluster_sync();
  }
  if (mode == 2 && T > 1) cluster_sync();
  if (tid < G * S) sink[(blockIdx.y * C + r) * G * S + tid] = h;
}

cudaLaunchAttribute cluster_attr(int C) {
  cudaLaunchAttribute a;
  a.id = cudaLaunchAttributeClusterDimension;
  a.val.clusterDim.x = C;
  a.val.clusterDim.y = 1;
  a.val.clusterDim.z = 1;
  return a;
}

template <typename K>
cudaError_t set_attrs(K kernel, int smem, int C) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && C > 8)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// set_attrs for slstm_cluster_kernel<P>, once per device (a decode step
// launches the kernel once a layer)
template <int P>
cudaError_t prepare() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && done[dev]) return cudaSuccess;
  e = set_attrs(slstm_cluster_kernel<P>, Geo<P>::SMEM, Geo<P>::C);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

// geo: C, G, rows in registers (KR), threads, dynamic shared bytes, as
// slstm_step.py::geometry gives them; any other geometry is refused
template <int P>
bool geometry_matches(const int* geo) {
  using Q = Geo<P>;
  return geo[0] == Q::C && geo[1] == G && geo[2] == Q::KR &&
         geo[3] == Q::NT && geo[4] == Q::SMEM;
}

template <int P>
int launch(const float* g, const float* R, const float* c0, const float* n0,
           const float* h0, const float* m0, float* out, float* cf,
           float* nf, float* hf, float* mf, Strides3 sg, Strides3 so, int B,
           int T, int H, const int* geo, cudaStream_t stream) {
  using Q = Geo<P>;
  if (!geometry_matches<P>(geo)) return int(cudaErrorInvalidConfiguration);
  const int groups = (B + G - 1) / G;
  if (H > 65535 || groups > 65535) return int(cudaErrorInvalidValue);
  cudaError_t e = prepare<P>();
  if (e != cudaSuccess) return int(e);
  cudaLaunchAttribute attr = cluster_attr(Q::C);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Q::C, H, groups);
  cfg.blockDim = dim3(Q::NT);
  cfg.dynamicSmemBytes = Q::SMEM;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, slstm_cluster_kernel<P>, g, R, c0, n0, h0, m0,
                         out, cf, nf, hf, mf, sg, so, B, H, T);
  const cudaError_t last = cudaGetLastError();
  return int(e != cudaSuccess ? e : last);
}

template <int P>
int max_clusters(int* count) {
  using Q = Geo<P>;
  cudaError_t e = prepare<P>();
  if (e != cudaSuccess) return int(e);
  cudaLaunchAttribute attr = cluster_attr(Q::C);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Q::C, 1, 1);
  cfg.blockDim = dim3(Q::NT);
  cfg.dynamicSmemBytes = Q::SMEM;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return int(cudaOccupancyMaxActiveClusters(
      count, reinterpret_cast<const void*>(slstm_cluster_kernel<P>), &cfg));
}

}  // namespace

extern "C" {

// s: 6 element strides, g_in (b, t, head) then out (b, t, head); the last
// axis of both is contiguous. R is contiguous (H, P, 4P) and 16-byte
// aligned; the eight state tensors are contiguous (B, H, P), and the final
// state may alias the initial one. geo: the 5 ints of geometry_matches.
int slstm_steps_fwd(const float* g, const float* R, const float* c0,
                    const float* n0, const float* h0, const float* m0,
                    float* out, float* cf, float* nf, float* hf, float* mf,
                    const long long* s, int B, int T, int H, int P,
                    const int* geo, void* stream) {
  if (B < 1 || T < 1 || H < 1) return int(cudaErrorInvalidValue);
  const Strides3 sg{s[0], s[1], s[2]};
  const Strides3 so{s[3], s[4], s[5]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 8:
      return launch<8>(g, R, c0, n0, h0, m0, out, cf, nf, hf, mf, sg, so, B,
                       T, H, geo, st);
    case 16:
      return launch<16>(g, R, c0, n0, h0, m0, out, cf, nf, hf, mf, sg, so, B,
                        T, H, geo, st);
    case 32:
      return launch<32>(g, R, c0, n0, h0, m0, out, cf, nf, hf, mf, sg, so, B,
                        T, H, geo, st);
    case 128:
      return launch<128>(g, R, c0, n0, h0, m0, out, cf, nf, hf, mf, sg, so,
                         B, T, H, geo, st);
    case 512:
      return launch<512>(g, R, c0, n0, h0, m0, out, cf, nf, hf, mf, sg, so,
                         B, T, H, geo, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// how many clusters of the P instance the card holds at once
int slstm_max_active_clusters(int P, int* count) {
  switch (P) {
    case 8: return max_clusters<8>(count);
    case 16: return max_clusters<16>(count);
    case 32: return max_clusters<32>(count);
    case 128: return max_clusters<128>(count);
    case 512: return max_clusters<512>(count);
    default: return int(cudaErrorInvalidValue);
  }
}

// slstm_exchange_probe_kernel over H heads, T steps, in `mode` (0, 1, 2);
// sink holds H * 16 * 128 floats
int slstm_exchange_probe(float* sink, int H, int T, int mode, void* stream) {
  if (H < 1 || T < 1 || mode < 0 || mode > 2)
    return int(cudaErrorInvalidValue);
  cudaError_t e = set_attrs(slstm_exchange_probe_kernel, 0, 16);
  if (e != cudaSuccess) return int(e);
  cudaLaunchAttribute attr = cluster_attr(16);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(16, H, 1);
  cfg.blockDim = dim3(256);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, slstm_exchange_probe_kernel, sink, T, mode);
  const cudaError_t last = cudaGetLastError();
  return int(e != cudaSuccess ? e : last);
}

const char* slstm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

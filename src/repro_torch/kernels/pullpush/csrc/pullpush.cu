// DPPF consensus stage on Hopper (sm_90a): the port of
// src/repro/kernels/pullpush/pullpush.py::fused_round (_fused_round_kernel),
// partial_gram (_partial_gram_kernel) and mix_shard (_mix_kernel), of the
// overlap modes' stale epilogue (the trainer's q + (mix_from_gram(s) - s),
// src/repro/train/trainer.py:387 and :449, as one pass), and of the
// per-vector pair the tree path runs, sq_dist (_sq_dist_kernel) and
// apply_update (_apply_kernel); the last two are described at their code.
//
// On a TPU the one pallas_call runs its grid in order, so phase 1 reads the
// Gram that phase 0 summed in VMEM. Blocks on Hopper do not wait on each
// other, so the stage is three launches on one stream:
//
//   pp_partial_gram  grid-stride over the columns of a row-major (R, n)
//                    view whose rows lie ld floats apart (ld = n for the
//                    whole view; a column chunk x[:, a:b] of the overlap
//                    modes is read in place, ld = the view's n); every
//                    column is centered on its row-0 value (e = x - x[0])
//                    and each block writes its own (R, R) partial sum of
//                    e e^T to a workspace. No float atomics: the result is
//                    the same from run to run.
//   pp_gram_coef     one block: sums the partials in a fixed order into G,
//                    then r_i = sqrt(max(G_ii - 2 (T G)_ii + (T G T^T)_ii, 0))
//                    and coef_i = c0_i + c1_i / max(r_i, eps).
//   pp_mix           per column: tx = T x, out = tx + (1 - coef)(x - tx).
//                    A thread reads all R rows of its columns before it
//                    writes them, so out may be x itself. Every operation
//                    is rounded on its own (__fmul_rn / __fadd_rn, tx
//                    summed over j = 0..R-1 in order), so the result equals
//                    ref.py's mix_shard_plain bit for bit.
//   pp_stale_mix     the same pass with a base operand q:
//                    out = q + (mix(x) - x), the stale delta of the overlap
//                    modes applied to the fresh view q in one pass (reads
//                    x and q, writes out: 3 R n 4 bytes). out may be x or
//                    q: each thread reads its columns of x and q before it
//                    writes them.
//
// Bound: both passes over the view are memory-bound (the Gram does R/2
// FMAs per float it reads, the mix R). The design moves each byte once:
// 16-byte loads (float4) with neighbouring threads on neighbouring columns,
// the row-0 centering and the R x R sums kept in registers, no padded copy
// of the view (the grid-stride loop bound masks the ragged edge).
//
// Every entry point returns cudaGetLastError() after its launch; the
// Python wrapper raises when it is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 32;

// rows 1..RB-1 form the Gram's non-trivial triangle (row 0 is centered on
// itself, so its row and column of G are exactly zero)
template <int RB>
struct Tri {
  static constexpr int kPairs = (RB - 1) * RB / 2;
};

__device__ __forceinline__ int tri_index(int a, int b, int rb) {
  // 1 <= a <= b < rb, row-major over the upper triangle of rows 1..rb-1
  const int n = rb - 1, i = a - 1, j = b - 1;
  return i * n - i * (i - 1) / 2 + (j - i);
}

template <int VEC>
struct Vec;

template <>
struct Vec<1> {
  __device__ __forceinline__ static void load(const float* p, float* v) {
    v[0] = p[0];
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    p[0] = v[0];
  }
};

template <>
struct Vec<4> {
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// ---------------------------------------------------------------------------
// partial Gram: ws[blockIdx.x] = sum over this block's columns of e e^T
// ---------------------------------------------------------------------------

template <int RB, int VEC>
__global__ void __launch_bounds__(kThreads)
partial_gram_kernel(const float* __restrict__ x, int R, long long n,
                    long long ld, float* __restrict__ ws) {
  constexpr int P = Tri<RB>::kPairs;
  __shared__ float sred[kWarps][P];

  float acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = 0.f;

  const long long groups = n / VEC;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
       g < groups; g += stride) {
    const long long c = g * VEC;
    float base[VEC];
    Vec<VEC>::load(x + c, base);
    float e[RB][VEC];
#pragma unroll
    for (int r = 1; r < RB; ++r) {
      if (r < R) {
        float v[VEC];
        Vec<VEC>::load(x + (long long)r * ld + c, v);
#pragma unroll
        for (int q = 0; q < VEC; ++q) e[r][q] = v[q] - base[q];
      } else {
#pragma unroll
        for (int q = 0; q < VEC; ++q) e[r][q] = 0.f;
      }
    }
    int p = 0;
#pragma unroll
    for (int a = 1; a < RB; ++a) {
#pragma unroll
      for (int b = a; b < RB; ++b) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < VEC; ++q) s = fmaf(e[a][q], e[b][q], s);
        acc[p] += s;
        ++p;
      }
    }
  }

  // fixed-order block reduction: warp shuffles, then warps in index order
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float v = acc[p];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) sred[warp][p] = v;
  }
  __syncthreads();
  float* out = ws + (long long)blockIdx.x * R * R;
  for (int idx = tid; idx < R * R; idx += kThreads) {
    const int i = idx / R, j = idx % R;
    float s = 0.f;
    if (i > 0 && j > 0) {
      const int p = tri_index(min(i, j), max(i, j), RB);
      for (int w = 0; w < kWarps; ++w) s += sred[w][p];
    }
    out[idx] = s;
  }
}

// ---------------------------------------------------------------------------
// Gram + coefficients: one block of kCoefThreads threads
// ---------------------------------------------------------------------------

constexpr int kCoefThreads = 1024;

__global__ void __launch_bounds__(kCoefThreads)
gram_coef_kernel(const float* __restrict__ ws, int nblk, int R,
                 const float* __restrict__ T, const float* __restrict__ c0,
                 const float* __restrict__ c1, float eps,
                 float* __restrict__ G, float* __restrict__ r_out,
                 float* __restrict__ coef_out) {
  __shared__ float part[kCoefThreads];
  __shared__ float sG[kMaxRows * kMaxRows];
  const int RR = R * R;
  // thread t sums entry t % RR over the blocks chunk, chunk + C, ...;
  // the C chunk sums are then added in chunk order (fixed order)
  const int C = kCoefThreads / RR > 0 ? kCoefThreads / RR : 1;
  const int t = static_cast<int>(threadIdx.x);
  if (t < RR * C) {
    const int entry = t % RR, chunk = t / RR;
    float s = 0.f;
#pragma unroll 8
    for (int b = chunk; b < nblk; b += C) s += ws[(long long)b * RR + entry];
    part[t] = s;
  }
  __syncthreads();
  if (t < RR) {
    float s = 0.f;
    for (int ch = 0; ch < C; ++ch) s += part[ch * RR + t];
    sG[t] = s;
    G[t] = s;
  }
  __syncthreads();
  if (T == nullptr || t >= R) return;
  // r^2_i = (e_i - T_i)^T G (e_i - T_i), as _fused_round_kernel's _coef
  const int i = t;
  const float diag_g = sG[i * R + i];
  float diag_tg = 0.f, diag_tgt = 0.f;
  for (int j = 0; j < R; ++j) diag_tg += T[i * R + j] * sG[i * R + j];
  for (int k = 0; k < R; ++k) {
    float tg = 0.f;
    for (int j = 0; j < R; ++j) tg += T[i * R + j] * sG[j * R + k];
    diag_tgt += tg * T[i * R + k];
  }
  const float r2 = diag_g - 2.f * diag_tg + diag_tgt;
  const float r = sqrtf(fmaxf(r2, 0.f));
  r_out[i] = r;
  coef_out[i] = c0[i] + c1[i] / fmaxf(r, eps);
}

// ---------------------------------------------------------------------------
// mix: out = T x + (1 - coef)(x - T x), column by column; with kStale,
// out = base + (that - x)
// ---------------------------------------------------------------------------

// x, base and out may share storage: no __restrict__ on them, so every
// load of a thread's columns stays ahead of its stores
template <int RB, int VEC, bool kStale>
__global__ void __launch_bounds__(kThreads)
mix_kernel(const float* x, int R, long long n, const float* __restrict__ T,
           const float* __restrict__ coef, const float* base, float* out) {
  __shared__ float sT[RB * RB];
  __shared__ float soc[RB];
  const int tid = threadIdx.x;
  for (int idx = tid; idx < RB * RB; idx += kThreads) {
    const int i = idx / RB, j = idx % RB;
    sT[idx] = (i < R && j < R) ? T[i * R + j] : 0.f;
  }
  if (tid < RB) soc[tid] = tid < R ? 1.f - coef[tid] : 0.f;
  __syncthreads();

  const long long groups = n / VEC;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
       g < groups; g += stride) {
    const long long c = g * VEC;
    float v[RB][VEC];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < R) {
        Vec<VEC>::load(x + (long long)r * n + c, v[r]);
      } else {
#pragma unroll
        for (int q = 0; q < VEC; ++q) v[r][q] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      if (i < R) {
        float b[VEC];
        if (kStale) Vec<VEC>::load(base + (long long)i * n + c, b);
        float o[VEC];
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          // one rounding per operation, in the plain version's order
          float tx = 0.f;
#pragma unroll
          for (int j = 0; j < RB; ++j)
            if (j < R) tx = __fadd_rn(tx, __fmul_rn(sT[i * RB + j], v[j][q]));
          const float m =
              __fadd_rn(tx, __fmul_rn(soc[i], __fsub_rn(v[i][q], tx)));
          o[q] = kStale ? __fadd_rn(b[q], __fsub_rn(m, v[i][q])) : m;
        }
        Vec<VEC>::store(out + (long long)i * n + c, o);
      }
    }
  }
}

int row_bucket(int R) {
  return R <= 4 ? 4 : R <= 8 ? 8 : R <= 16 ? 16 : 32;
}

bool valid_shape(int R, long long n, long long ld, int vec) {
  if (R < 1 || R > kMaxRows || n < 1 || ld < n) return false;
  if (vec == 4) return row_bucket(R) <= 8 && n % 4 == 0 && ld % 4 == 0;
  return vec == 1;
}

template <bool kStale>
int launch_mix(const float* x, int R, long long n, const float* T,
               const float* coef, const float* base, float* out, int nblk,
               int vec, cudaStream_t s) {
  const int rb = row_bucket(R);
  if (vec == 4 && rb == 4)
    mix_kernel<4, 4, kStale><<<nblk, kThreads, 0, s>>>(x, R, n, T, coef, base,
                                                       out);
  else if (vec == 4)
    mix_kernel<8, 4, kStale><<<nblk, kThreads, 0, s>>>(x, R, n, T, coef, base,
                                                       out);
  else if (rb == 4)
    mix_kernel<4, 1, kStale><<<nblk, kThreads, 0, s>>>(x, R, n, T, coef, base,
                                                       out);
  else if (rb == 8)
    mix_kernel<8, 1, kStale><<<nblk, kThreads, 0, s>>>(x, R, n, T, coef, base,
                                                       out);
  else if (rb == 16)
    mix_kernel<16, 1, kStale><<<nblk, kThreads, 0, s>>>(x, R, n, T, coef,
                                                        base, out);
  else
    mix_kernel<32, 1, kStale><<<nblk, kThreads, 0, s>>>(x, R, n, T, coef,
                                                        base, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// sq_dist and apply_update: one (n,) vector x against one (n,) vector a,
// each float32 or bfloat16 on its own (the tree path passes a bf16 worker
// leaf against the fp32 center), any n, any element offset.
//
// Bound: memory. sq_dist reads n (sizeof x + sizeof a) bytes once;
// apply_update reads x and a and writes x's type once. Both move each
// byte once: 8 elements a thread step, as 16-byte loads when both base
// pointers are 16-byte aligned (the wrapper decides, kVec8) and one
// element at a time otherwise; the ragged tail past the last whole group
// of 8 is a short scalar loop, so nothing is padded.
//
// sq_dist reduces without atomics, in a fixed order: every block writes
// its partial sum to a scratch slot (sq_dist_partial), one block adds the
// slots (sq_dist_final). The grid depends only on n and the card, so
// repeated calls give the same bits. A thread keeps 8 accumulators (one
// per lane of its group), which cuts the sequential chain 8-fold.
//
// apply_update computes x + (a - x) coef in fp32 with __fsub_rn /
// __fmul_rn / __fadd_rn, so no FMA is contracted and the result equals
// the plain version's three rounded operations bit for bit; coef is read
// from device memory (the tree path's coefficients are a device vector).
// out may be x: each thread reads its elements before it writes them.
// ---------------------------------------------------------------------------

constexpr int kGroup = 8;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 lo = reinterpret_cast<const float4*>(p)[0];
  const float4 hi = reinterpret_cast<const float4*>(p)[1];
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    v[2 * q] = f.x;
    v[2 * q + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// fixed-order sum over the block: warp shuffles, then the warps' sums in
// warp order by thread 0; returns the total in thread 0
template <int THREADS>
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float sw[THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sw[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) s += sw[w];
  return s;
}

template <typename TX, typename TA, bool kVec8>
__global__ void __launch_bounds__(kThreads)
sq_dist_partial_kernel(const TX* __restrict__ x, const TA* __restrict__ a,
                       long long n, float* __restrict__ partials) {
  float acc[kGroup];
#pragma unroll
  for (int q = 0; q < kGroup; ++q) acc[q] = 0.f;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  long long head = 0;
  if (kVec8) {
    const long long groups = n / kGroup;
    for (long long g = tid; g < groups; g += stride) {
      float xv[kGroup], av[kGroup];
      load8(x + g * kGroup, xv);
      load8(a + g * kGroup, av);
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        const float d = xv[q] - av[q];
        acc[q] = fmaf(d, d, acc[q]);
      }
    }
    head = groups * kGroup;
  }
  for (long long i = head + tid; i < n; i += stride) {
    const float d = to_f(x[i]) - to_f(a[i]);
    acc[0] = fmaf(d, d, acc[0]);
  }
  const float s = ((acc[0] + acc[1]) + (acc[2] + acc[3]))
                + ((acc[4] + acc[5]) + (acc[6] + acc[7]));
  const float total = block_sum<kThreads>(s);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

constexpr int kFinalThreads = 1024;

__global__ void __launch_bounds__(kFinalThreads)
sq_dist_final_kernel(const float* __restrict__ partials, int nblk,
                     float* __restrict__ out) {
  float s = 0.f;
  for (int b = threadIdx.x; b < nblk; b += kFinalThreads) s += partials[b];
  const float total = block_sum<kFinalThreads>(s);
  if (threadIdx.x == 0) out[0] = total;
}

template <typename TX, typename TA, bool kVec8>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const TX* x, const TA* __restrict__ a,
             const float* __restrict__ coef, TX* out, long long n) {
  const float c = coef[0];
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  long long head = 0;
  if (kVec8) {
    const long long groups = n / kGroup;
    for (long long g = tid; g < groups; g += stride) {
      float xv[kGroup], av[kGroup], o[kGroup];
      load8(x + g * kGroup, xv);
      load8(a + g * kGroup, av);
#pragma unroll
      for (int q = 0; q < kGroup; ++q)
        o[q] = __fadd_rn(xv[q], __fmul_rn(__fsub_rn(av[q], xv[q]), c));
      store8(out + g * kGroup, o);
    }
    head = groups * kGroup;
  }
  for (long long i = head + tid; i < n; i += stride) {
    const float xf = to_f(x[i]);
    out[i] = from_f<TX>(
        __fadd_rn(xf, __fmul_rn(__fsub_rn(to_f(a[i]), xf), c)));
  }
}

// dtype codes of the C interface: 0 = float32, 1 = bfloat16
template <template <typename, typename, bool> class Launch, typename... Args>
int dispatch_pair(int x_bf16, int a_bf16, int vec8, Args... args) {
  if (x_bf16 == 0 && a_bf16 == 0)
    return vec8 ? Launch<float, float, true>::run(args...)
                : Launch<float, float, false>::run(args...);
  if (x_bf16 == 1 && a_bf16 == 0)
    return vec8 ? Launch<__nv_bfloat16, float, true>::run(args...)
                : Launch<__nv_bfloat16, float, false>::run(args...);
  if (x_bf16 == 0 && a_bf16 == 1)
    return vec8 ? Launch<float, __nv_bfloat16, true>::run(args...)
                : Launch<float, __nv_bfloat16, false>::run(args...);
  if (x_bf16 == 1 && a_bf16 == 1)
    return vec8 ? Launch<__nv_bfloat16, __nv_bfloat16, true>::run(args...)
                : Launch<__nv_bfloat16, __nv_bfloat16, false>::run(args...);
  return (int)cudaErrorInvalidValue;
}

template <typename TX, typename TA, bool kVec8>
struct SqDistLaunch {
  static int run(const void* x, const void* a, long long n, float* partials,
                 int nblk, float* out, cudaStream_t s) {
    sq_dist_partial_kernel<TX, TA, kVec8><<<nblk, kThreads, 0, s>>>(
        static_cast<const TX*>(x), static_cast<const TA*>(a), n, partials);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    sq_dist_final_kernel<<<1, kFinalThreads, 0, s>>>(partials, nblk, out);
    return (int)cudaGetLastError();
  }
};

template <typename TX, typename TA, bool kVec8>
struct ApplyLaunch {
  static int run(const void* x, const void* a, const float* coef, void* out,
                 long long n, int nblk, cudaStream_t s) {
    apply_kernel<TX, TA, kVec8><<<nblk, kThreads, 0, s>>>(
        static_cast<const TX*>(x), static_cast<const TA*>(a), coef,
        static_cast<TX*>(out), n);
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// ws: (nblk, R, R) fp32 workspace, one partial Gram per block; the rows of
// x lie ld floats apart (ld >= n)
int pp_partial_gram(const float* x, int R, long long n, long long ld,
                    float* ws, int nblk, int vec, void* stream) {
  if (!valid_shape(R, n, ld, vec) || nblk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rb = row_bucket(R);
  if (vec == 4 && rb == 4)
    partial_gram_kernel<4, 4><<<nblk, kThreads, 0, s>>>(x, R, n, ld, ws);
  else if (vec == 4)
    partial_gram_kernel<8, 4><<<nblk, kThreads, 0, s>>>(x, R, n, ld, ws);
  else if (rb == 4)
    partial_gram_kernel<4, 1><<<nblk, kThreads, 0, s>>>(x, R, n, ld, ws);
  else if (rb == 8)
    partial_gram_kernel<8, 1><<<nblk, kThreads, 0, s>>>(x, R, n, ld, ws);
  else if (rb == 16)
    partial_gram_kernel<16, 1><<<nblk, kThreads, 0, s>>>(x, R, n, ld, ws);
  else
    partial_gram_kernel<32, 1><<<nblk, kThreads, 0, s>>>(x, R, n, ld, ws);
  return (int)cudaGetLastError();
}

// T == nullptr: only reduce the partials into G (r, coef, c0, c1 unused)
int pp_gram_coef(const float* ws, int nblk, int R, const float* T,
                 const float* c0, const float* c1, float eps, float* G,
                 float* r, float* coef, void* stream) {
  if (R < 1 || R > kMaxRows || nblk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gram_coef_kernel<<<1, kCoefThreads, 0, s>>>(ws, nblk, R, T, c0, c1, eps, G,
                                             r, coef);
  return (int)cudaGetLastError();
}

int pp_mix(const float* x, int R, long long n, const float* T,
           const float* coef, float* out, int nblk, int vec, void* stream) {
  if (!valid_shape(R, n, n, vec) || nblk < 1)
    return (int)cudaErrorInvalidValue;
  return launch_mix<false>(x, R, n, T, coef, nullptr, out, nblk, vec,
                           static_cast<cudaStream_t>(stream));
}

// out = base + (mix(x) - x); x, base and out are (R, n) row-major
int pp_stale_mix(const float* x, int R, long long n, const float* T,
                 const float* coef, const float* base, float* out, int nblk,
                 int vec, void* stream) {
  if (!valid_shape(R, n, n, vec) || nblk < 1 || base == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_mix<true>(x, R, n, T, coef, base, out, nblk, vec,
                          static_cast<cudaStream_t>(stream));
}

// partials: (nblk,) fp32 scratch; out: one fp32. vec8 needs x and a
// 16-byte aligned (the wrapper checks).
int pp_sq_dist(const void* x, int x_bf16, const void* a, int a_bf16,
               long long n, float* partials, int nblk, int vec8, float* out,
               void* stream) {
  if (n < 1 || nblk < 1) return (int)cudaErrorInvalidValue;
  return dispatch_pair<SqDistLaunch>(x_bf16, a_bf16, vec8, x, a, n, partials,
                                     nblk, out,
                                     static_cast<cudaStream_t>(stream));
}

// out has x's type and may be x; coef: one fp32 in device memory
int pp_apply(const void* x, int x_bf16, const void* a, int a_bf16,
             const float* coef, void* out, long long n, int nblk, int vec8,
             void* stream) {
  if (n < 1 || nblk < 1) return (int)cudaErrorInvalidValue;
  return dispatch_pair<ApplyLaunch>(x_bf16, a_bf16, vec8, x, a, coef, out, n,
                                    nblk, static_cast<cudaStream_t>(stream));
}

const char* pp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

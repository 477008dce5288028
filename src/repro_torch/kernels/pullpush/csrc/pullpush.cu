// DPPF consensus stage on Hopper (sm_90a): the port of
// src/repro/kernels/pullpush/pullpush.py::fused_round (_fused_round_kernel),
// partial_gram (_partial_gram_kernel) and mix_shard (_mix_kernel).
//
// On a TPU the one pallas_call runs its grid in order, so phase 1 reads the
// Gram that phase 0 summed in VMEM. Blocks on Hopper do not wait on each
// other, so the stage is three launches on one stream:
//
//   pp_partial_gram  grid-stride over the columns of the row-major (R, n)
//                    view; every column is centered on its row-0 value
//                    (e = x - x[0]) and each block writes its own (R, R)
//                    partial sum of e e^T to a workspace. No float atomics:
//                    the result is the same from run to run.
//   pp_gram_coef     one block: sums the partials in a fixed order into G,
//                    then r_i = sqrt(max(G_ii - 2 (T G)_ii + (T G T^T)_ii, 0))
//                    and coef_i = c0_i + c1_i / max(r_i, eps).
//   pp_mix           per column: tx = T x, out = tx + (1 - coef)(x - tx).
//                    A thread reads all R rows of its columns before it
//                    writes them, so out may be x itself.
//
// Bound: both passes over the view are memory-bound (the Gram does R/2
// FMAs per float it reads, the mix R). The design moves each byte once:
// 16-byte loads (float4) with neighbouring threads on neighbouring columns,
// the row-0 centering and the R x R sums kept in registers, no padded copy
// of the view (the grid-stride loop bound masks the ragged edge).
//
// Every entry point returns cudaGetLastError() after its launch; the
// Python wrapper raises when it is not cudaSuccess.

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
                    float* __restrict__ ws) {
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
        Vec<VEC>::load(x + (long long)r * n + c, v);
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
// mix: out = T x + (1 - coef)(x - T x), column by column
// ---------------------------------------------------------------------------

// x and out may be the same buffer: no __restrict__ on either, so every
// load of a thread's columns stays ahead of its stores
template <int RB, int VEC>
__global__ void __launch_bounds__(kThreads)
mix_kernel(const float* x, int R, long long n, const float* __restrict__ T,
           const float* __restrict__ coef, float* out) {
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
        float o[VEC];
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          float tx = 0.f;
#pragma unroll
          for (int j = 0; j < RB; ++j) tx = fmaf(sT[i * RB + j], v[j][q], tx);
          o[q] = tx + soc[i] * (v[i][q] - tx);
        }
        Vec<VEC>::store(out + (long long)i * n + c, o);
      }
    }
  }
}

int row_bucket(int R) {
  return R <= 4 ? 4 : R <= 8 ? 8 : R <= 16 ? 16 : 32;
}

bool valid_shape(int R, long long n, int vec) {
  if (R < 1 || R > kMaxRows || n < 1) return false;
  if (vec == 4) return row_bucket(R) <= 8 && n % 4 == 0;
  return vec == 1;
}

}  // namespace

extern "C" {

// ws: (nblk, R, R) fp32 workspace, one partial Gram per block
int pp_partial_gram(const float* x, int R, long long n, float* ws, int nblk,
                    int vec, void* stream) {
  if (!valid_shape(R, n, vec) || nblk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rb = row_bucket(R);
  if (vec == 4 && rb == 4)
    partial_gram_kernel<4, 4><<<nblk, kThreads, 0, s>>>(x, R, n, ws);
  else if (vec == 4)
    partial_gram_kernel<8, 4><<<nblk, kThreads, 0, s>>>(x, R, n, ws);
  else if (rb == 4)
    partial_gram_kernel<4, 1><<<nblk, kThreads, 0, s>>>(x, R, n, ws);
  else if (rb == 8)
    partial_gram_kernel<8, 1><<<nblk, kThreads, 0, s>>>(x, R, n, ws);
  else if (rb == 16)
    partial_gram_kernel<16, 1><<<nblk, kThreads, 0, s>>>(x, R, n, ws);
  else
    partial_gram_kernel<32, 1><<<nblk, kThreads, 0, s>>>(x, R, n, ws);
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
  if (!valid_shape(R, n, vec) || nblk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rb = row_bucket(R);
  if (vec == 4 && rb == 4)
    mix_kernel<4, 4><<<nblk, kThreads, 0, s>>>(x, R, n, T, coef, out);
  else if (vec == 4)
    mix_kernel<8, 4><<<nblk, kThreads, 0, s>>>(x, R, n, T, coef, out);
  else if (rb == 4)
    mix_kernel<4, 1><<<nblk, kThreads, 0, s>>>(x, R, n, T, coef, out);
  else if (rb == 8)
    mix_kernel<8, 1><<<nblk, kThreads, 0, s>>>(x, R, n, T, coef, out);
  else if (rb == 16)
    mix_kernel<16, 1><<<nblk, kThreads, 0, s>>>(x, R, n, T, coef, out);
  else
    mix_kernel<32, 1><<<nblk, kThreads, 0, s>>>(x, R, n, T, coef, out);
  return (int)cudaGetLastError();
}

const char* pp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

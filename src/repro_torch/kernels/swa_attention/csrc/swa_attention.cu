// Sliding-window flash attention, forward only, on Hopper (sm_90a): the
// port of src/repro/kernels/swa_attention/swa_attention.py::swa_attention
// (body _kernel).
//
// It computes swa_attention_ref: for q (B, H, Sq, hd) and k, v
// (B, Hkv, Skv, hd), query head h reads kv head h / (H / Hkv); the scores
// (q * hd^-0.5) . k are softcapped (tanh(s / cap) * cap when cap > 0) and
// masked to kpos < Skv, kpos <= qpos (causal) and kpos > qpos - window
// (window > 0); softmax and the product with v accumulate in fp32, and the
// output is written in the inputs' type.
//
// Design. One block of 256 threads per (q tile of 64 rows, head, batch),
// one template instance per head_dim: 64, 112 (zamba2-7b), 128 and 256.
// The block stages its Q tile once (scaled, fp32) in shared memory, then
// walks the kv band in tiles of 64 keys:
//   1. K and V tiles are staged in shared memory as fp32 (rows padded to
//      hd + 1 floats, so the column-wise reads hit 32 distinct banks);
//   2. S = Q K^T: each thread owns a 4 x 4 score micro-tile (rows ty + 16i,
//      columns tx + 16j), softcap and mask applied in registers, S written
//      to shared memory;
//   3. online softmax: four lanes per row find the tile's max, turn S into
//      P in place, and update the row's running max m, sum l and the
//      correction factor exp(m_old - m_new);
//   4. acc = acc * corr + P V: each thread owns 4 rows x hd/16 columns of
//      the accumulator in registers.
// Unlike the TPU kernel, which visits every kv grid step and skips the
// out-of-band ones with pl.when, the kv loop runs only over the band,
// from max(0, q0 - window + 1) to min(q_last, Skv - 1). There is no padded
// copy of q, k or v (the Pallas wrapper pads with jnp.pad): ragged edges are
// masked, and keys at kpos >= Skv never enter the softmax. Q tiles are
// visited latest first, so the causally heaviest blocks start in the first
// wave. Tensors are read through their strides (the last dim contiguous),
// so the model's (B, S, H, hd) layout needs no transposed copy.
//
// Bound: compute. At the serving shapes (S = 8160, hd = 256) the in-band
// pairs need ~4 hd FLOPs each against ~4 hd bytes of q/k/v/out per query
// row, far above the card's ~295 FLOP/byte balance. This first version runs
// its products on the CUDA cores in fp32 (no tensor cores), so it is far
// from the bf16 tensor-core bound; PERF.md records the gap.
//
// The C entry returns cudaGetLastError() after the launch; the Python
// wrapper raises when it is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per kv tile
constexpr int kLDS = kBK + 1;    // padded row stride of the score tile
constexpr float kMInit = -1e30f; // the reference's NEG_INF as the start of m

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {  // element strides of (B, H, S); the hd dim has stride 1
  long long b, h, s;
};

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(kBQ + 2 * kBK) * (HD + 1) + size_t(kBQ) * kLDS + 3 * kBQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    swa_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o, Strides sq,
               Strides sk, Strides sv, Strides so, int group, int Sq, int Skv,
               int causal, int window, float cap, float scale) {
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

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  T* ob = o + b * so.b + h * so.h;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, qp = q0 + r;
    sQ[r * LD + d] = qp < Sq ? to_f(qb[qp * sq.s + d]) * scale : 0.f;
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
      sK[r * LD + d] = in ? to_f(kb[kp * sk.s + d]) : 0.f;
      sV[r * LD + d] = in ? to_f(vb[kp * sv.s + d]) : 0.f;
    }
    __syncthreads();

    // 2. S = Q K^T on the 4 x 4 micro-tile, softcap and mask
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

    // 3. online softmax, four neighbouring lanes per row
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

    // 4. acc = acc * corr + P V
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
    for (int j = 0; j < DJ; ++j)
      ob[qp * so.s + tx + 16 * j] = from_f<T>(acc[i][j] / l);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, Strides sq,
           Strides sk, Strides sv, Strides so, int B, int H, int Hkv, int Sq,
           int Skv, int causal, int window, float cap, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      swa_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  swa_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, sv, so, H / Hkv,
      Sq, Skv, causal, window, cap, scale);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                Strides sq, Strides sk, Strides sv, Strides so, int B, int H,
                int Hkv, int Sq, int Skv, int causal, int window, float cap,
                float scale, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, o, sq, sk, sv, so, B, H, Hkv, Sq, Skv,
                           causal, window, cap, scale, stream);
    case 112:  // zamba2-7b's shared attention (7 x 16 columns a thread)
      return launch<T, 112>(q, k, v, o, sq, sk, sv, so, B, H, Hkv, Sq, Skv,
                            causal, window, cap, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, sq, sk, sv, so, B, H, Hkv, Sq, Skv,
                            causal, window, cap, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, sq, sk, sv, so, B, H, Hkv, Sq, Skv,
                            causal, window, cap, scale, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// strides: 4 x (b, h, s) element strides for q, k, v, o; dtype 0 = float32,
// 1 = bfloat16; scale = hd^-0.5 rounded to float by the caller, as the
// reference rounds it.
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
    return dispatch_hd<float>(hd, q, k, v, o, sq, sk, sv, so, B, H, Hkv, Sq,
                              Skv, causal, window, cap, scale, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, sq, sk, sv, so, B, H,
                                      Hkv, Sq, Skv, causal, window, cap, scale, st);
  return int(cudaErrorInvalidValue);
}

const char* swa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

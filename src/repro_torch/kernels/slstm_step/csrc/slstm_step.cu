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
// blocks run in parallel and in no order, so the time loop lives inside
// the block: one block per (b, head) runs all T steps of one launch, so
// the caller needs no padding and no t_valid mask (the Pallas wrapper pads
// T to its block and masks the tail). Thread p owns state element p (P
// threads, at least one warp): c, n, m and its h stay in registers for the
// whole sequence, and h is also kept in shared memory, double-buffered, so
// that each step needs one __syncthreads. Per step a thread reads its four
// gate inputs (z, i, f, o at p, P + p, 2P + p, 3P + p), forms its four
// columns of h @ R (neighbouring threads read neighbouring columns of R's
// row k, so each warp's loads are coalesced; h[k] is a shared-memory
// broadcast), applies the gates and writes h_t. R (4 MiB per head at
// P = 512) does not fit in one SM's 227 KB of shared memory: it streams
// from L2 every step, where the 16 MiB of all heads stays resident (50 MB
// L2). g_in and out are read and written through their strides (the last
// axis contiguous), so the model's (B, S, 4 d_in) GEMM output viewed as
// (B, S, H, 4P) needs no copy. The state may be updated in place: a
// thread reads its element of (c, n, h, m) before the loop and writes it
// after, and no other thread touches it. P is a template parameter (the
// loops unroll); the instances are P = 8, 16, 32 (the reference's test
// cases), 128 (the reduced config) and 512 (xlstm-350m).
//
// Bound: at the serving shape (B = 4, T = 4096, H = 4, P = 512) the
// function needs 2 B T H P 4P = 1.374e11 FLOP for h @ R (2.05 ms at the
// 67 TFLOP/s fp32 CUDA-core rate) and moves g_in 537 MB, out 134 MB and R
// 16.8 MB (0.21 ms at 3.35 TB/s): operations bound it. The T steps are
// sequential, though, and each step of a block streams its head's R from
// L2 into one SM, so this kernel runs far above that bound: the per-step
// time is one SM's L2 read rate over 4P^2 floats. Splitting a head's R
// across a thread-block cluster (DSMEM, one cluster barrier per step) is
// the next design.
//
// The C entry returns cudaGetLastError() after the launch; the Python
// wrapper raises when it is not cudaSuccess.

#include <cuda_runtime.h>
#include <math.h>

namespace {

struct Strides3 {  // element strides of (b, t, head); the last axis is 1
  long long b, t, h;
};

template <int P>
__global__ void __launch_bounds__(P < 32 ? 32 : P)
slstm_kernel(const float* __restrict__ g, const float* __restrict__ R,
             const float* c0, const float* n0, const float* h0,
             const float* m0, float* __restrict__ out, float* cf, float* nf,
             float* hf, float* mf, Strides3 sg, Strides3 so, int H, int T) {
  constexpr int G = 4 * P;
  __shared__ float hbuf[2][P];
  const int bh = blockIdx.x;  // b * H + head
  const int b = bh / H, head = bh % H;
  const int p = threadIdx.x;
  const bool own = p < P;
  const float* Rh = R + static_cast<long long>(head) * P * G;
  const long long si = static_cast<long long>(bh) * P + p;
  float c = 0.f, n = 0.f, h = 0.f, m = 0.f;
  if (own) {
    c = c0[si];
    n = n0[si];
    h = h0[si];
    m = m0[si];
    hbuf[0][p] = h;
  }
  __syncthreads();
  const float* gb = g + b * sg.b + head * sg.h;
  float* ob = out + b * so.b + head * so.h;
  for (int t = 0; t < T; ++t) {
    if (own) {
      const float* gt = gb + t * sg.t;
      const float gz = gt[p], gi = gt[P + p], gf = gt[2 * P + p],
                  go = gt[3 * P + p];
      const float* hs = hbuf[t & 1];
      float rz = 0.f, ri = 0.f, rf = 0.f, ro = 0.f;
#pragma unroll 8
      for (int k = 0; k < P; ++k) {
        const float hk = hs[k];
        const float* Rk = Rh + k * G + p;
        rz = fmaf(hk, __ldg(Rk), rz);
        ri = fmaf(hk, __ldg(Rk + P), ri);
        rf = fmaf(hk, __ldg(Rk + 2 * P), rf);
        ro = fmaf(hk, __ldg(Rk + 3 * P), ro);
      }
      const float z_r = gz + rz, i_r = gi + ri, f_r = gf + rf, o_r = go + ro;
      const float m_new = fmaxf(f_r + m, i_r);
      const float ie = expf(i_r - m_new);
      const float fe = expf(f_r + m - m_new);
      c = fe * c + ie * tanhf(z_r);
      n = fe * n + ie;
      h = (1.f / (1.f + expf(-o_r))) * c / fmaxf(n, 1e-6f);
      m = m_new;
      hbuf[(t + 1) & 1][p] = h;
      ob[t * so.t + p] = h;
    }
    // every thread has read hbuf[t & 1] and written hbuf[(t + 1) & 1]
    __syncthreads();
  }
  if (own) {
    cf[si] = c;
    nf[si] = n;
    hf[si] = h;
    mf[si] = m;
  }
}

template <int P>
int launch(const float* g, const float* R, const float* c0, const float* n0,
           const float* h0, const float* m0, float* out, float* cf,
           float* nf, float* hf, float* mf, Strides3 sg, Strides3 so, int B,
           int T, int H, cudaStream_t stream) {
  slstm_kernel<P><<<B * H, P < 32 ? 32 : P, 0, stream>>>(
      g, R, c0, n0, h0, m0, out, cf, nf, hf, mf, sg, so, H, T);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// s: 6 element strides, g_in (b, t, head) then out (b, t, head); the last
// axis of both is contiguous. R is contiguous (H, P, 4P); the eight state
// tensors are contiguous (B, H, P), and the final state may alias the
// initial one. P must be one of the template instances.
int slstm_steps_fwd(const float* g, const float* R, const float* c0,
                    const float* n0, const float* h0, const float* m0,
                    float* out, float* cf, float* nf, float* hf, float* mf,
                    const long long* s, int B, int T, int H, int P,
                    void* stream) {
  if (B < 1 || T < 1 || H < 1) return int(cudaErrorInvalidValue);
  const Strides3 sg{s[0], s[1], s[2]};
  const Strides3 so{s[3], s[4], s[5]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 8:
      return launch<8>(g, R, c0, n0, h0, m0, out, cf, nf, hf, mf, sg, so, B,
                       T, H, st);
    case 16:
      return launch<16>(g, R, c0, n0, h0, m0, out, cf, nf, hf, mf, sg, so, B,
                        T, H, st);
    case 32:
      return launch<32>(g, R, c0, n0, h0, m0, out, cf, nf, hf, mf, sg, so, B,
                        T, H, st);
    case 128:
      return launch<128>(g, R, c0, n0, h0, m0, out, cf, nf, hf, mf, sg, so,
                         B, T, H, st);
    case 512:
      return launch<512>(g, R, c0, n0, h0, m0, out, cf, nf, hf, mf, sg, so,
                         B, T, H, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

const char* slstm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

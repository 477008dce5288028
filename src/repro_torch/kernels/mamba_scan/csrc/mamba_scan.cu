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
// overflow). Tokens at or past t_valid (the ragged last chunk) read as zero
// x, B, C and a, exactly as the reference's zero padding: a = 0 leaves la
// flat, and zero x and B add nothing to the state. Their rows of y are not
// written, so the caller's tensor needs no padded tail.
//
// Design. G = C B^T (L x L) is the same for every head of a (b, chunk), so
// one block of 256 threads takes one (chunk, group of up to 16 heads,
// batch): it forms G^T once in shared memory, then loops over its heads.
// Per head it stages x (L x P) and a, scans a into la with one warp,
// builds S^T = (G o exp(la[t] - la[s]))^T (zero where s > t) in shared
// memory, and computes y = S x and the state x^T (B o rem) from register
// micro-tiles: a thread owns 8 consecutive rows x 4 consecutive columns of
// y (and an 8 x 8 tile of G^T, a 4 x 4 tile of the state), so each step of
// a product reads its operands as 16-byte vectors (S and G are kept
// transposed for that) and does 32 FMAs for 3 vector loads. Tiles are
// loaded into registers first, every load of a thread in flight at once,
// and the next head's x tile is loaded while this head's products run.
// Only causal pairs are computed: G^T tiles below the diagonal, S^T
// entries past a row tile and the y product's steps past it are skipped,
// as are rows at or past t_valid. The TPU kernel recomputes all of G on
// every grid step (40% of its work); here G's causal half costs about
// 1/32 of the block's work, once per group of 16 heads. Shared memory at
// L = 128, P = N = 64: G^T and S^T 2 x 128 x 132 floats, x and B
// 2 x 128 x 68, la and rem: 205,824 bytes, one block per SM (set with
// cudaFuncSetAttribute). Row pitches are
// multiples of 4 floats, so vector reads stay aligned. All inputs are read
// through their strides (the last axis contiguous), so the model's
// (Bt, S, H, P) / (Bt, S, N) / (Bt, S, H) tensors and the column slices of
// the conv output need no copy. The kernel takes L <= 128 (a multiple of
// 8) and P, N <= 64 (multiples of 4), the micro-tiles' extent; the wrapper
// checks them.
//
// Bound: at zamba2-7b's prefill shape (B = 4, S = 8160, H = 112,
// P = N = 64, L = 128, a 96-token last chunk) the inputs and outputs move
// 2.37 GB (0.71 ms at 3.35 TB/s) and the function needs 6.05e10 FLOP:
// y over the causal pairs only (2 P per pair and head), the state (2 P N
// per token and head), S = G o decay (one multiply per pair and head) and
// G's causal half once per (b, chunk). That is 0.90 ms at the 67 TFLOP/s
// fp32 CUDA-core rate (0.12 ms in TF32 on the tensor cores). This kernel
// runs on the CUDA cores in fp32, so operations bound it; chip_smoke.py
// computes the bound from its inputs and PERF.md records how far the
// kernel is from it.
//
// The C entry returns cudaGetLastError() after the launch; the Python
// wrapper raises when it is not cudaSuccess.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 128, kMaxP = 64, kMaxN = 64;
constexpr int kPad = 4;  // floats added to each shared-memory row

struct Strides4 {  // element strides of (b, h, c, l); the last axis is 1
  long long b, h, c, l;
};
struct Strides3 {  // element strides of (b, c, l)
  long long b, c, l;
};

// A (rows x cols) tile, row r at src + r * row_stride with the cols
// contiguous, is staged in two steps so that a thread's loads are all in
// flight together: load_tile issues up to kLoads loads per thread into
// registers (rows at or past nv read as zero), store_tile writes them to
// shared memory with row pitch ld (store_tile_t transposed: element (r, c)
// at dst[c * ld + r]). Thread t takes elements t, t + 256, ...
constexpr int kLoads = kMaxL * kMaxP / kThreads;  // 32 (also L x N tiles)

struct Walk {  // (row, col) of a thread's k-th element, stepped by 256
  int r, c, dr, dc, cols;
  __device__ explicit Walk(int cols_)
      : r(threadIdx.x / cols_), c(threadIdx.x % cols_),
        dr(kThreads / cols_), dc(kThreads % cols_), cols(cols_) {}
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

__device__ __forceinline__ void load_tile(float (&buf)[kLoads],
                                          const float* src,
                                          long long row_stride, int cols,
                                          int nv) {
  Walk w(cols);
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    buf[k] = w.r < nv ? src[w.r * row_stride + w.c] : 0.f;
    w.next();
  }
}

__device__ __forceinline__ void store_tile(const float (&buf)[kLoads],
                                           float* dst, int ld, int rows,
                                           int cols) {
  Walk w(cols);
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    if (w.r < rows) dst[w.r * ld + w.c] = buf[k];
    w.next();
  }
}

__device__ __forceinline__ void store_tile_t(const float (&buf)[kLoads],
                                             float* dst, int ld, int rows,
                                             int cols) {
  Walk w(cols);
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    if (w.r < rows) dst[w.c * ld + w.r] = buf[k];
    w.next();
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void unpack(float4 v, float* out) {
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

struct Layout {  // shared-memory regions, in floats from the base
  int LP, XP, BP, rows_s;
  size_t gt, st, x, b, la, rem, total;
  __host__ __device__ Layout(int L, int P, int N)
      : LP(L + kPad), XP(P + kPad), BP(N + kPad),
        rows_s(L > 2 * N ? L : 2 * N) {
    gt = 0;                          // L x LP: G^T[s][t]
    st = gt + size_t(L) * LP;        // rows_s x LP: B^T, C^T, then S^T
    x = st + size_t(rows_s) * LP;    // L x XP: x of one head
    b = x + size_t(L) * XP;          // L x BP
    la = b + size_t(L) * BP;         // L: la of one head
    rem = la + L;                    // L: exp(la[L-1] - la[s])
    total = rem + L;
  }
};

__global__ void __launch_bounds__(kThreads)
    ssd_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ a,
               float* __restrict__ y, float* __restrict__ st, Strides4 sx,
               Strides3 sb, Strides3 sc, Strides4 sa, Strides4 sy,
               Strides4 sst, int H, int L, int P, int N, int t_valid,
               int hpb) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout lay(L, P, N);
  const int LP = lay.LP, XP = lay.XP, BP = lay.BP;
  float* sGT = smem + lay.gt;
  float* sST = smem + lay.st;
  float* sBT = sST;                  // N x LP during the G^T product
  float* sCT = sST + N * LP;         // N x LP during the G^T product
  float* sX = smem + lay.x;
  float* sB = smem + lay.b;
  float* sLa = smem + lay.la;
  float* sRem = smem + lay.rem;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int c = blockIdx.x, b = blockIdx.z;
  const int h0 = blockIdx.y * hpb, h1 = min(h0 + hpb, H);
  // rows of this chunk that hold tokens (the rest read as zero)
  const int nv = max(0, min(L, t_valid - c * L));

  float buf[kLoads];
  load_tile(buf, Bm + b * sb.b + c * sb.c, sb.l, N, nv);
  store_tile(buf, sB, BP, L, N);
  store_tile_t(buf, sBT, LP, L, N);
  load_tile(buf, Cm + b * sc.b + c * sc.c, sc.l, N, nv);
  store_tile_t(buf, sCT, LP, L, N);
  // the first head's x is in flight while G^T is formed
  load_tile(buf, x + b * sx.b + h0 * sx.h + c * sx.c, sx.l, P, nv);
  __syncthreads();

  {  // G^T[s][t] = B[s] . C[t]: rows s0 .. s0 + 7, columns t0 .. t0 + 7
    const int s0 = 8 * ty, t0 = 8 * tx;
    if (s0 < L && t0 < L && s0 <= t0) {  // tiles with s0 > t0 are unread
      float g[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) g[i][j] = 0.f;
#pragma unroll 2
      for (int n = 0; n < N; ++n) {
        float bv[8], cv[8];
        unpack(ld4(sBT + n * LP + s0), bv);
        unpack(ld4(sBT + n * LP + s0 + 4), bv + 4);
        unpack(ld4(sCT + n * LP + t0), cv);
        unpack(ld4(sCT + n * LP + t0 + 4), cv + 4);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) g[i][j] = fmaf(bv[i], cv[j], g[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float4* row = reinterpret_cast<float4*>(sGT + (s0 + i) * LP + t0);
        row[0] = make_float4(g[i][0], g[i][1], g[i][2], g[i][3]);
        row[1] = make_float4(g[i][4], g[i][5], g[i][6], g[i][7]);
      }
    }
  }
  __syncthreads();  // G^T is ready; B^T and C^T are free again

  for (int h = h0; h < h1; ++h) {
    store_tile(buf, sX, XP, L, P);
    if (tid < 32) {  // la: each lane sums up to 4 steps, then a warp scan
      const int per = (L + 31) / 32, base = tid * per;
      const float* ab = a + b * sa.b + h * sa.h + c * sa.c;
      float loc[kMaxL / 32];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxL / 32; ++k) {
        const int l = base + k;
        if (k < per) {
          run += (l < nv) ? ab[l * sa.l] : 0.f;
          loc[k] = run;
        }
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      const float excl = incl - run;
#pragma unroll
      for (int k = 0; k < kMaxL / 32; ++k) {
        const int l = base + k;
        if (k < per && l < L) sLa[l] = excl + loc[k];
      }
    }
    __syncthreads();
    // the next head's x loads run under this head's products
    if (h + 1 < h1)
      load_tile(buf, x + b * sx.b + (h + 1) * sx.h + c * sx.c, sx.l, P, nv);

    for (int l = tid; l < L; l += kThreads)
      sRem[l] = expf(sLa[L - 1] - sLa[l]);
    // S^T[s][t] = G^T[s][t] exp(la[t] - la[s]) for t >= s, else 0; four
    // consecutive t per thread. The y product of rows t0 .. t0 + 7 reads
    // S^T only for s <= t0 + 7, so entries past a row's 8-row tile are
    // never written.
    for (int i = 4 * tid; i < L * L; i += 4 * kThreads) {
      const int s = i / L, t = i % L;
      if (s > (t | 7)) continue;
      const float4 g = ld4(sGT + s * LP + t);
      const float4 lt = ld4(sLa + t);
      const float ls = sLa[s];
      float4 v;
      v.x = t >= s ? g.x * expf(lt.x - ls) : 0.f;
      v.y = t + 1 >= s ? g.y * expf(lt.y - ls) : 0.f;
      v.z = t + 2 >= s ? g.z * expf(lt.z - ls) : 0.f;
      v.w = t + 3 >= s ? g.w * expf(lt.w - ls) : 0.f;
      *reinterpret_cast<float4*>(sST + s * LP + t) = v;
    }
    __syncthreads();

    {  // y[t0 .. t0 + 7][p0 .. p0 + 3] = sum_{s <= t} S^T[s][t] x[s][p]
      const int t0 = 8 * ty, p0 = 4 * tx;
      if (t0 < L && p0 < P) {
        float acc[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        // causal: rows t0 .. t0 + 7 take s <= t0 + 7 only, and rows of
        // x at or past nv are zero
        const int s_end = min(t0 + 8, nv);
#pragma unroll 4
        for (int s = 0; s < s_end; ++s) {
          float sv[8], xv[4];
          unpack(ld4(sST + s * LP + t0), sv);
          unpack(ld4(sST + s * LP + t0 + 4), sv + 4);
          unpack(ld4(sX + s * XP + p0), xv);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(sv[i], xv[j], acc[i][j]);
        }
        float* yb = y + b * sy.b + h * sy.h + c * sy.c;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int t = t0 + i;
          if (t >= nv) break;
#pragma unroll
          for (int j = 0; j < 4; ++j) yb[t * sy.l + p0 + j] = acc[i][j];
        }
      }
    }

    {  // state[p0 .. p0 + 3][n0 .. n0 + 3] = sum_s x[s][p] B[s][n] rem[s]
      const int p0 = 4 * ty, n0 = 4 * tx;
      if (p0 < P && n0 < N) {
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
        for (int s = 0; s < nv; ++s) {  // rows at or past nv are zero
          const float r = sRem[s];
          float xv[4], bv[4];
          unpack(ld4(sX + s * XP + p0), xv);
          unpack(ld4(sB + s * BP + n0), bv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(xv[i], bv[j] * r, acc[i][j]);
        }
        float* stb = st + b * sst.b + h * sst.h + c * sst.c;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            stb[(p0 + i) * sst.l + n0 + j] = acc[i][j];
      }
    }
    __syncthreads();  // the next head overwrites x, la, rem and S^T
  }
}

}  // namespace

extern "C" {

// strides (22 element strides): x (b, h, c, l), B (b, c, l), C (b, c, l),
// a (b, h, c, l), y (b, h, c, l), state (b, h, c, p); the last axis of x,
// B, C, y and state is contiguous. Token c * L + l is valid when it is
// below t_valid. heads_per_block heads share one G.
int ssd_chunks_fwd(const float* x, const float* B, const float* C,
                   const float* a, float* y, float* st,
                   const long long* s, int Bt, int H, int nc, int L, int P,
                   int N, int t_valid, int heads_per_block, void* stream) {
  if (L < 8 || L > kMaxL || L % 8 || P < 4 || P > kMaxP || P % 4 ||
      N < 4 || N > kMaxN || N % 4 || heads_per_block < 1)
    return int(cudaErrorInvalidValue);
  const Strides4 sx{s[0], s[1], s[2], s[3]};
  const Strides3 sb{s[4], s[5], s[6]};
  const Strides3 sc{s[7], s[8], s[9]};
  const Strides4 sa{s[10], s[11], s[12], s[13]};
  const Strides4 sy{s[14], s[15], s[16], s[17]};
  const Strides4 sst{s[18], s[19], s[20], s[21]};
  const size_t smem = sizeof(float) * Layout(L, P, N).total;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(nc, (H + heads_per_block - 1) / heads_per_block, Bt);
  ssd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, B, C, a, y, st, sx, sb, sc, sa, sy, sst, H, L, P, N, t_valid,
      heads_per_block);
  return int(cudaGetLastError());
}

const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

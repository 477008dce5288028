// DPPF consensus stage on Hopper (sm_90a): the port of
// src/repro/kernels/pullpush/pullpush.py::fused_round (_fused_round_kernel),
// partial_gram (_partial_gram_kernel) and mix_shard (_mix_kernel), of the
// overlap modes' stale epilogue (the trainer's q + (mix_from_gram(s) - s),
// src/repro/train/trainer.py:387 and :449, as one pass), of
// src/repro/kernels/pullpush/ops.py::pullpush_fused on a worker-stacked
// tree read in place, and of the per-vector pair the tree path runs,
// sq_dist (_sq_dist_kernel) and apply_update (_apply_kernel); the last two
// are described at their code.
//
// On a TPU the one pallas_call runs its grid in order, so phase 1 reads the
// Gram that phase 0 summed in VMEM. Blocks on Hopper do not wait on each
// other, so the stage is two launches on one stream:
//
//   pp_partial_gram  grid-stride over the columns of a row-major (R, n)
//                    view whose rows lie ld floats apart (ld = n for the
//                    whole view; a column chunk x[:, a:b] of the overlap
//                    modes is read in place, ld = the view's n); every
//                    column is centered on its row-0 value (e = x - x[0])
//                    and each block writes its own (R, R) partial sum of
//                    e e^T to a workspace. No float atomics: the result is
//                    the same from run to run. The last block to finish
//                    (a ticket taken with atomicAdd after a __threadfence)
//                    runs the coefficient phase (_fused_round_kernel's
//                    _coef): it sums the partials in a fixed order into G,
//                    then r_i = sqrt(max(G_ii - 2 (T G)_ii + (T G T^T)_ii,
//                    0)) and coef_i = c0_i + c1_i / max(r_i, eps).
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
//   pp_mix_from_gram either mix where the Gram is given (the overlap modes'
//                    summed chunk Grams, a sharded stage's all-reduced
//                    Gram): every block runs the coefficient phase on G in
//                    its prologue (R <= 32 rows, at most R^3 multiply-adds)
//                    and block 0 writes r and coef out.
//   pp_gram_coef     the coefficient phase alone, one block on a stack of
//                    partials: the standalone counterpart of _coef. No
//                    stage launches it; the tail and the prologue above run
//                    its code, so all three give the same bits.
//
// pullpush_fused on a tree runs the same two passes on the tree's own
// leaves (pp_leaf_gram, then pp_leaf_mix): a table with one row per
// stacked leaf (M, ...) maps the virtual (M, n) view's columns to the
// leaves, which are read in place as fp32 or bf16 (widened exactly), so
// every thread sees the values the flattened fp32 view would hold, on the
// same grid and column-to-thread map; the mix rounds each output to its
// leaf's dtype (round to nearest even) and writes it into a new stacked
// tree. No (M, n) fp32 view is made.
//
// Bound: both passes over the view are memory-bound (the Gram does R/2
// FMAs per float it reads, the mix R). The design moves each byte once:
// 16-byte loads (float4; 8 bytes for 4 bf16) with neighbouring threads on
// neighbouring columns, the row-0 centering and the R x R sums kept in
// registers, no padded copy of the view (the grid-stride loop bound masks
// the ragged edge).
//
// Every entry point returns cudaGetLastError() after its launch; the
// Python wrapper raises when it is not cudaSuccess.
//
// The library is built from this file in PP_PARTS translation units, one
// nvcc each, all started together, then linked (``_build.Source.parts``):
// the many instances of the two passes took one nvcc ~1 min. With
// -DKERNEL_PART=k a unit holds the entry points of part k and instantiates
// only their kernels; without it the file holds all of them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#define PP_PARTS 5  // pullpush.py's SOURCE builds this many parts
#ifdef KERNEL_PART
#if KERNEL_PART < 0 || KERNEL_PART >= PP_PARTS
#error "KERNEL_PART names no part of pullpush.cu"
#endif
#define PP_IN(k) (KERNEL_PART == (k))
#else
#define PP_IN(k) 1
#endif

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
// where the (R, n) view's entries live. Both kinds hand the kernels the
// same fp32 value for a (row, column), so the arithmetic above them is one
// code path. at(c) moves a thread to its group of VEC columns c..c+VEC-1;
// load_rows(R, v) reads the group's rows 0..R-1, every load issued before
// any value is used (FlatIO's load(r, v) reads one row: the flat partial
// Gram loads row by row, which ran a little faster there);
// load_base / store the stale base and the output.
// ---------------------------------------------------------------------------

// a row-major fp32 view, rows ld floats apart. x, base and out may share
// storage: no __restrict__, so every load of a thread's columns stays
// ahead of its stores
template <int VEC>
struct FlatIO {
  const float* x;
  const float* base;
  float* out;
  long long ld;
  long long c;

  static constexpr bool kRowsAtOnce = false;

  __device__ __forceinline__ void at(long long col) { c = col; }
  __device__ __forceinline__ void load(int r, float* v) const {
    Vec<VEC>::load(x + (long long)r * ld + c, v);
  }
  template <int RB>
  __device__ __forceinline__ void load_rows(int R, float (&v)[RB][VEC]) const {
#pragma unroll
    for (int r = 0; r < RB; ++r)
      if (r < R) Vec<VEC>::load(x + (long long)r * ld + c, v[r]);
  }
  __device__ __forceinline__ void load_base(int r, float* v) const {
    Vec<VEC>::load(base + (long long)r * ld + c, v);
  }
  __device__ __forceinline__ void store(int r, const float* v) const {
    Vec<VEC>::store(out + (long long)r * ld + c, v);
  }
};

// the leaf table: one row of kLeafFields int64 a leaf with at least one
// element, in the flatten order. A stacked leaf (M, ...) is contiguous, so
// worker r's element j of the leaf lies at src[r * size + j]; the leaf
// holds the view's columns off..off+size-1 and its result goes to dst, a
// new leaf of the same shape and dtype
constexpr int kLeafFields = 5;
enum LeafField { kSrc = 0, kDst = 1, kSize = 2, kOff = 3, kBf16 = 4 };

__device__ __forceinline__ float leaf_get(const void* p, long long i,
                                          bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void leaf_put(void* p, long long i, bool bf16,
                                         float v) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// A thread keeps its current leaf in registers: its columns [lo, hi), its
// rows' byte stride and pointers, and whether every row's group of VEC
// columns lies at a VEC-wide aligned address (fast: 16-byte fp32 or
// 8-byte bf16 accesses). A group moves to the next leaf with one compare
// (a thread's columns only grow); a group that straddles leaves goes
// element by element.
template <int VEC>
struct LeafIO {
  static constexpr bool kRowsAtOnce = true;

  const long long* tab;
  int nleaves;
  int cur;             // this thread's leaf
  long long lo, hi;    // its columns
  long long rs;        // its rows' stride in bytes
  const char* src;
  char* dst;
  bool bf16, fast;
  long long c;
  bool whole;          // the group lies in leaf cur; else lq[q] per column
  int lq[VEC];

  __device__ __forceinline__ long long field(int l, int f) const {
    return __ldg(tab + l * kLeafFields + f);
  }
  __device__ __forceinline__ void enter(int l) {
    cur = l;
    lo = field(l, kOff);
    const long long size = field(l, kSize);
    hi = lo + size;
    bf16 = field(l, kBf16) != 0;
    rs = size * (bf16 ? 2 : 4);
    src = reinterpret_cast<const char*>(field(l, kSrc));
    dst = reinterpret_cast<char*>(field(l, kDst));
    const uintptr_t align = bf16 ? 8 : 16;
    fast = VEC == 4 && size % 4 == 0 && lo % 4 == 0
           && reinterpret_cast<uintptr_t>(src) % align == 0
           && reinterpret_cast<uintptr_t>(dst) % align == 0;
  }
  // the leaf holding column col, at or after leaf l
  __device__ __forceinline__ int find(int l, long long col) const {
    while (l + 1 < nleaves && field(l + 1, kOff) <= col) ++l;
    return l;
  }
  __device__ __forceinline__ void at(long long col) {
    c = col;
    if (col >= hi) enter(find(cur, col));
    whole = col + VEC <= hi;
    if (!whole) {
      int l = cur;
#pragma unroll
      for (int q = 0; q < VEC; ++q) lq[q] = l = find(l, col + q);
    }
  }
  // the case is chosen once a group, so that the rows' loads sit in one
  // branch-free block and are all in flight before the first is used
  template <int RB>
  __device__ __forceinline__ void load_rows(int R, float (&v)[RB][VEC]) const {
    if (whole) {
      const char* p = src + (c - lo) * (bf16 ? 2 : 4);
      if constexpr (VEC == 4) {
        if (fast && bf16) {
          uint2 u[RB];
#pragma unroll
          for (int r = 0; r < RB; ++r)
            if (r < R) u[r] = *reinterpret_cast<const uint2*>(p + r * rs);
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            if (r < R) {
              const float2 a = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(&u[r].x));
              const float2 b = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(&u[r].y));
              v[r][0] = a.x; v[r][1] = a.y; v[r][2] = b.x; v[r][3] = b.y;
            }
          }
          return;
        }
        if (fast) {
#pragma unroll
          for (int r = 0; r < RB; ++r)
            if (r < R)
              Vec<4>::load(reinterpret_cast<const float*>(p + r * rs), v[r]);
          return;
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (r < R) {
#pragma unroll
          for (int q = 0; q < VEC; ++q)
            v[r][q] = leaf_get(p + r * rs, q, bf16);
        }
      return;
    }
#pragma unroll
    for (int r = 0; r < RB; ++r)
      if (r < R) {
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          const int l = lq[q];
          const long long i = (long long)r * field(l, kSize)
                              + (c + q - field(l, kOff));
          v[r][q] = leaf_get(reinterpret_cast<const void*>(field(l, kSrc)),
                             i, field(l, kBf16) != 0);
        }
      }
  }
  __device__ __forceinline__ void load_base(int, float*) const {}
  __device__ __forceinline__ void store(int r, const float* v) const {
    if (whole) {
      char* p = dst + r * rs + (c - lo) * (bf16 ? 2 : 4);
      if constexpr (VEC == 4) {
        if (fast && bf16) {
          uint2 u;
          *reinterpret_cast<__nv_bfloat162*>(&u.x) =
              __floats2bfloat162_rn(v[0], v[1]);
          *reinterpret_cast<__nv_bfloat162*>(&u.y) =
              __floats2bfloat162_rn(v[2], v[3]);
          *reinterpret_cast<uint2*>(p) = u;
          return;
        }
        if (fast) {
          Vec<4>::store(reinterpret_cast<float*>(p), v);
          return;
        }
      }
#pragma unroll
      for (int q = 0; q < VEC; ++q) leaf_put(p, q, bf16, v[q]);
      return;
    }
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      const int l = lq[q];
      const long long i = (long long)r * field(l, kSize)
                          + (c + q - field(l, kOff));
      leaf_put(reinterpret_cast<void*>(field(l, kDst)), i,
               field(l, kBf16) != 0, v[q]);
    }
  }
};

// ---------------------------------------------------------------------------
// the coefficient phase: G from a stack of partial Grams, then r and coef
// ---------------------------------------------------------------------------

constexpr int kCoefThreads = 1024;

// operands of the coefficient phase; T == nullptr: the Gram only. Each
// output may be nullptr (not written)
struct Coef {
  const float* T;
  const float* c0;
  const float* c1;
  float eps;
  float* G;
  float* r;
  float* coef;
};

// G = the fixed-order sum of nblk (R, R) partials at ws: slot t of RR x C
// (C = kCoefThreads / RR chunks) sums entry t % RR over the blocks t / RR,
// t / RR + C, ...; the C chunk sums are then added in chunk order. Then,
// with T, r_i = sqrt(max((e_i - T_i)^T G (e_i - T_i), 0)) (as
// _fused_round_kernel's _coef) and coef_i, also into scoef (shared) when
// given. NT threads run it, each slot's sum in one thread in the same
// order whatever NT is: the 1024-thread gram_coef_kernel, the 256-thread
// tail of partial_gram_kernel and the mix's prologue give the same bits.
// ws is read through L2 (__ldcg): in the tail, other blocks of the same
// launch wrote it.
template <int NT>
__device__ __forceinline__ void gram_coef_block(const float* ws, int nblk,
                                                int R, const Coef& k,
                                                float* scoef) {
  __shared__ float part[kCoefThreads];
  __shared__ float sG[kMaxRows * kMaxRows];
  const int RR = R * R;
  const int C = kCoefThreads / RR > 0 ? kCoefThreads / RR : 1;
  for (int t = threadIdx.x; t < RR * C; t += NT) {
    const int entry = t % RR, chunk = t / RR;
    float s = 0.f;
#pragma unroll 8
    for (int b = chunk; b < nblk; b += C)
      s += __ldcg(ws + (long long)b * RR + entry);
    part[t] = s;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < RR; t += NT) {
    float s = 0.f;
    for (int ch = 0; ch < C; ++ch) s += part[ch * RR + t];
    sG[t] = s;
    if (k.G != nullptr) k.G[t] = s;
  }
  __syncthreads();
  if (k.T == nullptr) return;
  const float* T = k.T;
  for (int i = threadIdx.x; i < R; i += NT) {
    const float diag_g = sG[i * R + i];
    float diag_tg = 0.f, diag_tgt = 0.f;
    for (int j = 0; j < R; ++j) diag_tg += T[i * R + j] * sG[i * R + j];
    for (int kk = 0; kk < R; ++kk) {
      float tg = 0.f;
      for (int j = 0; j < R; ++j) tg += T[i * R + j] * sG[j * R + kk];
      diag_tgt += tg * T[i * R + kk];
    }
    const float r2 = diag_g - 2.f * diag_tg + diag_tgt;
    const float r = sqrtf(fmaxf(r2, 0.f));
    const float cf = k.c0[i] + k.c1[i] / fmaxf(r, k.eps);
    if (scoef != nullptr) scoef[i] = cf;
    if (k.r != nullptr) k.r[i] = r;
    if (k.coef != nullptr) k.coef[i] = cf;
  }
}

__global__ void __launch_bounds__(kCoefThreads)
gram_coef_kernel(const float* __restrict__ ws, int nblk, int R, Coef k) {
  gram_coef_block<kCoefThreads>(ws, nblk, R, k, nullptr);
}

// ---------------------------------------------------------------------------
// partial Gram: ws[blockIdx.x] = sum over this block's columns of e e^T;
// with a ticket, the last block to finish runs the coefficient phase
// ---------------------------------------------------------------------------

template <int RB, int VEC, class IO>
__global__ void __launch_bounds__(kThreads)
partial_gram_kernel(IO io, int R, long long n, float* ws,
                    unsigned int* ticket, Coef k) {
  constexpr int P = Tri<RB>::kPairs;
  __shared__ float sred[kWarps][P];
  __shared__ bool last;

  float acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = 0.f;

  const long long groups = n / VEC;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
       g < groups; g += stride) {
    io.at(g * VEC);
    float e[RB][VEC];
    if constexpr (IO::kRowsAtOnce) {
      float v[RB][VEC];
      io.load_rows(R, v);
#pragma unroll
      for (int r = 1; r < RB; ++r) {
#pragma unroll
        for (int q = 0; q < VEC; ++q)
          e[r][q] = r < R ? v[r][q] - v[0][q] : 0.f;
      }
    } else {
      float base[VEC];
      io.load(0, base);
#pragma unroll
      for (int r = 1; r < RB; ++r) {
        if (r < R) {
          float v[VEC];
          io.load(r, v);
#pragma unroll
          for (int q = 0; q < VEC; ++q) e[r][q] = v[q] - base[q];
        } else {
#pragma unroll
          for (int q = 0; q < VEC; ++q) e[r][q] = 0.f;
        }
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
  if (ticket == nullptr) return;

  // the last block to finish sums every block's partial: each block's
  // writes are made visible device-wide before it takes its ticket
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  gram_coef_block<kThreads>(ws, gridDim.x, R, k, nullptr);
  if (tid == 0) *ticket = 0u;       // ready for the stream's next launch
}

// ---------------------------------------------------------------------------
// mix: out = T x + (1 - coef)(x - T x), column by column; with kStale,
// out = base + (that - x); with kFromG, coef from the given Gram G in the
// prologue (block 0 writes r and coef out)
// ---------------------------------------------------------------------------

template <int RB, int VEC, bool kStale, bool kFromG, class IO>
__global__ void __launch_bounds__(kThreads)
mix_kernel(IO io, int R, long long n, const float* __restrict__ coef,
           const float* __restrict__ G, Coef k) {
  __shared__ float sT[RB * RB];
  __shared__ float soc[RB];
  __shared__ float scoef[kMaxRows];
  const int tid = threadIdx.x;
  if (kFromG) {
    // gram_coef_kernel's arithmetic on a one-block workspace
    if (blockIdx.x != 0) k.r = k.coef = nullptr;
    k.G = nullptr;
    gram_coef_block<kThreads>(G, 1, R, k, scoef);
    __syncthreads();
  }
  for (int idx = tid; idx < RB * RB; idx += kThreads) {
    const int i = idx / RB, j = idx % RB;
    sT[idx] = (i < R && j < R) ? k.T[i * R + j] : 0.f;
  }
  if (tid < RB) soc[tid] = tid < R ? 1.f - (kFromG ? scoef[tid] : coef[tid])
                                   : 0.f;
  __syncthreads();

  const long long groups = n / VEC;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
       g < groups; g += stride) {
    io.at(g * VEC);
    float v[RB][VEC];
    io.load_rows(R, v);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r >= R) {
#pragma unroll
        for (int q = 0; q < VEC; ++q) v[r][q] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      if (i < R) {
        float b[VEC];
        if (kStale) io.load_base(i, b);
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
        io.store(i, o);
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

// (rows bucket, columns a thread step) as compile-time constants
template <int kRB, int kVEC>
struct Shape {
  static constexpr int RB = kRB, VEC = kVEC;
};

// calls f(Shape<RB, VEC>{}) for R's bucket; vec 4 only up to 8 rows
template <class F>
int by_shape(int R, int vec, F f) {
  const int rb = row_bucket(R);
  if (vec == 4) return rb == 4 ? f(Shape<4, 4>{}) : f(Shape<8, 4>{});
  if (rb == 4) return f(Shape<4, 1>{});
  if (rb == 8) return f(Shape<8, 1>{});
  if (rb == 16) return f(Shape<16, 1>{});
  return f(Shape<32, 1>{});
}

template <template <int> class IO, class Make>
int launch_gram(int R, long long n, float* ws, int nblk, int vec,
                unsigned int* ticket, const Coef& k, cudaStream_t s,
                Make make) {
  return by_shape(R, vec, [&](auto sh) {
    using S = decltype(sh);
    partial_gram_kernel<S::RB, S::VEC><<<nblk, kThreads, 0, s>>>(
        make(IO<S::VEC>{}), R, n, ws, ticket, k);
    return (int)cudaGetLastError();
  });
}

template <bool kStale, bool kFromG, template <int> class IO, class Make>
int launch_mix(int R, long long n, const float* coef, const float* G,
               const Coef& k, int nblk, int vec, cudaStream_t s, Make make) {
  return by_shape(R, vec, [&](auto sh) {
    using S = decltype(sh);
    mix_kernel<S::RB, S::VEC, kStale, kFromG><<<nblk, kThreads, 0, s>>>(
        make(IO<S::VEC>{}), R, n, coef, G, k);
    return (int)cudaGetLastError();
  });
}

// a FlatIO / LeafIO filled in (the VEC of the instance is the IO's own)
struct MakeFlat {
  const float* x;
  const float* base;
  float* out;
  long long ld;
  template <int VEC>
  FlatIO<VEC> operator()(FlatIO<VEC> io) const {
    io.x = x; io.base = base; io.out = out; io.ld = ld; io.c = 0;
    return io;
  }
};

struct MakeLeaf {
  const long long* tab;
  int nleaves;
  template <int VEC>
  LeafIO<VEC> operator()(LeafIO<VEC> io) const {
    io.tab = tab; io.nleaves = nleaves; io.cur = 0; io.lo = io.hi = 0;
    io.c = 0; io.whole = false;
    return io;
  }
};

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

#if PP_IN(0)
// ws: (nblk, R, R) fp32 workspace, one partial Gram per block; the rows of
// x lie ld floats apart (ld >= n). ticket == nullptr: the block partials
// only (pp_gram_coef sums them). Else the last block sums them into G and,
// with T, writes r and coef; it then sets *ticket back to 0. A ticket is
// one zeroed unsigned int that no other launch uses at the same time (one
// a stream).
int pp_partial_gram(const float* x, int R, long long n, long long ld,
                    float* ws, int nblk, int vec, unsigned int* ticket,
                    const float* T, const float* c0, const float* c1,
                    float eps, float* G, float* r, float* coef,
                    void* stream) {
  if (!valid_shape(R, n, ld, vec) || nblk < 1)
    return (int)cudaErrorInvalidValue;
  const Coef k{T, c0, c1, eps, G, r, coef};
  return launch_gram<FlatIO>(R, n, ws, nblk, vec, ticket, k,
                             static_cast<cudaStream_t>(stream),
                             MakeFlat{x, nullptr, nullptr, ld});
}
#endif

#if PP_IN(1)
// the same over the leaf table tab (nleaves x kLeafFields int64, the
// virtual (R, n) view); vec 4 as for a fresh flat view of it
int pp_leaf_gram(const long long* tab, int nleaves, int R, long long n,
                 float* ws, int nblk, int vec, unsigned int* ticket,
                 const float* T, const float* c0, const float* c1, float eps,
                 float* G, float* r, float* coef, void* stream) {
  if (!valid_shape(R, n, n, vec) || nblk < 1 || nleaves < 1 ||
      ticket == nullptr)
    return (int)cudaErrorInvalidValue;
  const Coef k{T, c0, c1, eps, G, r, coef};
  return launch_gram<LeafIO>(R, n, ws, nblk, vec, ticket, k,
                             static_cast<cudaStream_t>(stream),
                             MakeLeaf{tab, nleaves});
}
#endif

#if PP_IN(0)
// T == nullptr: only reduce the partials into G (r, coef, c0, c1 unused)
int pp_gram_coef(const float* ws, int nblk, int R, const float* T,
                 const float* c0, const float* c1, float eps, float* G,
                 float* r, float* coef, void* stream) {
  if (R < 1 || R > kMaxRows || nblk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gram_coef_kernel<<<1, kCoefThreads, 0, s>>>(
      ws, nblk, R, Coef{T, c0, c1, eps, G, r, coef});
  return (int)cudaGetLastError();
}
#endif

#if PP_IN(2)
int pp_mix(const float* x, int R, long long n, const float* T,
           const float* coef, float* out, int nblk, int vec, void* stream) {
  if (!valid_shape(R, n, n, vec) || nblk < 1)
    return (int)cudaErrorInvalidValue;
  const Coef k{T, nullptr, nullptr, 0.f, nullptr, nullptr, nullptr};
  return launch_mix<false, false, FlatIO>(
      R, n, coef, nullptr, k, nblk, vec, static_cast<cudaStream_t>(stream),
      MakeFlat{x, nullptr, out, n});
}

// out = base + (mix(x) - x); x, base and out are (R, n) row-major
int pp_stale_mix(const float* x, int R, long long n, const float* T,
                 const float* coef, const float* base, float* out, int nblk,
                 int vec, void* stream) {
  if (!valid_shape(R, n, n, vec) || nblk < 1 || base == nullptr)
    return (int)cudaErrorInvalidValue;
  const Coef k{T, nullptr, nullptr, 0.f, nullptr, nullptr, nullptr};
  return launch_mix<true, false, FlatIO>(
      R, n, coef, nullptr, k, nblk, vec, static_cast<cudaStream_t>(stream),
      MakeFlat{x, base, out, n});
}
#endif

#if PP_IN(3)
// pp_mix (base == nullptr) or pp_stale_mix with the coefficients of the
// given (R, R) Gram G, computed in the prologue; r and coef written out
int pp_mix_from_gram(const float* x, int R, long long n, const float* T,
                     const float* G, const float* c0, const float* c1,
                     float eps, const float* base, float* out, float* r,
                     float* coef, int nblk, int vec, void* stream) {
  if (!valid_shape(R, n, n, vec) || nblk < 1)
    return (int)cudaErrorInvalidValue;
  const Coef k{T, c0, c1, eps, nullptr, r, coef};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const MakeFlat make{x, base, out, n};
  if (base == nullptr)
    return launch_mix<false, true, FlatIO>(R, n, nullptr, G, k, nblk, vec, s,
                                           make);
  return launch_mix<true, true, FlatIO>(R, n, nullptr, G, k, nblk, vec, s,
                                        make);
}
#endif

#if PP_IN(4)
// the mix over the leaf table: reads each leaf's src, writes its dst in
// the leaf's dtype
int pp_leaf_mix(const long long* tab, int nleaves, int R, long long n,
                const float* T, const float* coef, int nblk, int vec,
                void* stream) {
  if (!valid_shape(R, n, n, vec) || nblk < 1 || nleaves < 1)
    return (int)cudaErrorInvalidValue;
  const Coef k{T, nullptr, nullptr, 0.f, nullptr, nullptr, nullptr};
  return launch_mix<false, false, LeafIO>(
      R, n, coef, nullptr, k, nblk, vec, static_cast<cudaStream_t>(stream),
      MakeLeaf{tab, nleaves});
}
#endif

#if PP_IN(0)
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
#endif

}  // extern "C"

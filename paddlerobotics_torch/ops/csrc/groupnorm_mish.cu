// Diffusion Policy's Conv1dBlock tail, the convolution's bias, GroupNorm and
// Mish, with the block's epilogue (FiLM, a residual add or none), as one
// pass in float32, for sm_90a.
//
// Replaces no TPU kernel: the JAX package has no Diffusion Policy. The
// port's U-Net (algos/diffusion_policy.py) ran each of its 25 Conv1dBlock
// tails as ~8 PyTorch passes: cuDNN's separate bias add, GroupNorm's
// moments (one block per (env, group) row of 256-512 floats, ~12% of HBM)
// and its apply, Mish, FiLM's multiply and add or the residual add. This
// kernel reads the bias-less convolution's output once and writes the
// block's output once. Its plain version, which the wrapper runs on CPU
// tensors, is ops/groupnorm_mish.plain.
//
// Function. For h (B, C, L), the output of a convolution run without its
// bias, and G groups of Cg = C / G channels, each (b, g) one contiguous
// run of n = Cg * L floats:
//
//   v  = h[b, c, t] + conv_bias[c]
//   mu = sum(v) / n,  var = sum((v - mu)^2) / n         (biased, two passes)
//   u  = (v - mu) * (gamma[c] / sqrt(var + eps)) + beta[c]
//   m  = u * tanh(log1p(exp(u)))                        (Mish, as PyTorch)
//   y  = m                                              (epilogue 0: none)
//      = film[b, c] * m + film[b, C + c]                (1: FiLM)
//      = m + (res[b, c, t] + res_bias[c])               (2: residual; no
//                                                        res_bias: m + res)
//
// with the precise expf, log1pf and tanhf (no fast-math), in float32 only.
//
// Plan. One warp per (b, g) row, 8 rows a block of 256 threads, no shared
// memory. A row is n / 4 float4 chunks (L a multiple of 4, so a chunk lies
// in one channel); lane l holds chunks l, l + 32, .. in registers: Q = 1, 2
// or 4 chunks a lane, the instance chosen by n (up to 128, 256 or 512
// floats), lanes past the row's end idle. The row and, for the residual,
// its residual chunks are loaded once as 16-byte vectors, the two sums go
// through warp shuffles, and each chunk is stored once.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. h read and y written once, FiLM's
// (B, 2C) or the residual's (B, C, L) read once; a few dozen operations an
// element, far below the FP32 line. At the U-Net's shapes at B=4096 a row is
// 512 floats (C/L = 256/16, 512/8, 1024/4) or 256 (512/4, 256/8), and one
// launch has 32,768 rows; the 25 launches of a U-Net call move 3.72 GB.
//
// The row path (row_norm_kernel) is the same pass at one group of length 1:
// GroupNorm(1, C) on (N, C, 1) is LayerNorm(C), so it is TD-MPC2's
// NormedLinear tail (algos/tdmpc2.py) after a bias-less GEMM. For h (R, C),
// each row r one contiguous run of C floats, and `heads` sets of per-element
// parameters (heads, C), row r taking set (r / head_div) % heads:
//
//   v  = h[r, j] + bias[k, j]                           (k the row's set)
//   mu, var over the row's C floats as above             (two passes)
//   u  = (v - mu) * (gamma[k, j] / sqrt(var + eps)) + beta[k, j]
//   y  = Mish(u)                                         (act 0)
//      = softmax of u over each group of `dim` consecutive floats
//                                                        (act 1: SimNorm)
//
// One warp a row, 8 rows a block, a lane holding float4 chunks l, l + 32, ..
// of the row and of the parameters (Q = 1, 2 or 4 chunks: C up to 128, 256
// or 512). A SimNorm group of dim floats is dim / 4 chunks held by as many
// neighbouring lanes, so its max and sum go through dim / 4 - 1 shuffles.
// With head_div = 1 the rows of a GEMM over stacked weights, (N, heads * C),
// take their head's parameters in turn; with head_div = N those of a batched
// GEMM, (heads, N, C). Bound: bytes, as above (each row read and written
// once, the parameters once a launch).

#include <cuda_runtime.h>

namespace prt_gn {
namespace {

constexpr int WARPS = 8;                 // rows a block
constexpr int NTHREADS = 32 * WARPS;
constexpr int MAX_FLOATS = 512;          // the largest row an instance holds
enum Epilogue { NONE = 0, FILM = 1, RESIDUAL = 2 };

struct Args {
  const float* h;
  const float* conv_bias;
  const float* gamma;
  const float* beta;
  const float* film;        // (B, 2C), epilogue FILM
  const float* res;         // (B, C, L), epilogue RESIDUAL
  const float* res_bias;    // (C) or null, epilogue RESIDUAL
  float* y;
  long long rows;           // B * G
  int C, L, G, cg;
  float eps;
  int epilogue;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float mish(float u) {
  return u * tanhf(log1pf(expf(u)));
}

__device__ __forceinline__ float4 add4(float4 a, float s) {
  return make_float4(a.x + s, a.y + s, a.z + s, a.w + s);
}

template <int Q>
__global__ void __launch_bounds__(NTHREADS)
    groupnorm_mish_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= a.rows) return;             // the whole warp leaves together
  const int n = a.cg * a.L;
  const int chunks = n >> 2;
  const long long b = row / a.G;
  const int c0 = (int)(row % a.G) * a.cg;
  // row (b, g) starts at (b * C + g * cg) * L = row * n
  const float4* h4 = reinterpret_cast<const float4*>(a.h) + row * chunks;
  const float4* r4 =
      a.epilogue == RESIDUAL
          ? reinterpret_cast<const float4*>(a.res) + row * chunks
          : nullptr;

  float4 v[Q], r[Q];
  int c[Q];
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int k = lane + 32 * q;
    c[q] = c0 + 4 * k / a.L;
    v[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k < chunks) {
      v[q] = add4(h4[k], __ldg(a.conv_bias + c[q]));
      if (a.epilogue == RESIDUAL) r[q] = r4[k];
      s += (v[q].x + v[q].y) + (v[q].z + v[q].w);
    }
  }
  const float mu = warp_sum(s) / (float)n;
  float ss = 0.f;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (lane + 32 * q < chunks) {
      const float dx = v[q].x - mu, dy = v[q].y - mu, dz = v[q].z - mu,
                  dw = v[q].w - mu;
      ss += (dx * dx + dy * dy) + (dz * dz + dw * dw);
    }
  }
  const float rstd = 1.0f / sqrtf(warp_sum(ss) / (float)n + a.eps);

  float4* y4 = reinterpret_cast<float4*>(a.y) + row * chunks;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int k = lane + 32 * q;
    if (k >= chunks) continue;
    const float sc = __ldg(a.gamma + c[q]) * rstd;
    const float sh = __ldg(a.beta + c[q]);
    float4 m = make_float4(mish(fmaf(v[q].x - mu, sc, sh)),
                           mish(fmaf(v[q].y - mu, sc, sh)),
                           mish(fmaf(v[q].z - mu, sc, sh)),
                           mish(fmaf(v[q].w - mu, sc, sh)));
    if (a.epilogue == FILM) {
      const float* f = a.film + b * 2 * a.C + c[q];
      const float fs = __ldg(f), fb = __ldg(f + a.C);
      m = make_float4(fmaf(fs, m.x, fb), fmaf(fs, m.y, fb),
                      fmaf(fs, m.z, fb), fmaf(fs, m.w, fb));
    } else if (a.epilogue == RESIDUAL) {
      const float rb = a.res_bias ? __ldg(a.res_bias + c[q]) : 0.f;
      const float4 rr = a.res_bias ? add4(r[q], rb) : r[q];
      m = make_float4(m.x + rr.x, m.y + rr.y, m.z + rr.z, m.w + rr.w);
    }
    y4[k] = m;
  }
}

// Chunks a lane holds for rows of n floats, 0 where no instance takes them.
int lane_chunks(long long n) {
  return n <= 128 ? 1 : n <= 256 ? 2 : n <= MAX_FLOATS ? 4 : 0;
}

cudaError_t check(long long B, long long C, long long L, long long G,
                  int epilogue) {
  if (B <= 0 || C <= 0 || L <= 0 || G <= 0 || C % G || L % 4 ||
      epilogue < NONE || epilogue > RESIDUAL)
    return cudaErrorInvalidValue;
  if (!lane_chunks(C / G * L) || B * C * L > (1LL << 40) ||
      (B * G + WARPS - 1) / WARPS > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int Q>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((a.rows + WARPS - 1) / WARPS);
  groupnorm_mish_kernel<Q><<<blocks, NTHREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

// --- the row path: one group of length 1 ------------------------------------

enum Act { MISH = 0, SIMNORM = 1 };

struct RowArgs {
  const float* h;           // (rows, C)
  const float* bias;        // (heads, C)
  const float* gamma;
  const float* beta;
  float* y;
  long long rows;
  long long head_div;
  int C, heads, dim;        // dim: SimNorm's group, act SIMNORM
  float eps;
};

template <int Q, int ACT>
__global__ void __launch_bounds__(NTHREADS) row_norm_kernel(const RowArgs a) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= a.rows) return;             // the whole warp leaves together
  const int chunks = a.C >> 2;
  const long long head = (row / a.head_div) % a.heads;
  const float4* h4 = reinterpret_cast<const float4*>(a.h) + row * chunks;
  const float4* b4 = reinterpret_cast<const float4*>(a.bias) + head * chunks;
  const float4* g4 = reinterpret_cast<const float4*>(a.gamma) + head * chunks;
  const float4* e4 = reinterpret_cast<const float4*>(a.beta) + head * chunks;

  float4 v[Q];
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int k = lane + 32 * q;
    v[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k < chunks) {
      const float4 x = h4[k], b = __ldg(b4 + k);
      v[q] = make_float4(x.x + b.x, x.y + b.y, x.z + b.z, x.w + b.w);
      s += (v[q].x + v[q].y) + (v[q].z + v[q].w);
    }
  }
  const float mu = warp_sum(s) / (float)a.C;
  float ss = 0.f;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (lane + 32 * q < chunks) {
      const float dx = v[q].x - mu, dy = v[q].y - mu, dz = v[q].z - mu,
                  dw = v[q].w - mu;
      ss += (dx * dx + dy * dy) + (dz * dz + dw * dw);
    }
  }
  const float rstd = 1.0f / sqrtf(warp_sum(ss) / (float)a.C + a.eps);

  float4* y4 = reinterpret_cast<float4*>(a.y) + row * chunks;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int k = lane + 32 * q;
    float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k < chunks) {
      const float4 g = __ldg(g4 + k), e = __ldg(e4 + k);
      u = make_float4(fmaf(v[q].x - mu, g.x * rstd, e.x),
                      fmaf(v[q].y - mu, g.y * rstd, e.y),
                      fmaf(v[q].z - mu, g.z * rstd, e.z),
                      fmaf(v[q].w - mu, g.w * rstd, e.w));
    }
    if (ACT == MISH) {
      if (k < chunks)
        y4[k] = make_float4(mish(u.x), mish(u.y), mish(u.z), mish(u.w));
    } else {
      // a group is dim / 4 neighbouring lanes, aligned; every lane takes
      // part in the shuffles, those past the row's end on zeros
      float m = fmaxf(fmaxf(u.x, u.y), fmaxf(u.z, u.w));
      for (int o = 1; o < (a.dim >> 2); o <<= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float4 x = make_float4(expf(u.x - m), expf(u.y - m),
                                   expf(u.z - m), expf(u.w - m));
      float t = (x.x + x.y) + (x.z + x.w);
      for (int o = 1; o < (a.dim >> 2); o <<= 1)
        t += __shfl_xor_sync(0xffffffffu, t, o);
      if (k < chunks)
        y4[k] = make_float4(x.x / t, x.y / t, x.z / t, x.w / t);
    }
  }
}

int row_chunks(long long C) {
  return C <= 128 ? 1 : C <= 256 ? 2 : C <= MAX_FLOATS ? 4 : 0;
}

cudaError_t row_check(long long rows, long long C, long long heads,
                      long long head_div, int act, long long dim) {
  if (rows <= 0 || C <= 0 || C % 4 || !row_chunks(C) || heads <= 0 ||
      head_div <= 0 || (act != MISH && act != SIMNORM) ||
      rows * C > (1LL << 40) || (rows + WARPS - 1) / WARPS > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  // a SimNorm group: 4, 8, .. 128 floats (1 to 32 lanes), dividing C
  if (act == SIMNORM && (dim < 4 || dim > 128 || (dim & (dim - 1)) ||
                         C % dim))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int Q, int ACT>
cudaError_t row_launch(const RowArgs& a, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((a.rows + WARPS - 1) / WARPS);
  row_norm_kernel<Q, ACT><<<blocks, NTHREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int ACT>
cudaError_t row_dispatch(const RowArgs& a, cudaStream_t stream) {
  switch (row_chunks(a.C)) {
    case 1: return row_launch<1, ACT>(a, stream);
    case 2: return row_launch<2, ACT>(a, stream);
    default: return row_launch<4, ACT>(a, stream);
  }
}

}  // namespace
}  // namespace prt_gn

// y (B, C, L) = the block's epilogue of Mish(GroupNorm(h + conv_bias)),
// every tensor contiguous float32 on the current device and 16-byte
// aligned; film (B, 2C) for epilogue 1, res (B, C, L) and res_bias (C, or
// null) for epilogue 2, both null otherwise. L a multiple of 4, C / groups
// * L at most 512.
extern "C" int prt_groupnorm_mish(const void* h, const void* conv_bias,
                                  const void* gamma, const void* beta,
                                  const void* film, const void* res,
                                  const void* res_bias, void* y, long long B,
                                  long long C, long long L, long long groups,
                                  double eps, int epilogue, void* stream) {
  using namespace prt_gn;
  cudaError_t e = check(B, C, L, groups, epilogue);
  if (e != cudaSuccess) return (int)e;
  if ((epilogue == FILM) != (film != nullptr) ||
      (epilogue == RESIDUAL) != (res != nullptr) ||
      (res_bias != nullptr && epilogue != RESIDUAL))
    return (int)cudaErrorInvalidValue;
  const Args a{(const float*)h,     (const float*)conv_bias,
               (const float*)gamma, (const float*)beta,
               (const float*)film,  (const float*)res,
               (const float*)res_bias, (float*)y,
               B * groups,          (int)C,
               (int)L,              (int)groups,
               (int)(C / groups),   (float)eps,
               epilogue};
  cudaStream_t s = (cudaStream_t)stream;
  switch (lane_chunks(C / groups * L)) {
    case 1: return (int)launch<1>(a, s);
    case 2: return (int)launch<2>(a, s);
    default: return (int)launch<4>(a, s);
  }
}

// The launch prt_groupnorm_mish makes for (B, C, L, groups): blocks,
// threads a block, rows ((env, group) pairs) a block, floats a lane holds.
extern "C" int prt_groupnorm_mish_plan(long long B, long long C, long long L,
                                       long long groups, long long* out) {
  using namespace prt_gn;
  cudaError_t e = check(B, C, L, groups, NONE);
  if (e != cudaSuccess) return (int)e;
  const long long vals[4] = {(B * groups + WARPS - 1) / WARPS, NTHREADS,
                             WARPS, 4LL * lane_chunks(C / groups * L)};
  for (int i = 0; i < 4; ++i) out[i] = vals[i];
  return 0;
}

extern "C" const char* prt_groupnorm_mish_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// y (rows, C) = act(LayerNorm(h + bias[k]) with gamma[k], beta[k]), k = (row
// / head_div) % heads: h, y (rows, C) and bias, gamma, beta (heads, C), every
// tensor contiguous float32 on the current device and 16-byte aligned. C a
// multiple of 4 and at most 512; act 0 Mish, 1 SimNorm over groups of dim.
extern "C" int prt_row_norm(const void* h, const void* bias, const void* gamma,
                            const void* beta, void* y, long long rows,
                            long long C, long long heads, long long head_div,
                            double eps, int act, long long dim,
                            void* stream) {
  using namespace prt_gn;
  cudaError_t e = row_check(rows, C, heads, head_div, act, dim);
  if (e != cudaSuccess) return (int)e;
  const RowArgs a{(const float*)h,    (const float*)bias,
                  (const float*)gamma, (const float*)beta,
                  (float*)y,          rows,
                  head_div,           (int)C,
                  (int)heads,         (int)dim,
                  (float)eps};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(act == SIMNORM ? row_dispatch<SIMNORM>(a, s)
                              : row_dispatch<MISH>(a, s));
}

// The launch prt_row_norm makes for (rows, C): blocks, threads a block, rows
// a block, floats a lane holds.
extern "C" int prt_row_norm_plan(long long rows, long long C,
                                 long long* out) {
  using namespace prt_gn;
  cudaError_t e = row_check(rows, C, 1, 1, MISH, 8);
  if (e != cudaSuccess) return (int)e;
  const long long vals[4] = {(rows + WARPS - 1) / WARPS, NTHREADS, WARPS,
                             4LL * row_chunks(C)};
  for (int i = 0; i < 4; ++i) out[i] = vals[i];
  return 0;
}

// Diffusion Policy's Upsample1d, ConvTranspose1d(C, C, 4, stride 2,
// padding 1), as one polyphase kernel in float32 FMAs, for sm_90a.
//
// Replaces no TPU kernel: the JAX package has no Diffusion Policy. The
// port's U-Net (algos/diffusion_policy.py) ran its two transposed
// convolutions through cuDNN's dgrad_engine at ~8% of the FP32 peak, 12% of
// the U-Net's device time for 2% of its FLOPs; this kernel takes its place.
// Its plain version, which the wrapper runs on CPU tensors, is
// torch.nn.functional.conv_transpose1d.
//
// Arithmetic. For x (B, C, L), W (C_in, C_out, 4) in the parameter's own
// layout and bias (C), y (B, C, 2L) splits into two phases, each a dense
// 2-tap convolution (x at t-1 and t+1 reads 0 outside [0, L)):
//
//   y[b, o, 2t]     = bias[o] + sum_i W[i,o,1] x[b,i,t] + W[i,o,3] x[b,i,t-1]
//   y[b, o, 2t + 1] = bias[o] + sum_i W[i,o,2] x[b,i,t] + W[i,o,0] x[b,i,t+1]
//
// every product a float32 FMA (no TF32, no tensor cores), summed over i in
// order, the two taps of one i together; the bias is added last.
//
// Tiling. Each phase is a GEMM of M = B*L rows (b, t), N = C and K = 2C.
// A block of 256 threads owns whole sequences (BS of them, BM = BS*L rows)
// and BN output channels, so the t-1 / t+1 halo never leaves the block and
// no index work goes to padding. A thread keeps TM = 8 rows (8 / L whole
// sequences) by TN = 8 output channels in both phases: 128 accumulators,
// which are y[b, o, 0:2L] in order. Per input channel it reads its 8 x
// values and 8 float4s of W (the 4 taps of one (i, o) are contiguous in the
// parameter), and runs 8 * (8/L) * (4L - 2) FMAs: each x value feeds all
// four taps. The zero taps at a sequence's ends are skipped.
//
// Staging. x[b, i0:i0+BK, 0:L] and W[i0:i0+BK, o0:o0+BN, 0:4] are each
// contiguous runs in device memory; a stage of BK = 8 input channels is
// copied with 16-byte cp.async into a 3-stage ring in shared memory (x rows
// padded by 4 floats, so the copies' writes hit distinct banks), so two
// stages' copies are in flight while one is multiplied. Rows past B*L,
// channels past C and output channels past C are zero-filled and never
// written. A warp's lanes are 4 output-channel threads by 8 row threads,
// and a thread's channels are strided by the block's channel threads, so
// every fragment read is conflict-free or a broadcast.
//
// Plan, from the shape alone: BN = 128 channels (16 channel threads by 16
// row threads) for any C, BM = 128 rows (32 sequences at L=4, 16 at L=8).
// At the U-Net's shapes at B=4096 (C=512, L=4 and C=256, L=8) both layers are
// 512 blocks, one block of 256 threads an SM (the 128 accumulators and
// the fragments take 224-253 registers a thread, no spills).
//
// Bound on an H100 SXM (67 TFLOP/s FP32, 3.35 TB/s): operations. A call
// needs 2 * B * C^2 * (4L - 2) FLOPs, the zero taps left out (30.06 GFLOP at
// C=512, L=4 and 16.11 at C=256, L=8, B=4096: 0.449 and 0.240 ms) against
// 38 and 35 MB of x and W read once and 67 MB of y written (0.03 ms).
// The kernel is bound by its FMA rate: 2 warps per scheduler, ~224 FMAs to
// 10 shared loads per input channel.

#include <cuda_runtime.h>

namespace prt_up {
namespace {

constexpr int NTHREADS = 256;
constexpr int TN = 8;       // output channels a thread keeps
constexpr int TM = 8;       // rows (b, t) a thread keeps
constexpr int BK = 8;       // input channels a stage holds
constexpr int STAGES = 3;
constexpr int THN = 16;     // channel threads a block

template <int L>
struct Tile {
  static_assert(L % 4 == 0 && TM % L == 0, "L is 4 or 8");
  static constexpr int WN = THN / 4;           // warps along the channels
  static constexpr int THM = NTHREADS / THN;   // row threads
  static constexpr int S = TM / L;             // sequences a thread keeps
  static constexpr int BN = THN * TN;          // output channels a block
  static constexpr int BS = THM * S;           // sequences a block
  static constexpr int BM = BS * L;            // rows a block
  static constexpr int LDA = BM + 4;           // x row in shared memory
  static constexpr int A_FLOATS = BK * LDA;
  static constexpr int STAGE_FLOATS = A_FLOATS + BK * BN * 4;
  static constexpr int SMEM = STAGES * STAGE_FLOATS * (int)sizeof(float);
  static constexpr int A_CHUNKS = BS * BK * (L / 4);   // 16-byte copies
  static constexpr int W_CHUNKS = BK * BN;
  static_assert(A_CHUNKS % NTHREADS == 0 && W_CHUNKS % NTHREADS == 0, "");
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage kt of the K loop (input channels kt*BK ..) into ring slot `st`.
template <int L>
__device__ __forceinline__ void load_stage(float* smem, int st, int kt,
                                           const float* __restrict__ x,
                                           const float* __restrict__ w,
                                           int B, int C, int b0, int o0) {
  using T = Tile<L>;
  constexpr int QA = L / 4;
  float* As = smem + st * T::STAGE_FLOATS;
  float* Ws = As + T::A_FLOATS;
  const int i0 = kt * BK;
#pragma unroll
  for (int n = 0; n < T::A_CHUNKS / NTHREADS; ++n) {
    const int c = threadIdx.x + n * NTHREADS;
    const int bl = c / (BK * QA), r = c % (BK * QA);
    const int k = r / QA, q = r % QA;
    const bool ok = b0 + bl < B && i0 + k < C;
    const float* g =
        ok ? x + ((long long)(b0 + bl) * C + i0 + k) * L + 4 * q : x;
    cp_async16(As + k * T::LDA + bl * L + 4 * q, g, ok);
  }
#pragma unroll
  for (int n = 0; n < T::W_CHUNKS / NTHREADS; ++n) {
    const int c = threadIdx.x + n * NTHREADS;
    const int k = c / T::BN, o = c % T::BN;
    const bool ok = i0 + k < C && o0 + o < C;
    const float* g = ok ? w + ((long long)(i0 + k) * C + o0 + o) * 4 : w;
    cp_async16(Ws + 4 * c, g, ok);
  }
}

template <int L>
__global__ void __launch_bounds__(NTHREADS, 1)
    upsample1d_kernel(const float* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ y,
                      int B, int C) {
  using T = Tile<L>;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tn = (warp % T::WN) * 4 + (lane & 3);
  const int tm = (warp / T::WN) * 8 + (lane >> 2);
  const int b0 = blockIdx.x * T::BS;
  const int o0 = blockIdx.y * T::BN;
  const int KT = (C + BK - 1) / BK;

  // acc[s][j][p]: y[b0 + tm + s*THM, o0 + tn + j*THN, p], p = 2t (even
  // phase) or 2t + 1 (odd)
  float acc[T::S][TN][2 * L];
#pragma unroll
  for (int s = 0; s < T::S; ++s)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int p = 0; p < 2 * L; ++p) acc[s][j][p] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < KT) load_stage<L>(smem, st, st, x, w, B, C, b0, o0);
    cp_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<STAGES - 2>();   // stage kt has landed (this thread's copies)
    __syncthreads();         // everyone's, and slot (kt-1) % STAGES is free
    const int nk = kt + STAGES - 1;
    if (nk < KT)
      load_stage<L>(smem, nk % STAGES, nk, x, w, B, C, b0, o0);
    cp_commit();
    const float* As = smem + (kt % STAGES) * T::STAGE_FLOATS;
    const float4* Ws = reinterpret_cast<const float4*>(As + T::A_FLOATS);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[T::S][L];
#pragma unroll
      for (int s = 0; s < T::S; ++s)
#pragma unroll
        for (int q = 0; q < L / 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(
              As + k * T::LDA + (tm + s * T::THM) * L + 4 * q);
          a[s][4 * q] = v.x;
          a[s][4 * q + 1] = v.y;
          a[s][4 * q + 2] = v.z;
          a[s][4 * q + 3] = v.w;
        }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 wv = Ws[k * T::BN + tn + j * THN];   // taps 0, 1, 2, 3
#pragma unroll
        for (int s = 0; s < T::S; ++s)
#pragma unroll
          for (int t = 0; t < L; ++t) {
            float e = fmaf(wv.y, a[s][t], acc[s][j][2 * t]);
            if (t > 0) e = fmaf(wv.w, a[s][t - 1], e);
            float d = fmaf(wv.z, a[s][t], acc[s][j][2 * t + 1]);
            if (t < L - 1) d = fmaf(wv.x, a[s][t + 1], d);
            acc[s][j][2 * t] = e;
            acc[s][j][2 * t + 1] = d;
          }
      }
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int o = o0 + tn + j * THN;
    if (o >= C) continue;
    const float bo = __ldg(bias + o);
#pragma unroll
    for (int s = 0; s < T::S; ++s) {
      const int b = b0 + tm + s * T::THM;
      if (b >= B) continue;
      float4* dst =
          reinterpret_cast<float4*>(y + ((long long)b * C + o) * (2 * L));
#pragma unroll
      for (int q = 0; q < L / 2; ++q)
        dst[q] = make_float4(acc[s][j][4 * q] + bo, acc[s][j][4 * q + 1] + bo,
                             acc[s][j][4 * q + 2] + bo,
                             acc[s][j][4 * q + 3] + bo);
    }
  }
}

// The launch of one call: its grid.
struct Plan {
  int L;
  long long blocks_m, blocks_n;
  int smem;
};

cudaError_t make_plan(long long B, long long C, long long L, Plan* p) {
  if (B <= 0 || C <= 0 || B * C > 0x7fffffffLL || (L != 4 && L != 8))
    return cudaErrorInvalidValue;
  const int bs = L == 4 ? Tile<4>::BS : Tile<8>::BS;
  p->L = (int)L;
  p->blocks_m = (B + bs - 1) / bs;
  p->blocks_n = (C + Tile<4>::BN - 1) / Tile<4>::BN;
  p->smem = L == 4 ? Tile<4>::SMEM : Tile<8>::SMEM;
  return p->blocks_m > 0x7fffffffLL || p->blocks_n > 65535
             ? cudaErrorInvalidValue : cudaSuccess;
}

template <int L>
cudaError_t launch(const float* x, const float* w, const float* b, float* y,
                   int B, int C, const Plan& p, cudaStream_t stream) {
  constexpr int smem = Tile<L>::SMEM;
  static unsigned long long ready = 0;   // one bit per device
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!(ready >> dev & 1ull)) {          // above 48 KB: opt in once
    e = cudaFuncSetAttribute(upsample1d_kernel<L>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    ready |= 1ull << dev;
  }
  const dim3 grid((unsigned)p.blocks_m, (unsigned)p.blocks_n);
  upsample1d_kernel<L><<<grid, NTHREADS, smem, stream>>>(x, w, b, y, B,
                                                              C);
  return cudaGetLastError();
}

}  // namespace
}  // namespace prt_up

// y (B, C, 2L) = conv_transpose1d(x (B, C, L), w (C, C, 4), bias (C),
// stride 2, padding 1); every tensor contiguous float32 on the current
// device, L 4 or 8.
extern "C" int prt_upsample1d(const void* x, const void* w, const void* bias,
                              void* y, long long B, long long C, long long L,
                              void* stream) {
  prt_up::Plan p;
  cudaError_t e = prt_up::make_plan(B, C, L, &p);
  if (e != cudaSuccess) return (int)e;
  const float* xf = (const float*)x;
  const float* wf = (const float*)w;
  const float* bf = (const float*)bias;
  float* yf = (float*)y;
  cudaStream_t s = (cudaStream_t)stream;
  const int b = (int)B, c = (int)C;
  e = p.L == 4 ? prt_up::launch<4>(xf, wf, bf, yf, b, c, p, s)
               : prt_up::launch<8>(xf, wf, bf, yf, b, c, p, s);
  return (int)e;
}

// The launch prt_upsample1d makes for (B, C, L): blocks along the
// sequences and along the output channels, threads per block, dynamic
// shared memory bytes, output channels and sequences per block.
extern "C" int prt_upsample1d_plan(long long B, long long C, long long L,
                                   long long* out) {
  prt_up::Plan p;
  cudaError_t e = prt_up::make_plan(B, C, L, &p);
  if (e != cudaSuccess) return (int)e;
  const long long bn = prt_up::THN * prt_up::TN;
  const long long bs = prt_up::NTHREADS / prt_up::THN * (prt_up::TM / p.L);
  const long long vals[6] = {p.blocks_m, p.blocks_n, prt_up::NTHREADS,
                             p.smem,     bn,         bs};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
  return 0;
}

extern "C" const char* prt_upsample1d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

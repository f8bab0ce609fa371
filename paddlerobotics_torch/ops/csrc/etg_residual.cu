// The batched env's ETG joint residual (envs/batched_env._etg_residual): the
// readout of the phase features, the per-leg foot targets and their leg IK,
// as one kernel in float32, for sm_90a.
//
// Replaces no TPU kernel: the JAX package computes the residual as jitted
// XLA. On the card the port ran it as ~90 PyTorch kernels a call, each a
// launch-latency-bound pass over (k, B) tensors, twice an env step; this
// kernel does one call's work in one launch. Its plain version, which the
// wrapper runs on CPU tensors, is ops/etg_residual.plain. The kernel has no
// backward: on the card the wrapper raises under grad.
//
// Function. For the readout w (3, H, B), b (3, B), the step index k (B,)
// and the env's constants (the RBF centers u (H, 2), each leg's phase group,
// stance offsets, foot-minus-hip position, signed hip offset and standing
// angles), env n at t = k[n] * dt and leg j of phase time tj (t for the legs
// of group a, t + T/2 for the others):
//
//   p1 = amp * sin(w1 * tj + ph1),  p2 = amp * sin(w2 * tj + ph2)
//   V[h] = exp(-((p1 - u[h,0])^2 + (p2 - u[h,1])^2) * (1 / sigma^2))
//   d[x] = sum_h w[x,h,n] V[h] + b[x,n]                (x = 0, 1, 2)
//          (the sum as lo + hi: rows h < ceil(H/2) and the rest, each
//          an FMA chain in order of h)
//   dx = d[0] + stance_x[j], dy = d[1] + lat[j], dz = d[2]
//   f = (foot - hip)[j] + (dx, dy, dz), then the closed-form leg IK of
//   ops/etg_residual.soa_ik: knee, hip, abduction angles of f
//   act[3j + i] = angle_i - q0[3j + i];  swing = dz > 0.02, stance = dz <= 0.005
//   v_a = V at t (group a's phase time), written by leg 0's threads
//
// Arithmetic. Every step is the PyTorch composition's operation on the card,
// in its order, each rounded on its own: the __f*_rn intrinsics, which the
// compiler never contracts into an FMA; the precise sinf, cosf, expf, acosf,
// asinf, atan2f and sqrt (no fast-math); x^2 as x * x (PyTorch's pow by 2);
// a division by a Python scalar as a product by its float32 reciprocal
// (PyTorch's CUDA true division by a CPU scalar); NaN through the clamps as
// torch.clamp. Python-float constants arrive rounded to float32 by the
// wrapper, as PyTorch rounds them. The readout's sum takes the order of
// cuBLAS's strided-batched GEMV (the composition's einsum) at the env's
// shapes: two FMA chains over the two halves of h, then their sum. cuBLAS
// chooses that split itself, by a heuristic it does not document; the split
// here was read from its outputs on an H100 with cuBLAS 12.9.2 (PyTorch
// 2.11.0+cu128): the two halves (the first the longer where H is odd) at
// H=20 and H=21 for every batch tried (1, 40, 320, 4096) and at H=48 for
// 1 env and for 256 and more, and eight parts at H=48 over 40 envs. Where
// cuBLAS splits otherwise, another version's included, the readout
// differs from the composition's by float32 rounding of the sum; the
// card's tests hold the kernel to that rounding, not to bit-equality.
// Everything else is the composition's arithmetic bit for bit.
// The build keeps nvcc's default flags, as PyTorch's kernels are built, so
// the math library's functions compile as in PyTorch's kernels.
//
// Plan. One thread per (leg, env): a block of 4 warps, warp j = leg j, its
// 32 lanes 32 consecutive envs, so each load and store is one coalesced run
// and a block's four legs read the same readout through L1. A thread
// evaluates its own phase group's V (the legs of one group compute the same
// V, which costs less than exchanging it), sums each half of h over
// chunks of 12 rows, loading a chunk's readout and centers before it sums
// them (one wait per chunk, not per row; at H=20 a half is one chunk, the
// rows past its end loaded at its first row and left out by a select, so
// a chunk has no branch and its exponentials interleave), and keeps
// everything in registers; no shared memory. At B=4096,
// ceil(B / 32) = 128 blocks of 128 threads, one wave on 132 SMs.
//
// Bound on an H100 SXM (3.35 TB/s): bytes, and far below the time of a
// launch. At B=4096, H=20: 1.05 MB read (the readout once, its bias, the
// step index), 0.56 MB written (act, the masks, v_a): 0.48 us. The
// operations (~20 precise exp and a few trig functions a thread) are a
// fraction of that at the FP32 rate. The kernel is bound by its latency:
// the chunk's loads, then a chain of dependent functions.

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace prt_etg {
namespace {

constexpr int LEGS = 4;
constexpr int LANES = 32;           // envs a block
constexpr int NTHREADS = LEGS * LANES;
constexpr int MAX_H = 64;
constexpr int CHUNK = 12;           // readout rows loaded before they are summed

// The scalars, each a Python float of the composition rounded to float32
// (ops/etg_residual.SCALARS, in that order).
struct Scalars {
  float dt, w1, ph1, w2, ph2, amp, half_t, inv_sigma_sq;
  float l_low_sq, l_up_sq, inv_2_l_low_up, l_sq_sum, two_l_up_low, sq_min;
  float swing_z, stance_z;
};

// A leg's constants in the device buffer (ops/etg_residual.LEG_FIELDS).
enum Leg { SEL_A, STX, LAT, FX0, FY0, FZ0, L_HIP, Q0, LEG_FLOATS = Q0 + 3 };

struct Args {
  const float* w;        // (3, H, B)
  const float* bias;     // (3, B)
  const int* step_idx;   // (B,)
  const float* legs;     // (4, LEG_FLOATS)
  const float* centers;  // (H, 2)
  float* act;            // (12, B)
  bool* swing;           // (4, B)
  bool* stance;          // (4, B)
  float* v_a;            // (H, B)
  int B, H;
  Scalars s;
};

// torch.clamp on the card: NaN passes through
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float clamp_minf(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// V[h] for the phase point (p1, p2) and the center (u1, u2) of row h
__device__ __forceinline__ float feature(const Scalars& s, float p1, float p2,
                                         float u1, float u2) {
  const float e1 = __fsub_rn(p1, u1);
  const float e2 = __fsub_rn(p2, u2);
  const float d2 = __fadd_rn(__fmul_rn(e1, e1), __fmul_rn(e2, e2));
  return expf(__fmul_rn(-d2, s.inv_sigma_sq));
}

__device__ __forceinline__ void phase_point(const Scalars& s, float t,
                                            float* p1, float* p2) {
  *p1 = __fmul_rn(sinf(__fadd_rn(__fmul_rn(t, s.w1), s.ph1)), s.amp);
  *p2 = __fmul_rn(sinf(__fadd_rn(__fmul_rn(t, s.w2), s.ph2)), s.amp);
}

// out[x] = sum over rows h in [begin, end) of w[x,h,n] V[h], an FMA chain
// in order of h (rows past `end` in a chunk are loaded at `begin` and left
// out by a select)
__device__ __forceinline__ void sum_rows(const Args& a, float p1, float p2,
                                         int n, int begin, int end,
                                         bool write_v, float* out) {
  const float* __restrict__ wp = a.w;
  float* __restrict__ vp = a.v_a;
  const int B = a.B;
  const size_t plane = (size_t)a.H * B;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int h0 = begin; h0 < end; h0 += CHUNK) {
    float wv[3][CHUNK], u1[CHUNK], u2[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int h = h0 + j < end ? h0 + j : begin;
      const size_t o = (size_t)h * B + n;
#pragma unroll
      for (int x = 0; x < 3; ++x) wv[x][j] = __ldg(wp + x * plane + o);
      u1[j] = __ldg(a.centers + 2 * h);
      u2[j] = __ldg(a.centers + 2 * h + 1);
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int h = h0 + j;
      const bool in = h < end;
      const float v = feature(a.s, p1, p2, u1[j], u2[j]);
      if (write_v && in) vp[(size_t)h * B + n] = v;
#pragma unroll
      for (int x = 0; x < 3; ++x)
        acc[x] = in ? __fmaf_rn(wv[x][j], v, acc[x]) : acc[x];
    }
  }
#pragma unroll
  for (int x = 0; x < 3; ++x) out[x] = acc[x];
}

__global__ void __launch_bounds__(NTHREADS)
    etg_residual_kernel(const Args a) {
  const int leg = threadIdx.x / LANES;
  const int n = blockIdx.x * LANES + threadIdx.x % LANES;
  if (n >= a.B) return;
  const Scalars& s = a.s;
  const int B = a.B, H = a.H;
  const float* lc = a.legs + leg * LEG_FLOATS;
  const bool sel_a = __ldg(lc + SEL_A) != 0.0f;
  const float t_a = __fmul_rn((float)__ldg(a.step_idx + n), s.dt);
  const float t = sel_a ? t_a : __fadd_rn(t_a, s.half_t);
  float p1, p2;
  phase_point(s, t, &p1, &p2);
  const bool write_v = leg == 0 && sel_a;

  // the readout: the two halves of h, then their sum
  const int half = (H + 1) / 2;
  float lo[3], hi[3], acc[3];
  sum_rows(a, p1, p2, n, 0, half, write_v, lo);
  sum_rows(a, p1, p2, n, half, H, write_v, hi);
#pragma unroll
  for (int x = 0; x < 3; ++x) acc[x] = __fadd_rn(lo[x], hi[x]);
  if (leg == 0 && !sel_a) {   // a pairing whose leg 0 is not in group a
    float q1, q2;
    phase_point(s, t_a, &q1, &q2);
    for (int h = 0; h < H; ++h)
      a.v_a[(size_t)h * B + n] = feature(
          s, q1, q2, __ldg(a.centers + 2 * h), __ldg(a.centers + 2 * h + 1));
  }

  // the leg's foot target in its hip frame
  const float dx = __fadd_rn(__fadd_rn(acc[0], __ldg(a.bias + n)),
                             __ldg(lc + STX));
  const float dy = __fadd_rn(__fadd_rn(acc[1], __ldg(a.bias + B + n)),
                             __ldg(lc + LAT));
  const float dz = __fadd_rn(acc[2], __ldg(a.bias + 2 * B + n));
  const float fx = __fadd_rn(__ldg(lc + FX0), dx);
  const float fy = __fadd_rn(__ldg(lc + FY0), dy);
  const float fz = __fadd_rn(__ldg(lc + FZ0), dz);
  const float l_hip = __ldg(lc + L_HIP);

  // closed-form leg IK (ops/etg_residual.soa_ik)
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(fx, fx), __fmul_rn(fy, fy)),
                             __fmul_rn(fz, fz));
  const float cos_knee = __fmul_rn(
      __fsub_rn(__fsub_rn(__fsub_rn(d2, __fmul_rn(l_hip, l_hip)),
                          s.l_low_sq), s.l_up_sq),
      s.inv_2_l_low_up);
  const float t_knee = -acosf(clampf(cos_knee, -1.0f, 1.0f));
  const float l = __fsqrt_rn(clamp_minf(
      __fadd_rn(__fmul_rn(cosf(t_knee), s.two_l_up_low), s.l_sq_sum),
      s.sq_min));
  const float half_knee = __fmul_rn(t_knee, 0.5f);
  const float t_hip = __fsub_rn(asinf(clampf(__fdiv_rn(-fx, l), -1.0f, 1.0f)),
                                half_knee);
  const float c_eff = cosf(__fadd_rn(t_hip, half_knee));
  const float l_c = __fmul_rn(l, c_eff);
  const float c1 = __fsub_rn(__fmul_rn(l_hip, fy), __fmul_rn(l_c, fz));
  const float s1 = __fadd_rn(__fmul_rn(l_c, fy), __fmul_rn(l_hip, fz));
  const float t_ab = atan2f(s1, c1);

  float* act = a.act + (size_t)(3 * leg) * B + n;
  act[0] = __fsub_rn(t_ab, __ldg(lc + Q0));
  act[(size_t)B] = __fsub_rn(t_hip, __ldg(lc + Q0 + 1));
  act[2 * (size_t)B] = __fsub_rn(t_knee, __ldg(lc + Q0 + 2));
  a.swing[(size_t)leg * B + n] = dz > s.swing_z;
  a.stance[(size_t)leg * B + n] = dz <= s.stance_z;
}

cudaError_t check(long long B, long long H) {
  if (B < 1 || B > (1LL << 31) / (3 * MAX_H) || H < 1 || H > MAX_H)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace
}  // namespace prt_etg

// act (12, B), swing and stance (4, B), v_a (H, B) from w (3, H, B), bias
// (3, B), step_idx (B,) int32, legs (4, 10) and centers (H, 2), every tensor
// contiguous on the current device; scalars a host array of 16 floats (the
// Scalars struct's order). Launched on `stream`; returns a cudaError_t.
extern "C" int prt_etg_residual(const void* w, const void* bias,
                                const void* step_idx, const void* legs,
                                const void* centers, const float* scalars,
                                long long B, long long H, void* act,
                                void* swing, void* stance, void* v_a,
                                void* stream) {
  using namespace prt_etg;
  cudaError_t e = check(B, H);
  if (e != cudaSuccess) return (int)e;
  Args a{(const float*)w,       (const float*)bias, (const int*)step_idx,
         (const float*)legs,    (const float*)centers,
         (float*)act,           (bool*)swing,       (bool*)stance,
         (float*)v_a,           (int)B,             (int)H,
         {}};
  memcpy(&a.s, scalars, sizeof(Scalars));
  const unsigned blocks = (unsigned)((B + LANES - 1) / LANES);
  etg_residual_kernel<<<blocks, NTHREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The launch prt_etg_residual makes for (B, H): blocks, threads a block,
// envs a block, readout rows a chunk.
extern "C" int prt_etg_residual_plan(long long B, long long H,
                                     long long* out) {
  using namespace prt_etg;
  cudaError_t e = check(B, H);
  if (e != cudaSuccess) return (int)e;
  const long long vals[4] = {(B + LANES - 1) / LANES, NTHREADS, LANES, CHUNK};
  for (int i = 0; i < 4; ++i) out[i] = vals[i];
  return 0;
}

extern "C" const char* prt_etg_residual_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

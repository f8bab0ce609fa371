// One physics control step of the batched A1 quadruped, for sm_90a.
//
// Replaces the TPU kernel paddlerobotics_tpu/ops/pallas/physics_step.py,
// control_step_pallas (body _kernel). Each launch runs n = action_repeat
// substeps for every env: PD/torque/hybrid motor law (optionally on the
// pd-latency-delayed (q, qd)), chain poses and velocities, penalty contacts
// for foot, knee and base on the analytic terrain, blockwise articulated-
// body forward dynamics under per-env BDynParams, semi-implicit Euler with
// an exp-map quaternion. It writes the new state, the last substep's tau
// and contacts, and the newest S = min(L, n) substep rows [q|qd|quat|w].
// Its plain version is paddlerobotics_torch/sim/sbatch.control_step; the
// arithmetic below follows it operation for operation (same order of every
// sum, no FMA contraction: built with --fmad=false), so on the card the two
// agree to the last bit wherever the math library calls agree.
//
// Design: one warp per leg. A block is 4 warps; warp l is leg l and lane t
// is env 32 * blockIdx.x + t, so every (k, B) row access is one 128-byte
// line per warp, and the per-leg __constant__ tables (generated header
// physics_consts.h) are read at a warp-uniform index, as a broadcast. At
// B = 4096 the 128 blocks give a warp to 512 of the card's 528 SM
// sub-partitions. Per substep each warp runs its leg's motor law, poses,
// velocities, foot and knee contacts and the calf -> thigh -> hip
// elimination (passes 1 and 2), and hands the leg's 33 floats (articulated
// inertia and bias force seen from the base) to the other warps through
// shared memory, double-buffered across substeps so that one
// __syncthreads() per substep suffices. Every warp then sums the four legs
// in leg order, ((l0 + l1) + l2) + l3, as the plain version does, and
// computes the base (contact, bias force, 6x6 Cholesky) and its
// integration redundantly: the same inputs and instructions give the same
// bits in every warp, and no second barrier is needed to share a0. Pass 3
// and the joint integration are per leg again. Warp 0 alone writes the
// base outputs; each warp writes its own joints' rows of the outputs, of
// the snapshot rows and of the pd-latency ring, which is rotated in place.
// Lanes past B compute a copy of env B - 1 and store nothing, so every
// lane reaches every barrier; they read no pd-ring row, which env B - 1's
// own lane rewrites in the same warp with no ordering against them.
//
// The stages are DEV functions: device code under nvcc, plain inline
// functions under a host compiler. Built with g++ -x c++, the same stages
// run per env with the legs in a loop and the exchange through an array in
// leg order (prt_control_step_host), which the CPU tests hold against the
// JAX package.
//
// Bound on an H100 SXM (3.35 TB/s HBM3, 67 TFLOP/s FP32 outside the tensor
// cores), B = 4096, default config (S = 2, no DR): bytes = 111 input rows
// (37 state, 24 last action and action, 50 BDynParams rows read) and 132
// output rows (37 state, 12 tau, 12 foot position, 9 contact, 2 x 31
// snapshot) x B x 4 bytes = 3.98 MB, 1.19 us; operations = the plain
// version's 84k elementwise operations per env per control step x 4096 =
// 344 M, 5.13 us at the FMA rate and 10.3 us at the 33.5 T operations/s
// that FP32 operations issue at when none is fused (this kernel's case).
// chip_smoke.py recounts them from each run's inputs and times the kernel
// beside them.
//
// chip_smoke.py measured 0.073 ms of device time per launch there (NVIDIA
// H100 80GB HBM3, 700 W), 7% of that bound, at 225-232 registers and no
// spills. Why it stays far from the bound: each sub-partition holds one
// warp, which runs a long chain of dependent scalar operations at their
// latency with nothing to hide it. Spreading a leg's 3x3 algebra over
// lanes, for more warps per sub-partition, is the next step.

#include <cstdint>
#include <cmath>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#define DEV __device__ __forceinline__
#define PRT_CONST __constant__
#else
#define HD inline
#define DEV inline
#define PRT_CONST static const
#endif

#include "physics_consts.h"

namespace prt {

HD float rsq(float x) {
#ifdef __CUDA_ARCH__
  return rsqrtf(x);  // torch.rsqrt on CUDA calls the same function
#else
  return 1.0f / sqrtf(x);
#endif
}

// max / min / clamp that return NaN when an operand is NaN, as
// torch.maximum, torch.minimum and torch.clamp do in the plain version
// (fmaxf / fminf return the other operand), so a NaN made inside the
// kernel reaches its outputs as it reaches the plain version's
HD float fmaxn(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
HD float fminn(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
HD float clampf(float x, float lo, float hi) { return fminn(fmaxn(x, lo), hi); }

// ---- small algebra: every sum in the plain version's order ---------------

HD float dot3(const float a[3], const float b[3]) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}
HD void mv(const float M[3][3], const float v[3], float o[3]) {
  for (int i = 0; i < 3; ++i) o[i] = dot3(M[i], v);
}
// Mᵀ v
HD void mtv(const float M[3][3], const float v[3], float o[3]) {
  for (int i = 0; i < 3; ++i)
    o[i] = (M[0][i] * v[0] + M[1][i] * v[1]) + M[2][i] * v[2];
}
HD void mm(const float A[3][3], const float B[3][3], float o[3][3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      o[i][j] = (A[i][0] * B[0][j] + A[i][1] * B[1][j]) + A[i][2] * B[2][j];
}
HD void cross(const float a[3], const float b[3], float o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}
HD void vadd(float a[3], const float b[3]) {
  for (int i = 0; i < 3; ++i) a[i] = a[i] + b[i];
}
HD void madd(float A[3][3], const float B[3][3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) A[i][j] = A[i][j] + B[i][j];
}

// Rotations with structural zeros folded. rot<0>(c, s) is smallalg.rot_x,
// rot<1>(c, s) is rot_y; the transpose is the same rotation with -s.
// A @ rot<AX>(c, s)
template <int AX>
HD void mm_rot(const float A[3][3], float c, float s, float o[3][3]) {
  for (int i = 0; i < 3; ++i) {
    if (AX == 0) {
      o[i][0] = A[i][0];
      o[i][1] = A[i][1] * c + A[i][2] * s;
      o[i][2] = A[i][1] * (-s) + A[i][2] * c;
    } else {
      o[i][0] = A[i][0] * c + A[i][2] * (-s);
      o[i][1] = A[i][1];
      o[i][2] = A[i][0] * s + A[i][2] * c;
    }
  }
}
// rot<AX>(c, s) @ A
template <int AX>
HD void rot_mm(float c, float s, const float A[3][3], float o[3][3]) {
  for (int j = 0; j < 3; ++j) {
    if (AX == 0) {
      o[0][j] = A[0][j];
      o[1][j] = c * A[1][j] + (-s) * A[2][j];
      o[2][j] = s * A[1][j] + c * A[2][j];
    } else {
      o[0][j] = c * A[0][j] + s * A[2][j];
      o[1][j] = A[1][j];
      o[2][j] = (-s) * A[0][j] + c * A[2][j];
    }
  }
}
// rot<AX>(c, s) @ v
template <int AX>
HD void rot_mv(float c, float s, const float v[3], float o[3]) {
  if (AX == 0) {
    o[0] = v[0];
    o[1] = c * v[1] + (-s) * v[2];
    o[2] = s * v[1] + c * v[2];
  } else {
    o[0] = c * v[0] + s * v[2];
    o[1] = v[1];
    o[2] = (-s) * v[0] + c * v[2];
  }
}

// ---- spatial algebra (sbatch.py) ------------------------------------------

// A leg link's articulated inertia [[A, H], [Hᵀ, M]].
struct Ine {
  float A[3][3], H[3][3], M[3][3];
};

// [[A,H],[Hᵀ,M]] @ [w;u] → (n, f)
HD void iv_product(const Ine& I, const float w[3], const float u[3],
                   float n[3], float f[3]) {
  float t[3];
  mv(I.A, w, n);
  mv(I.H, u, t);
  vadd(n, t);
  mtv(I.H, w, f);
  mv(I.M, u, t);
  vadd(f, t);
}

// bias force: crf([w;u]) Iv − f_ext
HD void bias_force(const Ine& I, const float w[3], const float u[3],
                   const float nf[3], const float ff[3], float pn[3],
                   float pf[3]) {
  float n[3], f[3], t[3];
  iv_product(I, w, u, n, f);
  cross(w, n, pn);
  cross(u, f, t);
  vadd(pn, t);
  cross(w, f, pf);
  for (int i = 0; i < 3; ++i) {
    pn[i] = pn[i] - nf[i];
    pf[i] = pf[i] - ff[i];
  }
}

// What pass 3 reads of one joint.
struct Joint {
  float Ua[3], Ul[3], d, uu;
};

// Articulated-body elimination of joint axis AX; I becomes Ia, (pn, pf)
// becomes pa.
template <int AX>
HD void eliminate(Ine& I, float pn[3], float pf[3], float tau_j,
                  const float cw[3], const float cu[3], Joint& J) {
  for (int i = 0; i < 3; ++i) {
    J.Ua[i] = I.A[i][AX];
    J.Ul[i] = I.H[AX][i];
  }
  J.d = I.A[AX][AX];
  J.uu = tau_j - pn[AX];
  const float inv_d = 1.0f / J.d;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      I.A[i][j] = I.A[i][j] - inv_d * (J.Ua[i] * J.Ua[j]);
      I.H[i][j] = I.H[i][j] - inv_d * (J.Ua[i] * J.Ul[j]);
      I.M[i][j] = I.M[i][j] - inv_d * (J.Ul[i] * J.Ul[j]);
    }
  float ia_n[3], ia_f[3];
  iv_product(I, cw, cu, ia_n, ia_f);
  const float k = J.uu * inv_d;
  for (int i = 0; i < 3; ++i) {
    pn[i] = (pn[i] + ia_n[i]) + k * J.Ua[i];
    pf[i] = (pf[i] + ia_f[i]) + k * J.Ul[i];
  }
}

HD void skew(const float r[3], float o[3][3]) {
  o[0][0] = 0.0f;  o[0][1] = -r[2]; o[0][2] = r[1];
  o[1][0] = r[2];  o[1][1] = 0.0f;  o[1][2] = -r[0];
  o[2][0] = -r[1]; o[2][1] = r[0];  o[2][2] = 0.0f;
}

// Blocks of Xᵀ [[A,H],[Hᵀ,M]] X for X = [[E,0],[−Er̂,E]], E = rot<AX>(c,−s),
// written over I.
template <int AX>
HD void xform_inertia_to_parent(float c, float s, const float r[3], Ine& I) {
  float t[3][3], Ap[3][3], Hp[3][3], Mp[3][3], rx[3][3], HpRx[3][3],
      RxMp[3][3], t2[3][3];
  mm_rot<AX>(I.A, c, -s, t);
  rot_mm<AX>(c, s, t, Ap);
  mm_rot<AX>(I.H, c, -s, t);
  rot_mm<AX>(c, s, t, Hp);
  mm_rot<AX>(I.M, c, -s, t);
  rot_mm<AX>(c, s, t, Mp);
  skew(r, rx);
  mm(Hp, rx, HpRx);
  mm(rx, Mp, RxMp);
  mm(RxMp, rx, t2);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      I.A[i][j] = ((Ap[i][j] - HpRx[i][j]) - HpRx[j][i]) - t2[i][j];
      I.H[i][j] = Hp[i][j] + RxMp[i][j];
      I.M[i][j] = Mp[i][j];
    }
}

// n_P = Eᵀn + r×(Eᵀf); f_P = Eᵀf, written over (n, f).
template <int AX>
HD void xform_force_to_parent(float c, float s, const float r[3], float n[3],
                              float f[3]) {
  float fp[3], np_[3], t[3];
  rot_mv<AX>(c, s, f, fp);
  rot_mv<AX>(c, s, n, np_);
  cross(r, fp, t);
  for (int i = 0; i < 3; ++i) {
    n[i] = np_[i] + t[i];
    f[i] = fp[i];
  }
}

// child←parent motion [Ew, E(u − r×w)], E = rot<AX>(c, −s)
template <int AX>
HD void xform_motion(float c, float s, const float r[3], const float w[3],
                     const float u[3], float wo[3], float uo[3]) {
  float cr[3], t[3];
  rot_mv<AX>(c, -s, w, wo);
  cross(r, w, cr);
  for (int i = 0; i < 3; ++i) t[i] = u[i] - cr[i];
  rot_mv<AX>(c, -s, t, uo);
}

// Spatial inertia blocks of one rigid link about its frame origin:
// A = Ic·scale + m ĉĉᵀ, H = m ĉ, M = m·1.
HD void link_inertia(const float Ic[3][3], float sc, float m,
                     const float cct[3][3], const float cskew[3][3], Ine& I) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      I.A[i][j] = Ic[i][j] * sc + m * cct[i][j];
      I.H[i][j] = m * cskew[i][j];
      I.M[i][j] = i == j ? m : 0.0f;
    }
}

// World force at a world point → body-frame spatial force (n, f).
HD void ext_force_local(const float R[3][3], const float origin[3],
                        const float point[3], const float fw[3], float n[3],
                        float f[3]) {
  float arm[3], t[3];
  mtv(R, fw, f);
  for (int i = 0; i < 3; ++i) arm[i] = point[i] - origin[i];
  cross(arm, fw, t);
  mtv(R, t, n);
}

// gravity at the COM of a body with mass m
HD void grav(const float R[3][3], const float origin[3], float m,
             const float com[3], const float g[3], float n[3], float f[3]) {
  float fw[3], cw[3];
  for (int i = 0; i < 3; ++i) fw[i] = m * g[i];
  mv(R, com, cw);
  for (int i = 0; i < 3; ++i) cw[i] = origin[i] + cw[i];
  ext_force_local(R, origin, cw, fw, n, f);
}

// ---- terrain (sim/terrain.py) -----------------------------------------------

struct Terrain {
  float x0, sh, sw, sl, x0_run, x1, bw_half, x0_bl;
};

enum {
  TERRAIN_GROUND = 0, TERRAIN_UP_SLOPE, TERRAIN_DOWN_SLOPE,
  TERRAIN_SLOPESLOPE, TERRAIN_UP_STAIR, TERRAIN_DOWN_STAIR,
  TERRAIN_STAIRSTAIR, TERRAIN_OBSTACLE, TERRAIN_BALANCE_BEAM, N_TERRAIN
};

// terrain._hash01: multiplies in uint32 (signed overflow is undefined in
// C++), then int32 with an arithmetic >>, as the int32 JAX/torch arrays do.
HD float hash01(int32_t ix, int32_t iy) {
  uint32_t hu = (uint32_t)ix * 374761393u + (uint32_t)iy * 668265263u;
  int32_t h = (int32_t)hu;
  hu = (uint32_t)(h ^ (h >> 13)) * 1274126177u;
  h = (int32_t)hu;
  h = h ^ (h >> 16);
  h = h & 0x7FFFFF;
  return (float)h * (1.0f / 8388608.0f);
}

HD float stairs(float x, float x0, float sw) {
  return clampf(floorf((x - x0) / sw) + 1.0f, 0.0f, 10.0f);
}

template <int MODE>
HD float terrain_h(float x, float y, const Terrain& t) {
  if (MODE == TERRAIN_UP_SLOPE) return t.sl * clampf(x - t.x0, 0.0f, 3.0f);
  if (MODE == TERRAIN_DOWN_SLOPE)
    return (-t.sl) * clampf(x - t.x0, 0.0f, 3.0f);
  if (MODE == TERRAIN_SLOPESLOPE) {
    const float up = t.sl * clampf(x - t.x0, 0.0f, 3.0f);
    const float down = t.sl * clampf(x - t.x0_run, 0.0f, 3.0f);
    return up - down;
  }
  if (MODE == TERRAIN_UP_STAIR) return t.sh * stairs(x, t.x0, t.sw);
  if (MODE == TERRAIN_DOWN_STAIR) return (-t.sh) * stairs(x, t.x0, t.sw);
  if (MODE == TERRAIN_STAIRSTAIR)
    return t.sh * (stairs(x, t.x0, t.sw) - stairs(x, t.x1, t.sw));
  if (MODE == TERRAIN_OBSTACLE) {
    const int32_t gx = (int32_t)floorf((x - t.x0) / 0.5f);
    const int32_t gy = (int32_t)floorf(y / 0.5f);
    const float r = hash01(gx, gy);
    const bool present = (r > 0.55f) && (gx >= 0);
    const float hgt = t.sh * (0.5f + 0.5f * hash01(gy + 7, gx + 13));
    return present ? hgt : 0.0f;
  }
  if (MODE == TERRAIN_BALANCE_BEAM) {
    const bool over_gap = (x >= t.x0) && (x < t.x0_bl);
    const float off = fmaxn(fabsf(y) - t.bw_half, 0.0f);
    const float drop = -0.5f - 2.0f * off;
    return (over_gap && off > 0.0f) ? drop : 0.0f;
  }
  return 0.0f;
}

// Penalty normal + regularized, impulse-capped Coulomb friction at a
// sphere-tip point (sbatch._point_contact). Returns phi.
template <int MODE>
HD float point_contact(const float p[3], const float v[3], float radius,
                       float k, float d, float mu, float vs2, float cap,
                       const Terrain& t, float f[3]) {
  const float eps = 0.01f;
  const float h = terrain_h<MODE>(p[0], p[1], t);
  const float dhdx =
      (terrain_h<MODE>(p[0] + eps, p[1], t) -
       terrain_h<MODE>(p[0] - eps, p[1], t)) * 50.0f;
  const float dhdy =
      (terrain_h<MODE>(p[0], p[1] + eps, t) -
       terrain_h<MODE>(p[0], p[1] - eps, t)) * 50.0f;
  const float inv_n = rsq((dhdx * dhdx + dhdy * dhdy) + 1.0f);
  const float nx = (-dhdx) * inv_n, ny = (-dhdy) * inv_n, nz = inv_n;
  const float phi = h - (p[2] - radius);
  const float in_contact = phi > 0.0f ? 1.0f : 0.0f;
  const float phi_c = fminn(fmaxn(phi, 0.0f) * nz, 0.04f);
  const float vn = (v[0] * nx + v[1] * ny) + v[2] * nz;
  const float fn = fmaxn(k * phi_c - (d * vn) * in_contact, 0.0f);
  const float vtx = v[0] - vn * nx, vty = v[1] - vn * ny,
              vtz = v[2] - vn * nz;
  const float inv_vt = rsq(((vtx * vtx + vty * vty) + vtz * vtz) + vs2);
  const float coef = fminn((mu * fn) * inv_vt, cap);
  const float ft = -coef;
  f[0] = fn * nx + ft * vtx;
  f[1] = fn * ny + ft * vty;
  f[2] = fn * nz + ft * vtz;
  return phi;
}

// ---- the control step ---------------------------------------------------------

constexpr int LEGS = 4;
constexpr int ENVS_PER_BLOCK = 32;  // one env per lane
constexpr int XCH = 33;             // floats a leg hands to the base

struct Args {
  // inputs, (k, B) row-major with env b at column b
  const float *pos, *quat, *w, *v, *q, *qd, *prev, *act, *qd_ref, *tau_ff;
  float* ph;  // (P, 24, B) pd-latency ring, rotated in place; null if P = 0
  const float *bms, *bis, *lms, *lis, *kp, *kd, *ff, *lat, *grav, *fext;
  // outputs
  float *o_pos, *o_quat, *o_w, *o_v, *o_q, *o_qd, *o_tau, *o_foot, *o_fcon,
      *o_kcon, *o_bcon, *o_stack;
  int B, n, S, torque, interp, on_rack, P, i0, i1;
  float dt, k, d, fcoef, vs2, cap_foot, cap_knee, cap_base, k_knee, d_knee,
      max_bv, max_jv, pd_w0, pd_w1;
  Terrain terrain;
};

// The base state; every leg warp of an env keeps and updates its own copy.
struct Base {
  float pos[3], quat[4], w[3], v[3];
};

// Per-env parameters. Each stage reads what it needs where it needs it,
// so that none of them stays live across the substep loop.
struct EnvP {
  float mu, m0, m_h, m_t, m_c, bis[3], g[3], fext[3];
};

// What the warp of one leg carries across substeps: its three joints.
struct Leg {
  float q[3], qd[3], tau[3];
};

// One leg's foot position and contact flags of a substep.
struct LegContact {
  float foot[3], fcon, kcon;
};

// What pass 3 reads of one leg.
struct LegP3 {
  float c[3], s[3];         // joint trig
  float cw[3][2], cu[3][2];  // nonzero velocity-product terms per joint
  Joint J[3];
};

HD void quat_to_mat(const float q[4], float R[3][3]) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  R[0][0] = 1.0f - 2.0f * (yy + zz);
  R[0][1] = 2.0f * (xy - wz);
  R[0][2] = 2.0f * (xz + wy);
  R[1][0] = 2.0f * (xy + wz);
  R[1][1] = 1.0f - 2.0f * (xx + zz);
  R[1][2] = 2.0f * (yz - wx);
  R[2][0] = 2.0f * (xz - wy);
  R[2][1] = 2.0f * (yz + wx);
  R[2][2] = 1.0f - 2.0f * (xx + yy);
}

#define ROW(ptr, r) (ptr)[(size_t)(r) * a.B + b]

// The stages below read the __constant__ tables: device code under nvcc.

DEV void load_base(const Args& a, int b, Base& s) {
  for (int i = 0; i < 3; ++i) {
    s.pos[i] = ROW(a.pos, i);
    s.w[i] = ROW(a.w, i);
    s.v[i] = ROW(a.v, i);
  }
  for (int i = 0; i < 4; ++i) s.quat[i] = ROW(a.quat, i);
}

DEV void load_params(const Args& a, int b, EnvP& e) {
  float lms[3];
  for (int i = 0; i < 3; ++i) {
    e.bis[i] = ROW(a.bis, i);
    lms[i] = ROW(a.lms, i);
    e.g[i] = ROW(a.grav, i);
    e.fext[i] = ROW(a.fext, i);
  }
  e.mu = a.fcoef * a.ff[b];
  e.m0 = a.bms[b] * TRUNK_MASS;
  e.m_h = lms[0] * M_HIP;
  e.m_t = lms[1] * M_THIGH;
  e.m_c = lms[2] * M_CALF;
}

DEV void load_leg(const Args& a, int b, int l, Leg& L) {
  for (int k = 0; k < 3; ++k) {
    const int j = 3 * l + k;
    L.q[k] = ROW(a.q, j);
    L.qd[k] = ROW(a.qd, j);
  }
}

// Motor law of leg l's three joints at substep it; ph_base is the physical
// slot of the newest pd-ring row. Without `ring` the law reads the joint
// state in place of the ring (a tail lane, whose env's ring column the
// live lane of that env writes unordered with this read).
DEV void leg_motor(const Args& a, int b, int l, int it, int ph_base,
                   bool ring, Leg& L) {
  const float t = (float)(it + 1) / (float)a.n;
  for (int k = 0; k < 3; ++k) {
    const int j = 3 * l + k;
    const float prev = ROW(a.prev, j), act = ROW(a.act, j);
    const float cmd = a.interp ? prev + t * (act - prev) : act;
    float tj;
    if (a.torque) {
      tj = clampf(cmd, -TORQUE_LIMIT, TORQUE_LIMIT);
    } else {
      float q_in = L.q[k], qd_in = L.qd[k];
      if (a.P > 0 && ring) {
        const int s0 = (ph_base + a.i0) % a.P, s1 = (ph_base + a.i1) % a.P;
        q_in = a.pd_w0 * ROW(a.ph, s0 * 24 + j) +
               a.pd_w1 * ROW(a.ph, s1 * 24 + j);
        qd_in = a.pd_w0 * ROW(a.ph, s0 * 24 + 12 + j) +
                a.pd_w1 * ROW(a.ph, s1 * 24 + 12 + j);
      }
      const float qd_err = a.qd_ref ? qd_in - ROW(a.qd_ref, j) : qd_in;
      tj = (-ROW(a.kp, j)) * (q_in - cmd) - ROW(a.kd, j) * qd_err;
      if (a.tau_ff) tj = tj + ROW(a.tau_ff, j);
      tj = clampf(tj, -TORQUE_LIMIT, TORQUE_LIMIT);
    }
    L.tau[k] = tj;
  }
}

// Base rotation and world velocities.
DEV void base_frame(const Base& s, float Rb[3][3], float wW[3], float vW[3]) {
  quat_to_mat(s.quat, Rb);
  mv(Rb, s.w, wW);
  mv(Rb, s.v, vW);
}

// Passes 1 and 2 of leg l: poses, velocities, foot and knee contacts, link
// forces, calf -> thigh -> hip elimination. Fills C with the foot and its
// contacts, P with what pass 3 reads and x with the leg's articulated
// inertia and bias force at the base: A, H, M row-major (27), then pn (3)
// and pf (3).
template <int MODE>
DEV void leg_pass12(const Args& a, int b, int l, const Base& s,
                    const float Rb[3][3], const float wW[3], const float vW[3],
                    const Leg& Lg, LegContact& C, LegP3& L, float x[XCH]) {
  EnvP e;
  load_params(a, b, e);
  for (int k = 0; k < 3; ++k) {
    L.c[k] = cosf(Lg.q[k]);
    L.s[k] = sinf(Lg.q[k]);
  }
  float hip_r[3], thigh_r[3], hip_com[3], thigh_com[3], calf_com[3];
  float hip_i[3][3], thigh_i[3][3], hip_cct[3][3], thigh_cct[3][3];
  float hip_sk[3][3], thigh_sk[3][3];
  for (int i = 0; i < 3; ++i) {
    hip_r[i] = HIP_R[i][l];
    thigh_r[i] = THIGH_R[i][l];
    hip_com[i] = HIP_COM[i][l];
    thigh_com[i] = THIGH_COM[i][l];
    calf_com[i] = CALF_COM[i];
    for (int j = 0; j < 3; ++j) {
      hip_i[i][j] = HIP_I[i][j][l];
      thigh_i[i][j] = THIGH_I[i][j][l];
      hip_cct[i][j] = HIP_CCT[i][j][l];
      thigh_cct[i][j] = THIGH_CCT[i][j][l];
    }
  }
  skew(hip_com, hip_sk);
  skew(thigh_com, thigh_sk);
  const float calf_r[3] = {0.0f, 0.0f, CALF_RZ};

  // poses
  float Rh[3][3], Rt[3][3], Rc[3][3], oh[3], ot[3], oc[3], of[3], t3[3];
  mm_rot<0>(Rb, L.c[0], L.s[0], Rh);
  mv(Rb, hip_r, t3);
  for (int i = 0; i < 3; ++i) oh[i] = s.pos[i] + t3[i];
  mm_rot<1>(Rh, L.c[1], L.s[1], Rt);
  mv(Rh, thigh_r, t3);
  for (int i = 0; i < 3; ++i) ot[i] = oh[i] + t3[i];
  mm_rot<1>(Rt, L.c[2], L.s[2], Rc);
  for (int i = 0; i < 3; ++i) oc[i] = ot[i] + Rt[i][2] * CALF_RZ;
  for (int i = 0; i < 3; ++i) of[i] = oc[i] + Rc[i][2] * FOOT_RZ;

  // velocities (pass 1)
  const float qd1 = Lg.qd[0], qd2 = Lg.qd[1], qd3 = Lg.qd[2];
  float w1[3], u1[3], w2[3], u2[3], w3[3], u3[3];
  xform_motion<0>(L.c[0], L.s[0], hip_r, s.w, s.v, w1, u1);
  w1[0] = w1[0] + qd1;
  L.cw[0][0] = w1[2] * qd1;  L.cw[0][1] = -(w1[1] * qd1);
  L.cu[0][0] = u1[2] * qd1;  L.cu[0][1] = -(u1[1] * qd1);
  xform_motion<1>(L.c[1], L.s[1], thigh_r, w1, u1, w2, u2);
  w2[1] = w2[1] + qd2;
  L.cw[1][0] = -(w2[2] * qd2);  L.cw[1][1] = w2[0] * qd2;
  L.cu[1][0] = -(u2[2] * qd2);  L.cu[1][1] = u2[0] * qd2;
  {
    // calf joint on the thigh's z axis: r×w = (−(z w1), z w0, 0)
    float t[3];
    t[0] = u2[0] - (-(CALF_RZ * w2[1]));
    t[1] = u2[1] - CALF_RZ * w2[0];
    t[2] = u2[2];
    rot_mv<1>(L.c[2], -L.s[2], w2, w3);
    rot_mv<1>(L.c[2], -L.s[2], t, u3);
  }
  w3[1] = w3[1] + qd3;
  L.cw[2][0] = -(w3[2] * qd3);  L.cw[2][1] = w3[0] * qd3;
  L.cu[2][0] = -(u3[2] * qd3);  L.cu[2][1] = u3[0] * qd3;

  // contacts: foot (calf tip) and knee (calf origin)
  float vf[3], ff3[3], kf3[3];
  {
    float t[3];
    t[0] = u3[0] + w3[1] * FOOT_RZ;
    t[1] = u3[1] + (-(w3[0] * FOOT_RZ));
    t[2] = u3[2];
    mv(Rc, t, vf);
  }
  const float fphi = point_contact<MODE>(of, vf, FOOT_RADIUS, a.k, a.d, e.mu,
                                         a.vs2, a.cap_foot, a.terrain, ff3);
  float relk[3], vk[3];
  for (int i = 0; i < 3; ++i) relk[i] = oc[i] - s.pos[i];
  cross(wW, relk, vk);
  for (int i = 0; i < 3; ++i) vk[i] = vW[i] + vk[i];
  const float kphi = point_contact<MODE>(oc, vk, 0.02f, a.k_knee, a.d_knee,
                                         e.mu, a.vs2, a.cap_knee, a.terrain,
                                         kf3);
  for (int i = 0; i < 3; ++i) C.foot[i] = of[i];
  C.fcon = fphi > 0.0f ? 1.0f : 0.0f;
  C.kcon = kphi > 0.0f ? 1.0f : 0.0f;

  // external forces on the three links
  float n1f[3], f1f[3], n2f[3], f2f[3], n3f[3], f3f[3], nc[3], fc[3];
  grav(Rh, oh, e.m_h, hip_com, e.g, n1f, f1f);
  grav(Rt, ot, e.m_t, thigh_com, e.g, n2f, f2f);
  grav(Rc, oc, e.m_c, calf_com, e.g, n3f, f3f);
  ext_force_local(Rc, oc, of, ff3, nc, fc);
  vadd(n3f, nc);
  vadd(f3f, fc);
  // the knee force acts at the calf origin: no moment
  mtv(Rc, kf3, fc);
  vadd(f3f, fc);

  // pass 2: calf → thigh → hip
  const float scl[3] = {ROW(a.lis, 3 * l), ROW(a.lis, 3 * l + 1),
                        ROW(a.lis, 3 * l + 2)};
  float cw[3], cu[3];
  Ine I3, I2, I1;
  float pn[3], pf[3], bn[3], bf[3];
  {
    float calf_i[3][3], calf_cct[3][3], calf_sk[3][3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        calf_i[i][j] = CALF_I[i][j];
        calf_cct[i][j] = CALF_CCT[i][j];
        calf_sk[i][j] = CALF_SKEW[i][j];
      }
    link_inertia(calf_i, scl[2], e.m_c, calf_cct, calf_sk, I3);
  }
  bias_force(I3, w3, u3, n3f, f3f, pn, pf);
  cw[0] = L.cw[2][0]; cw[1] = 0.0f; cw[2] = L.cw[2][1];
  cu[0] = L.cu[2][0]; cu[1] = 0.0f; cu[2] = L.cu[2][1];
  eliminate<1>(I3, pn, pf, Lg.tau[2], cw, cu, L.J[2]);
  xform_inertia_to_parent<1>(L.c[2], L.s[2], calf_r, I3);
  xform_force_to_parent<1>(L.c[2], L.s[2], calf_r, pn, pf);

  link_inertia(thigh_i, scl[1], e.m_t, thigh_cct, thigh_sk, I2);
  bias_force(I2, w2, u2, n2f, f2f, bn, bf);
  madd(I2.A, I3.A);
  madd(I2.H, I3.H);
  madd(I2.M, I3.M);
  for (int i = 0; i < 3; ++i) {
    pn[i] = bn[i] + pn[i];
    pf[i] = bf[i] + pf[i];
  }
  cw[0] = L.cw[1][0]; cw[1] = 0.0f; cw[2] = L.cw[1][1];
  cu[0] = L.cu[1][0]; cu[1] = 0.0f; cu[2] = L.cu[1][1];
  eliminate<1>(I2, pn, pf, Lg.tau[1], cw, cu, L.J[1]);
  xform_inertia_to_parent<1>(L.c[1], L.s[1], thigh_r, I2);
  xform_force_to_parent<1>(L.c[1], L.s[1], thigh_r, pn, pf);

  link_inertia(hip_i, scl[0], e.m_h, hip_cct, hip_sk, I1);
  bias_force(I1, w1, u1, n1f, f1f, bn, bf);
  madd(I1.A, I2.A);
  madd(I1.H, I2.H);
  madd(I1.M, I2.M);
  for (int i = 0; i < 3; ++i) {
    pn[i] = bn[i] + pn[i];
    pf[i] = bf[i] + pf[i];
  }
  cw[0] = 0.0f; cw[1] = L.cw[0][0]; cw[2] = L.cw[0][1];
  cu[0] = 0.0f; cu[1] = L.cu[0][0]; cu[2] = L.cu[0][1];
  eliminate<0>(I1, pn, pf, Lg.tau[0], cw, cu, L.J[0]);
  xform_inertia_to_parent<0>(L.c[0], L.s[0], hip_r, I1);
  xform_force_to_parent<0>(L.c[0], L.s[0], hip_r, pn, pf);

  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      x[3 * i + j] = I1.A[i][j];
      x[9 + 3 * i + j] = I1.H[i][j];
      x[18 + 3 * i + j] = I1.M[i][j];
    }
    x[27 + i] = pn[i];
    x[30 + i] = pf[i];
  }
}

// The base: the four legs' x summed in leg order (leg l's entry k at
// legs[l * leg_stride + k * k_stride]), contact, external forces, 6x6
// solve for a0. Returns the base contact flag.
template <int MODE>
DEV float base_solve(const Args& a, int b, const Base& s,
                     const float Rb[3][3], const float vW[3],
                     const float* legs, int leg_stride, int k_stride,
                     float a0[6]) {
  float sum[XCH];
  for (int k = 0; k < XCH; ++k) {
    const float* xk = legs + k * k_stride;
    sum[k] = ((xk[0] + xk[leg_stride]) + xk[2 * leg_stride]) +
             xk[3 * leg_stride];
  }

  EnvP e;
  load_params(a, b, e);
  float bfv[3], n0f[3], f0f[3], t3[3], trunk_com[3];
  float bcon;
  {
    const float bp[3] = {s.pos[0], s.pos[1], s.pos[2] - TRUNK_HALF_HEIGHT};
    const float bphi = point_contact<MODE>(bp, vW, 0.0f, a.k, a.d, e.mu,
                                           a.vs2, a.cap_base, a.terrain, bfv);
    bcon = bphi > 0.0f ? 1.0f : 0.0f;
  }
  for (int i = 0; i < 3; ++i) trunk_com[i] = TRUNK_COM[i];
  grav(Rb, s.pos, e.m0, trunk_com, e.g, n0f, f0f);
  for (int i = 0; i < 3; ++i) bfv[i] = bfv[i] + e.fext[i];
  // the base force acts at the base origin: no moment
  mtv(Rb, bfv, t3);
  vadd(f0f, t3);

  Ine I0;
  {
    float trunk_i[3][3], trunk_cct[3][3], trunk_sk[3][3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        trunk_i[i][j] = TRUNK_I[i][j] * e.bis[i];
        trunk_cct[i][j] = TRUNK_CCT[i][j];
        trunk_sk[i][j] = TRUNK_SKEW[i][j];
      }
    link_inertia(trunk_i, 1.0f, e.m0, trunk_cct, trunk_sk, I0);
  }
  float pn0[3], pf0[3];
  bias_force(I0, s.w, s.v, n0f, f0f, pn0, pf0);
  for (int i = 0; i < 3; ++i) {
    pn0[i] = pn0[i] + sum[27 + i];
    pf0[i] = pf0[i] + sum[30 + i];
    for (int j = 0; j < 3; ++j) {
      I0.A[i][j] = I0.A[i][j] + sum[3 * i + j];
      I0.H[i][j] = I0.H[i][j] + sum[9 + 3 * i + j];
      I0.M[i][j] = I0.M[i][j] + sum[18 + 3 * i + j];
    }
  }

  float M6[6][6], rhs[6];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      M6[i][j] = I0.A[i][j];
      M6[i][3 + j] = I0.H[i][j];
      M6[3 + i][j] = I0.H[j][i];
      M6[3 + i][3 + j] = I0.M[i][j];
    }
  for (int i = 0; i < 3; ++i) {
    rhs[i] = -pn0[i];
    rhs[3 + i] = -pf0[i];
  }
  // unrolled Cholesky (smallalg.cholesky_solve)
  float Lc[6][6], y[6];
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j <= i; ++j) {
      float sij = M6[i][j];
      for (int k = 0; k < j; ++k) sij = sij - Lc[i][k] * Lc[j][k];
      Lc[i][j] = i == j ? sqrtf(sij) : sij / Lc[j][j];
    }
  for (int i = 0; i < 6; ++i) {
    float si = rhs[i];
    for (int k = 0; k < i; ++k) si = si - Lc[i][k] * y[k];
    y[i] = si / Lc[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float si = y[i];
    for (int k = i + 1; k < 6; ++k) si = si - Lc[k][i] * a0[k];
    a0[i] = si / Lc[i][i];
  }
  return bcon;
}

// Pass 3 of leg l: its joint accelerations, outward from a0.
DEV void leg_pass3(int l, const LegP3& L, const float a0[6], float qdd[3]) {
  float hip_r[3], thigh_r[3];
  for (int i = 0; i < 3; ++i) {
    hip_r[i] = HIP_R[i][l];
    thigh_r[i] = THIGH_R[i][l];
  }
  const float calf_r[3] = {0.0f, 0.0f, CALF_RZ};
  float aw[3] = {a0[0], a0[1], a0[2]}, au[3] = {a0[3], a0[4], a0[5]};
  float awc[3], auc[3];
  // hip (x axis)
  xform_motion<0>(L.c[0], L.s[0], hip_r, aw, au, awc, auc);
  awc[1] = awc[1] + L.cw[0][0];  awc[2] = awc[2] + L.cw[0][1];
  auc[1] = auc[1] + L.cu[0][0];  auc[2] = auc[2] + L.cu[0][1];
  float qa = ((L.J[0].uu - dot3(L.J[0].Ua, awc)) - dot3(L.J[0].Ul, auc)) /
             L.J[0].d;
  awc[0] = awc[0] + qa;
  qdd[0] = qa;
  // thigh (y axis)
  xform_motion<1>(L.c[1], L.s[1], thigh_r, awc, auc, aw, au);
  aw[0] = aw[0] + L.cw[1][0];  aw[2] = aw[2] + L.cw[1][1];
  au[0] = au[0] + L.cu[1][0];  au[2] = au[2] + L.cu[1][1];
  qa = ((L.J[1].uu - dot3(L.J[1].Ua, aw)) - dot3(L.J[1].Ul, au)) / L.J[1].d;
  aw[1] = aw[1] + qa;
  qdd[1] = qa;
  // calf (y axis, joint on the thigh's z axis)
  xform_motion<1>(L.c[2], L.s[2], calf_r, aw, au, awc, auc);
  awc[0] = awc[0] + L.cw[2][0];  awc[2] = awc[2] + L.cw[2][1];
  auc[0] = auc[0] + L.cu[2][0];  auc[2] = auc[2] + L.cu[2][1];
  qa = ((L.J[2].uu - dot3(L.J[2].Ua, awc)) - dot3(L.J[2].Ul, auc)) /
       L.J[2].d;
  qdd[2] = qa;
}

// Semi-implicit Euler of one leg's joints.
DEV void integrate_leg(const Args& a, const float qdd[3], Leg& L) {
  for (int k = 0; k < 3; ++k) {
    L.qd[k] = clampf(L.qd[k] + a.dt * qdd[k], -a.max_jv, a.max_jv);
    L.q[k] = L.q[k] + a.dt * L.qd[k];
  }
}

// Semi-implicit Euler of the base, exp-map quaternion.
DEV void integrate_base(const Args& a, const float Rb[3][3],
                        const float a0[6], Base& s) {
  const float dt = a.dt;
  float wn[3], vn[3];
  for (int i = 0; i < 3; ++i) {
    wn[i] = clampf(s.w[i] + dt * a0[i], -a.max_bv, a.max_bv);
    vn[i] = clampf(s.v[i] + dt * a0[3 + i], -a.max_bv, a.max_bv);
  }
  if (a.on_rack) {
    // base welded in place (minitaur.py:106, 418)
    for (int i = 0; i < 3; ++i) {
      s.w[i] = 0.0f;
      s.v[i] = 0.0f;
    }
    return;
  }
  float vw[3], ww[3];
  mv(Rb, vn, vw);
  for (int i = 0; i < 3; ++i) s.pos[i] = s.pos[i] + dt * vw[i];
  mv(Rb, wn, ww);
  const float ang =
      sqrtf(((ww[0] * ww[0] + ww[1] * ww[1]) + ww[2] * ww[2]) + 1e-16f);
  const float half = (0.5f * ang) * dt;
  const float sc = sinf(half) / ang;
  const float dqw = cosf(half), dqx = sc * ww[0], dqy = sc * ww[1],
              dqz = sc * ww[2];
  const float qw = s.quat[0], qx = s.quat[1], qy = s.quat[2], qz = s.quat[3];
  const float nw = ((dqw * qw - dqx * qx) - dqy * qy) - dqz * qz;
  const float nx = ((dqw * qx + dqx * qw) + dqy * qz) - dqz * qy;
  const float ny = ((dqw * qy - dqx * qz) + dqy * qw) + dqz * qx;
  const float nz = ((dqw * qz + dqx * qy) - dqy * qx) + dqz * qw;
  const float inv = rsq(((nw * nw + nx * nx) + ny * ny) + nz * nz);
  s.quat[0] = nw * inv;
  s.quat[1] = nx * inv;
  s.quat[2] = ny * inv;
  s.quat[3] = nz * inv;
  for (int i = 0; i < 3; ++i) {
    s.w[i] = wn[i];
    s.v[i] = vn[i];
  }
}

// After substep it: leg l's rows of the newest S snapshot rows
// [q | qd | quat | w] (the base rows too when `base`), and its rows of the
// pd-latency ring at the new newest slot ph_base.
DEV void store_substep(const Args& a, int b, int l, int it, int ph_base,
                       const Leg& L, const Base& s, bool base) {
  const int r = it - (a.n - a.S);
  if (r >= 0) {
    float* row = a.o_stack + (size_t)r * 31 * a.B;
    for (int k = 0; k < 3; ++k) {
      ROW(row, 3 * l + k) = L.q[k];
      ROW(row, 12 + 3 * l + k) = L.qd[k];
    }
    if (base) {
      for (int i = 0; i < 4; ++i) ROW(row, 24 + i) = s.quat[i];
      for (int i = 0; i < 3; ++i) ROW(row, 28 + i) = s.w[i];
    }
  }
  if (a.P > 0) {
    for (int k = 0; k < 3; ++k) {
      ROW(a.ph, ph_base * 24 + 3 * l + k) = L.q[k];
      ROW(a.ph, ph_base * 24 + 12 + 3 * l + k) = L.qd[k];
    }
  }
}

// Leg l's foot and contact rows of the outputs (from the last substep).
DEV void store_contact(const Args& a, int b, int l, const LegContact& C) {
  for (int k = 0; k < 3; ++k) ROW(a.o_foot, k * 4 + l) = C.foot[k];
  ROW(a.o_fcon, l) = C.fcon;
  ROW(a.o_kcon, l) = C.kcon;
}

// Leg l's joint rows of the outputs.
DEV void store_leg(const Args& a, int b, int l, const Leg& L) {
  for (int k = 0; k < 3; ++k) {
    ROW(a.o_q, 3 * l + k) = L.q[k];
    ROW(a.o_qd, 3 * l + k) = L.qd[k];
    ROW(a.o_tau, 3 * l + k) = L.tau[k];
  }
}

// The base's rows of the outputs.
DEV void store_base(const Args& a, int b, const Base& s, float bcon) {
  for (int i = 0; i < 3; ++i) {
    ROW(a.o_pos, i) = s.pos[i];
    ROW(a.o_w, i) = s.w[i];
    ROW(a.o_v, i) = s.v[i];
  }
  for (int i = 0; i < 4; ++i) ROW(a.o_quat, i) = s.quat[i];
  a.o_bcon[b] = bcon;
}

#undef ROW

HD void unpack_args(const void* const* ptrs, const float* f, const int* iv,
                    Args& a) {
  const float* const* p = (const float* const*)ptrs;
  a.pos = p[0]; a.quat = p[1]; a.w = p[2]; a.v = p[3]; a.q = p[4];
  a.qd = p[5]; a.prev = p[6]; a.act = p[7]; a.qd_ref = p[8];
  a.tau_ff = p[9]; a.ph = (float*)p[10];
  a.bms = p[11]; a.bis = p[12]; a.lms = p[13]; a.lis = p[14]; a.kp = p[15];
  a.kd = p[16]; a.ff = p[17]; a.lat = p[18]; a.grav = p[19]; a.fext = p[20];
  float* const* o = (float* const*)(ptrs + 21);
  a.o_pos = o[0]; a.o_quat = o[1]; a.o_w = o[2]; a.o_v = o[3]; a.o_q = o[4];
  a.o_qd = o[5]; a.o_tau = o[6]; a.o_foot = o[7]; a.o_fcon = o[8];
  a.o_kcon = o[9]; a.o_bcon = o[10]; a.o_stack = o[11];
  a.dt = f[0]; a.k = f[1]; a.d = f[2]; a.fcoef = f[3]; a.vs2 = f[4];
  a.cap_foot = f[5]; a.cap_knee = f[6]; a.cap_base = f[7]; a.k_knee = f[8];
  a.d_knee = f[9]; a.max_bv = f[10]; a.max_jv = f[11]; a.pd_w0 = f[12];
  a.pd_w1 = f[13];
  a.terrain = Terrain{f[14], f[15], f[16], f[17], f[18], f[19], f[20], f[21]};
  a.B = iv[0]; a.n = iv[1]; a.S = iv[2]; a.torque = iv[3]; a.interp = iv[4];
  a.on_rack = iv[5]; a.P = iv[6]; a.i0 = iv[7]; a.i1 = iv[8];
}

}  // namespace prt

// Launch geometry: threads per env, threads per block, blocks and static
// shared memory bytes of a launch over B envs (ops/physics_step.launch_plan
// reads it from the built library).
extern "C" void prt_launch_plan(int B, int* out) {
  out[0] = prt::LEGS;
  out[1] = prt::LEGS * prt::ENVS_PER_BLOCK;
  out[2] = (B + prt::ENVS_PER_BLOCK - 1) / prt::ENVS_PER_BLOCK;
  out[3] = (int)(2 * prt::LEGS * prt::XCH * prt::ENVS_PER_BLOCK *
                 sizeof(float));
}

#ifdef __CUDACC__

template <int MODE>
__global__ void __launch_bounds__(prt::LEGS * prt::ENVS_PER_BLOCK)
    control_step_kernel(prt::Args a) {
  using namespace prt;
  // the legs' x of even and odd substeps: a warp can write the next
  // substep's while another still reads this one's
  __shared__ float xch[2][LEGS][XCH][ENVS_PER_BLOCK];
  const int l = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * ENVS_PER_BLOCK + lane;
  const bool live = b < a.B;
  const int bc = live ? b : a.B - 1;  // a tail lane shadows env B - 1
  Base s;
  Leg L;
  load_base(a, bc, s);
  load_leg(a, bc, l, L);
  float bcon = 0.0f;
  int ph_base = 0;  // physical slot of the newest pd-ring row
#pragma unroll 1
  for (int it = 0; it < a.n; ++it) {
    leg_motor(a, bc, l, it, ph_base, live, L);
    float Rb[3][3], wW[3], vW[3];
    base_frame(s, Rb, wW, vW);
    LegContact C;
    LegP3 P;
    float x[XCH];
    leg_pass12<MODE>(a, bc, l, s, Rb, wW, vW, L, C, P, x);
    if (live && it == a.n - 1) store_contact(a, b, l, C);
    float (*buf)[XCH][ENVS_PER_BLOCK] = xch[it & 1];
#pragma unroll
    for (int k = 0; k < XCH; ++k) buf[l][k][lane] = x[k];
    __syncthreads();
    float a0[6], qdd[3];
    bcon = base_solve<MODE>(a, bc, s, Rb, vW, &buf[0][0][lane],
                            XCH * ENVS_PER_BLOCK, ENVS_PER_BLOCK, a0);
    leg_pass3(l, P, a0, qdd);
    integrate_leg(a, qdd, L);
    integrate_base(a, Rb, a0, s);
    if (a.P > 0) ph_base = (ph_base + a.P - 1) % a.P;
    if (live) store_substep(a, b, l, it, ph_base, L, s, l == 0);
  }
  if (live) {
    store_leg(a, b, l, L);
    if (l == 0) store_base(a, b, s, bcon);
  }
}

template <int MODE>
static void launch(const prt::Args& a, int blocks, int threads,
                   cudaStream_t stream) {
  control_step_kernel<MODE><<<blocks, threads, 0, stream>>>(a);
}

// C entry point (bound with ctypes by ops/physics_step.py). `ptrs` holds 33
// device pointers (11 inputs incl. the pd ring, 10 BDynParams fields, 12
// outputs), `f` 22 floats and `iv` 10 ints in the orders of
// physics_step.FLOAT_NAMES / INT_NAMES. Returns cudaGetLastError() after the
// launch (or cudaErrorInvalidValue for bad counts or mode).
extern "C" int prt_control_step(const void* const* ptrs, int n_ptrs,
                                const float* f, int n_f, const int* iv,
                                int n_i, void* stream) {
  if (n_ptrs != 33 || n_f != 22 || n_i != 10) return (int)cudaErrorInvalidValue;
  prt::Args a;
  prt::unpack_args(ptrs, f, iv, a);
  if (a.B <= 0) return (int)cudaSuccess;
  if (iv[9] < 0 || iv[9] >= prt::N_TERRAIN) return (int)cudaErrorInvalidValue;
  // one instance per terrain mode, in the order of the enum
  using Launch = void (*)(const prt::Args&, int, int, cudaStream_t);
  static const Launch by_mode[prt::N_TERRAIN] = {
      launch<0>, launch<1>, launch<2>, launch<3>, launch<4>,
      launch<5>, launch<6>, launch<7>, launch<8>};
  int plan[4];
  prt_launch_plan(a.B, plan);
  by_mode[iv[9]](a, plan[2], plan[1], (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

extern "C" const char* prt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

#else  // a host compiler: the same stages, env by env

template <int MODE>
static void control_step_host_env(const prt::Args& a, int b) {
  using namespace prt;
  Base s;
  Leg L[LEGS];
  load_base(a, b, s);
  for (int l = 0; l < LEGS; ++l) load_leg(a, b, l, L[l]);
  float bcon = 0.0f;
  int ph_base = 0;
  for (int it = 0; it < a.n; ++it) {
    for (int l = 0; l < LEGS; ++l)
      leg_motor(a, b, l, it, ph_base, true, L[l]);
    float Rb[3][3], wW[3], vW[3];
    base_frame(s, Rb, wW, vW);
    LegP3 P[LEGS];
    float x[LEGS][XCH];
    for (int l = 0; l < LEGS; ++l) {
      LegContact C;
      leg_pass12<MODE>(a, b, l, s, Rb, wW, vW, L[l], C, P[l], x[l]);
      if (it == a.n - 1) store_contact(a, b, l, C);
    }
    float a0[6];
    bcon = base_solve<MODE>(a, b, s, Rb, vW, &x[0][0], XCH, 1, a0);
    for (int l = 0; l < LEGS; ++l) {
      float qdd[3];
      leg_pass3(l, P[l], a0, qdd);
      integrate_leg(a, qdd, L[l]);
    }
    integrate_base(a, Rb, a0, s);
    if (a.P > 0) ph_base = (ph_base + a.P - 1) % a.P;
    for (int l = 0; l < LEGS; ++l)
      store_substep(a, b, l, it, ph_base, L[l], s, l == 0);
  }
  for (int l = 0; l < LEGS; ++l) store_leg(a, b, l, L[l]);
  store_base(a, b, s, bcon);
}

template <int MODE>
static void control_step_host(const prt::Args& a) {
  for (int b = 0; b < a.B; ++b) control_step_host_env<MODE>(a, b);
}

// The host entry point, with the kernel's arguments on host pointers.
// Returns 0, or -1 for bad counts or mode.
extern "C" int prt_control_step_host(const void* const* ptrs, int n_ptrs,
                                     const float* f, int n_f, const int* iv,
                                     int n_i) {
  if (n_ptrs != 33 || n_f != 22 || n_i != 10) return -1;
  prt::Args a;
  prt::unpack_args(ptrs, f, iv, a);
  if (iv[9] < 0 || iv[9] >= prt::N_TERRAIN) return -1;
  using Step = void (*)(const prt::Args&);
  static const Step by_mode[prt::N_TERRAIN] = {
      control_step_host<0>, control_step_host<1>, control_step_host<2>,
      control_step_host<3>, control_step_host<4>, control_step_host<5>,
      control_step_host<6>, control_step_host<7>, control_step_host<8>};
  by_mode[iv[9]](a);
  return 0;
}

#endif  // __CUDACC__

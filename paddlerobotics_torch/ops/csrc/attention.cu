// Masked multi-head flash attention on the tensor cores, for sm_90a.
//
// Replaces the TPU kernel paddlerobotics_tpu/ops/pallas/attention.py,
// flash_attention (body _attn_kernel). For every (batch, head) and query
// row t it computes, over the source positions s:
//
//   score = (q_t . k_s) * hd^-0.5
//   score = score * m[t,s] - 1e10 * (1 - m[t,s])        (m a float mask)
//   online softmax over source tiles, with p = exp(score - m_cur) * m[t,s]
//   out_t = acc / max(l, 1e-20)
//
// so a row whose keys are all masked gives exact zeros, never NaN: the
// sentinel is the finite -1e10 (with -inf a fully masked tile would give
// exp(-inf - -inf)). Its plain version is ops/attention.reference_attention
// (the materialized einsum / softmax path of hri/transformer.py).
//
// Layout. q (B,H,T,hd), k and v (B,H,S,hd), the mask (B,T,S) and the
// output (B,H,T,hd), all float32, each given by element strides of its
// first three dimensions (the last is contiguous), so the attention
// module's head-split views of the fused QKV projection and the output's
// (B,T,H,hd) layout need no copies. The mask is read at batch index bh / H,
// never repeated per head. q, k and v are copied with 16-byte cp.async, so
// their pointers and strides are multiples of 16 bytes (the wrapper checks
// it). hd is any multiple of 8 up to 128: it runs on the instance of the
// next width up (16, 32, 64, 128) with the columns past hd zero-filled in
// shared memory and never written out.
//
// Products. Both Q.K^T and P.V run on the tensor cores, as
// mma.sync.m16n8k8 TF32 with fp32 accumulation, in three passes so that the
// result keeps float32 accuracy: each operand x is split into
// hi = rna(x) and lo = rna(x - hi), rna the rounding of cvt.rna.tf32.f32
// (raw fp32 bits fed to a TF32 mma would be truncated), and a.b is taken as
// a_hi.b_lo + a_lo.b_hi + a_hi.b_hi. One pass is ~1e-3 off, 50x the port's
// tolerance; the dropped a_lo.b_lo is ~2^-22 relative. The rounding is done
// on the bits (tf32_rna below), which takes fewer instructions than cvt,
// and the splits of K, V and P sit in the inner loop beside every mma. Each pass
// runs over all n-tiles of a k-step, so that a warp, which issues in order,
// never waits on the product it just issued.
//
// Tiling. A warp owns 16 query rows of one (b, h); Q's A-fragments stay
// in registers across the key loop. Key tiles of K and V are staged in
// shared memory with 16-byte cp.async, double-buffered, so the next tile's
// copy is in flight while this one is multiplied. Keys past S and columns
// past hd are zero-filled (cp.async with src-size 0) and keys past S count
// as masked. Q.K^T contracts over hd, so each k-step may take its 8 columns
// in the order (0, 2, 4, 6, 1, 3, 5, 7): a thread's A and B fragments then
// hold two adjacent columns, one 8-byte read each. P.V takes the 8 keys of
// each k-step in that order too: the score accumulators (c0, c2, c1, c3)
// of m16n8k8, not laid out as its A operand, then are exactly the A
// fragment of P, so P never moves between threads, and the V fragment
// reads keys 2*tig and 2*tig + 1. Rows are padded (Q and K to HD + 8, V to
// HD + 4 floats) so that every fragment read hits distinct banks. The mask
// is read from global memory in the accumulator layout with 4-byte loads
// (a contiguous ragged mask is not 16-byte aligned).
//
// Grid. Blocks of 4 warps, in one of two shapes chosen per call from the
// number of blocks against the SM count:
//  - wide: 4 warps on 4 query tiles (64 rows) share each K/V tile of 32
//    keys, so K and V are read once per 64 rows;
//  - split, when the wide shape would not fill the SMs (the serving call,
//    B*H = 8, T = 200, would be 32 blocks): 4 warps on one 16-row tile each
//    take 32 keys (16 at hd=128) of every 128-key chunk, and merge their
//    (max, sum, acc) partials in shared memory at the end. A partition
//    without a live key (max -1e10, sum 0, acc 0) adds exact zeros. The
//    serving call is 104 blocks, each warp walking at most 64 of the 200
//    keys.
//
// Bound on an H100 SXM (3.35 TB/s HBM3, 495 TFLOP/s dense TF32): the bytes
// of q, k, v, the mask and the output once each, and 3 x 4*B*H*T*S*hd
// tensor-core operations. Serving (B=1, H=8, T=S=200, hd=64): 1.80 MB ->
// 0.54 us, 3 x 81.9 MFLOP -> 0.50 us, so bytes; 64 windows (B=64): 115 MB
// -> 34.4 us, 15.7 GFLOP -> 31.8 us, bytes. The kernel stays far from it:
// besides its three mma per product it issues the splits, the fragment
// reads and the softmax, and with 12 warps per SM it cannot hide their
// latency. Left for a wgmma/TMA version: wgmma's 64-row tile wastes 56 of
// 256 rows at T=200 where 16-row mma.sync tiles waste 8 of 208, TF32 wgmma
// needs V K-major (transposed) in shared memory, and TMA would free the
// threads that issue cp.async.

#include <cuda_runtime.h>

namespace prt_attn {
namespace {  // internal linkage: no clash with another build of this file

constexpr int NWARPS = 4;
constexpr int NTHREADS = 32 * NWARPS;
constexpr float NEG = -1e10f;

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* mask;
  float* out;
  int H, T, S, hd;
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long m_sb, m_st;
  long long o_sb, o_sh, o_st;
  float scale;
};

// Shared rows: Q and K padded to HD + 8 floats (their fragments are read
// as float2, conflict-free when the row stride is 8 mod 32 floats), V to
// HD + 4 (its fragments are read as floats, conflict-free at 4 mod 32).
__host__ __device__ constexpr int ld_k(int HD) { return HD + 8; }
__host__ __device__ constexpr int ld_v(int HD) { return HD + 4; }
// keys per warp and stage: wide blocks and split blocks (shared memory
// bounds the split hd=128 instance to half)
constexpr int WIDE_BN = 32;
constexpr int split_bn(int HD) { return HD == 128 ? 16 : 32; }
// floats of one stage: WK * BN keys of K and V
__host__ __device__ constexpr int stage_floats(int HD, int WK, int BN) {
  return WK * BN * (ld_k(HD) + ld_v(HD));
}
// dynamic shared memory: stage 0, then stage 1, which first holds the Q
// tile of 16 * WQ rows
constexpr int smem_bytes(int HD, int WQ, int WK, int BN) {
  return (stage_floats(HD, WK, BN) +
          (stage_floats(HD, WK, BN) > 16 * WQ * ld_k(HD)
               ? stage_floats(HD, WK, BN) : 16 * WQ * ld_k(HD))) *
         (int)sizeof(float);
}

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero:
// the rounding of cvt.rna.tf32.f32, bit for bit on every input but a NaN
// whose payload sits in the low 13 bits, in two integer operations (cvt
// screens NaN and infinity first).
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo with hi, lo in TF32. lo is passed with the rounding
// increment added and its low 13 bits left in place: the tensor core
// ignores them, so the mma sees lo rounded to nearest, ties away.
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float* c, const unsigned* a,
                                         const unsigned* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[n] += a.b[n] for N n-tiles at float32 accuracy: a_hi.b_lo + a_lo.b_hi
// + a_hi.b_hi. Each pass runs over all n-tiles, so the products on one
// accumulator are N instructions apart: a warp issues in order, and back to
// back each would wait out the tensor core's latency.
template <int N>
__device__ __forceinline__ void mma3(float (&c)[N][4], const unsigned* a_hi,
                                     const unsigned* a_lo,
                                     const unsigned (&b_hi)[N][2],
                                     const unsigned (&b_lo)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], a_hi, b_lo[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], a_lo, b_hi[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], a_hi, b_hi[n]);
}

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

// Rows [r0, r0 + ROWS) of an (n, hd) matrix with row stride ld into shared
// rows of LD floats; rows past n and columns past hd are zero-filled.
template <int ROWS, int HD, int LD>
__device__ __forceinline__ void load_tile(float* s, const float* g,
                                          long long ld, int r0, int n,
                                          int hd) {
  constexpr unsigned CPR = HD / 4;       // 16-byte chunks per row
#pragma unroll
  for (unsigned i = threadIdx.x; i < ROWS * CPR; i += NTHREADS) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = r0 + r < n && 4 * c < hd;
    cp_async16(s + r * LD + 4 * c, ok ? g + (r0 + r) * ld + 4 * c : g, ok);
  }
}

// Split keys: merge the WK partials of a 16-row tile through shared memory
// (free once the key loop is done) and write the tile.
template <int HD, int WK>
__device__ __forceinline__ void merge(const Args& a, float* smem,
                                      const float (&o)[HD / 8][4],
                                      const float (&m_run)[2],
                                      const float (&l_run)[2],
                                      long long o_base, int row0, int wk) {
  constexpr int LD = ld_v(HD);
  constexpr int KD = HD / 8;
  const int gid = threadIdx.x % 32 / 4, tig = threadIdx.x % 4;
  float* s_m = smem;                     // [WK][16]
  float* s_l = s_m + WK * 16;            // [WK][16]
  float* s_o = s_l + WK * 16;            // [WK][16][LD]
  if (tig == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      s_m[wk * 16 + gid + 8 * r] = m_run[r];
      s_l[wk * 16 + gid + 8 * r] = l_run[r];
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = gid + 8 * r;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < WK; ++w) M = fmaxf(M, s_m[w * 16 + rr]);
    const float f = expf(m_run[r] - M);
    float* so = s_o + (wk * 16 + rr) * LD + 2 * tig;
#pragma unroll
    for (int n = 0; n < KD; ++n) {
      so[8 * n] = o[n][2 * r] * f;
      so[8 * n + 1] = o[n][2 * r + 1] * f;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 16 * HD; i += NTHREADS) {
    const int rr = i / HD, col = i % HD, t = row0 + rr;
    if (t >= a.T || col >= a.hd) continue;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < WK; ++w) M = fmaxf(M, s_m[w * 16 + rr]);
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < WK; ++w) {
      l += s_l[w * 16 + rr] * expf(s_m[w * 16 + rr] - M);
      acc += s_o[(w * 16 + rr) * LD + col];
    }
    a.out[o_base + t * a.o_st + col] = acc / fmaxf(l, 1e-20f);
  }
}

// WQ query tiles of 16 rows times WK key partitions of BN keys per stage.
template <int HD, int WQ, int WK, int BN>
__global__ void __launch_bounds__(NTHREADS) attn_kernel(Args a) {
  static_assert(WQ * WK == NWARPS, "4 warps per block");
  constexpr int LDK = ld_k(HD), LDV = ld_v(HD);
  constexpr int CH = WK * BN;            // keys per stage
  constexpr int STAGE = stage_floats(HD, WK, BN);  // K, then V
  constexpr int KD = HD / 8;             // k-steps over hd; n-tiles of P.V
  constexpr int NT = BN / 8;             // n-tiles of Q.K^T; k-steps of P.V
  static_assert(2 * WK * 16 + WK * 16 * LDV <= 2 * STAGE, "merge fits");
  extern __shared__ __align__(16) float smem[];

  const int n_qt = (a.T + 16 * WQ - 1) / (16 * WQ);
  const int bh = blockIdx.x / n_qt;
  const int t0 = (blockIdx.x % n_qt) * 16 * WQ;
  const int b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wq = warp % WQ, wk = warp / WQ;
  const int row0 = t0 + 16 * wq;         // the warp's first query row
  const bool live = row0 < a.T;

  const float* qb = a.q + b * a.q_sb + h * a.q_sh;
  const float* kb = a.k + b * a.k_sb + h * a.k_sh;
  const float* vb = a.v + b * a.v_sb + h * a.v_sh;
  const int n_st = (a.S + CH - 1) / CH;

  // the Q tile into stage 1's space, stage 0's K and V behind it
  load_tile<16 * WQ, HD, LDK>(smem + STAGE, qb, a.q_st, t0, a.T, a.hd);
  cp_commit();
  if (n_st > 0) {
    load_tile<CH, HD, LDK>(smem, kb, a.k_ss, 0, a.S, a.hd);
    load_tile<CH, HD, LDV>(smem + CH * LDK, vb, a.v_ss, 0, a.S, a.hd);
  }
  cp_commit();
  cp_wait<1>();
  __syncthreads();

  // Q.K^T contracts over hd, so each k-step takes its 8 columns in the
  // order (0, 2, 4, 6, 1, 3, 5, 7): a thread's A fragment a0 (row gid),
  // a1 (row gid + 8), a2, a3 (the same rows) then holds columns
  // 8 kk + 2 tig and 8 kk + 2 tig + 1, adjacent, as does its B fragment.
  unsigned qh[KD][4], ql[KD][4];
  {
    const float* sq = smem + STAGE + (16 * wq + gid) * LDK + 2 * tig;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const float2 r0 = *reinterpret_cast<const float2*>(sq + 8 * kk);
      const float2 r8 =
          *reinterpret_cast<const float2*>(sq + 8 * LDK + 8 * kk);
      split(r0.x, qh[kk][0], ql[kk][0]);
      split(r8.x, qh[kk][1], ql[kk][1]);
      split(r0.y, qh[kk][2], ql[kk][2]);
      split(r8.y, qh[kk][3], ql[kk][3]);
    }
  }
  __syncthreads();                       // stage 1's space is free

  // the thread's two rows: gid and gid + 8 of the warp's tile
  bool row_ok[2];
  const float* mrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + gid + 8 * r;
    row_ok[r] = t < a.T;
    mrow[r] = a.mask + b * a.m_sb + (row_ok[r] ? t : 0) * a.m_st;
  }
  float o[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};

  for (int it = 0; it < n_st; ++it) {
    if (it + 1 < n_st) {
      float* nb = smem + ((it + 1) & 1) * STAGE;
      const int s1 = (it + 1) * CH;
      load_tile<CH, HD, LDK>(nb, kb, a.k_ss, s1, a.S, a.hd);
      load_tile<CH, HD, LDV>(nb + CH * LDK, vb, a.v_ss, s1, a.S, a.hd);
    }
    cp_commit();
    cp_wait<1>();                        // this stage has landed
    __syncthreads();
    const int k0 = it * CH + wk * BN;    // the warp's first key
    if (live && k0 < a.S) {
      const float* sk = smem + (it & 1) * STAGE + wk * BN * LDK;
      const float* sv = smem + (it & 1) * STAGE + CH * LDK + wk * BN * LDV;
      // mask in the accumulator layout: element e of n-tile nt is row
      // gid + 8 (e / 2), key k0 + 8 nt + 2 tig + e % 2
      float mk[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * nt + 2 * tig + (e & 1);
          mk[nt][e] = (row_ok[e >> 1] && col < a.S)
                          ? __ldg(mrow[e >> 1] + col) : 0.f;
        }
      // scores; keys past S are zeros and masked
      float sc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        unsigned kh[NT][2], kl[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float2 kv = *reinterpret_cast<const float2*>(
              sk + (8 * nt + gid) * LDK + 8 * kk + 2 * tig);
          split(kv.x, kh[nt][0], kl[nt][0]);
          split(kv.y, kh[nt][1], kl[nt][1]);
        }
        mma3(sc, qh[kk], ql[kk], kh, kl);
      }
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float s = sc[nt][e] * a.scale;
          sc[nt][e] = s * mk[nt][e] + NEG * (1.f - mk[nt][e]);
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
        }
      float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {       // a row lives in one lane quad
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_cur = fmaxf(m_run[r], mx[r]);
        alpha[r] = expf(m_run[r] - m_cur);
        m_run[r] = m_cur;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // re-masked after exp
          const float p = expf(sc[nt][e] - m_run[e >> 1]) * mk[nt][e];
          sc[nt][e] = p;
          psum[e >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
        l_run[r] = l_run[r] * alpha[r] + psum[r];
      }
#pragma unroll
      for (int n = 0; n < KD; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      // P.V takes the keys of k-step j in the order (0,2,4,6,1,3,5,7):
      // the A fragment is then (c0, c2, c1, c3) of the score n-tile j, and
      // the B fragment V[8 j + 2 tig (+ 1)][8 n + gid]
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        unsigned ph[4], pl[4], vh[KD][2], vl[KD][2];
        split(sc[j][0], ph[0], pl[0]);
        split(sc[j][2], ph[1], pl[1]);
        split(sc[j][1], ph[2], pl[2]);
        split(sc[j][3], ph[3], pl[3]);
        const float* vr = sv + (8 * j + 2 * tig) * LDV + gid;
#pragma unroll
        for (int n = 0; n < KD; ++n) {
          split(vr[8 * n], vh[n][0], vl[n][0]);
          split(vr[LDV + 8 * n], vh[n][1], vl[n][1]);
        }
        mma3(o, ph, pl, vh, vl);
      }
    }
    __syncthreads();                     // the stage may be overwritten
  }

  const long long o_base = b * a.o_sb + h * a.o_sh;
  if constexpr (WK == 1) {
    if (!live) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!row_ok[r]) continue;
      float* orow = a.out + o_base + (row0 + gid + 8 * r) * a.o_st;
      const float l = fmaxf(l_run[r], 1e-20f);
#pragma unroll
      for (int n = 0; n < KD; ++n) {
        const int col = 8 * n + 2 * tig;
        if (col < a.hd) {
          orow[col] = o[n][2 * r] / l;
          orow[col + 1] = o[n][2 * r + 1] / l;
        }
      }
    }
  } else {
    merge<HD, WK>(a, smem, o, m_run, l_run, o_base, row0, wk);
  }
}

// The launch of one call: instance, block shape and grid.
struct Plan {
  int HD, WQ, WK, BN;
  long long blocks;
  int smem;
};

cudaError_t sm_count(int* n) {
  static int cache[64] = {0};
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    e = cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return e;
  }
  *n = cache[dev];
  return cudaSuccess;
}

cudaError_t make_plan(long long BH, int T, int hd, Plan* p) {
  if (hd < 8 || hd > 128 || hd % 8) return cudaErrorInvalidValue;
  int n_sm;
  cudaError_t e = sm_count(&n_sm);
  if (e != cudaSuccess) return e;
  p->HD = hd <= 16 ? 16 : hd <= 32 ? 32 : hd <= 64 ? 64 : 128;
  const bool wide = BH * ((T + 63) / 64) >= n_sm;
  p->WQ = wide ? 4 : 1;
  p->WK = wide ? 1 : 4;
  p->BN = wide ? WIDE_BN : split_bn(p->HD);
  p->blocks = BH * ((T + 16 * p->WQ - 1) / (16 * p->WQ));
  p->smem = smem_bytes(p->HD, p->WQ, p->WK, p->BN);
  return p->blocks > 0x7fffffffLL ? cudaErrorInvalidValue : cudaSuccess;
}

template <int HD, int WQ, int WK, int BN>
cudaError_t launch(const Args& a, const Plan& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes(HD, WQ, WK, BN);
  static unsigned long long ready = 0;   // one bit per device
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (!(ready >> dev & 1ull)) {          // above 48 KB: opt in once
    e = cudaFuncSetAttribute(attn_kernel<HD, WQ, WK, BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    ready |= 1ull << dev;
  }
  attn_kernel<HD, WQ, WK, BN>
      <<<(unsigned)p.blocks, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const Args& a, const Plan& p, cudaStream_t s) {
  return p.WQ == 4 ? launch<HD, 4, 1, WIDE_BN>(a, p, s)
                   : launch<HD, 1, 4, split_bn(HD)>(a, p, s);
}

cudaError_t run(const Args& a, const Plan& p, cudaStream_t s) {
  switch (p.HD) {
    case 16: return launch_hd<16>(a, p, s);
    case 32: return launch_hd<32>(a, p, s);
    case 64: return launch_hd<64>(a, p, s);
    case 128: return launch_hd<128>(a, p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace prt_attn

// ptrs: q, k, v, mask, out. iv: B, H, T, S, hd, then the element strides
// q (b, h, t), k (b, h, s), v (b, h, s), mask (b, t), out (b, h, t).
extern "C" int prt_flash_attention(const void* const* ptrs, const long long* iv,
                                   int n_i, float scale, void* stream) {
  if (n_i != 19) return (int)cudaErrorInvalidValue;
  prt_attn::Args a;
  a.q = (const float*)ptrs[0];
  a.k = (const float*)ptrs[1];
  a.v = (const float*)ptrs[2];
  a.mask = (const float*)ptrs[3];
  a.out = (float*)ptrs[4];
  const long long B = iv[0], H = iv[1];
  if (H <= 0 || iv[2] > 0x7fffffffLL || iv[3] > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  a.H = (int)H;
  a.T = (int)iv[2];
  a.S = (int)iv[3];
  a.hd = (int)iv[4];
  a.q_sb = iv[5];  a.q_sh = iv[6];  a.q_st = iv[7];
  a.k_sb = iv[8];  a.k_sh = iv[9];  a.k_ss = iv[10];
  a.v_sb = iv[11]; a.v_sh = iv[12]; a.v_ss = iv[13];
  a.m_sb = iv[14]; a.m_st = iv[15];
  a.o_sb = iv[16]; a.o_sh = iv[17]; a.o_st = iv[18];
  a.scale = scale;
  if (B <= 0 || a.T <= 0) return (int)cudaSuccess;
  prt_attn::Plan p;
  cudaError_t e = prt_attn::make_plan(B * H, a.T, a.hd, &p);
  if (e != cudaSuccess) return (int)e;
  return (int)prt_attn::run(a, p, (cudaStream_t)stream);
}

// The launch prt_flash_attention makes for B*H = BH, T query rows and head
// dim hd, into out: blocks, threads per block, dynamic shared memory bytes,
// then the instance's HD, WQ (query tiles per block), WK (key partitions)
// and BN (keys per partition and stage).
extern "C" int prt_attn_plan(long long BH, long long T, long long hd,
                             long long* out) {
  prt_attn::Plan p;
  cudaError_t e = prt_attn::make_plan(BH, (int)T, (int)hd, &p);
  if (e != cudaSuccess) return (int)e;
  const long long vals[7] = {p.blocks, prt_attn::NTHREADS, p.smem,
                             p.HD,     p.WQ,               p.WK, p.BN};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}

extern "C" const char* prt_attn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

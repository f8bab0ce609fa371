// Masked multi-head flash attention, for sm_90a.
//
// Replaces the TPU kernel paddlerobotics_tpu/ops/pallas/attention.py,
// flash_attention (body _attn_kernel). For every (batch, head) and query
// row t it computes, over the source positions s:
//
//   score = (q_t . k_s) * hd^-0.5
//   score = score * m[t,s] - 1e10 * (1 - m[t,s])        (m a float 0/1 mask)
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
// module's head-split views and the output's (B,T,H,hd) layout need no
// copies. The mask is read at batch index bh / H, never repeated per head.
// Ragged T and S are handled by bounds checks: keys past S count as masked,
// rows past T are computed on zeros and not written.
//
// Design. One block of 128 threads per (b*h, 32-row query tile); four
// threads own a query row: each keeps the row's q in registers, scores 8 of
// the 32 keys of a source tile, and accumulates hd/4 of the output dims.
// K and V tiles of 32 rows are staged in shared memory (rows padded to
// hd + 4 floats: 16-byte aligned and free of bank conflicts for the
// column reads); the row's probabilities pass through a shared 32x33 tile.
// Row max and row sum combine the four threads with warp shuffles. Both
// products run on the fp32 CUDA cores. hd is a template parameter: 16, 32
// and 64 (64 is the serving width, 512 / 8 heads); others are refused.
//
// Bound on an H100 SXM (67 TFLOP/s fp32 outside the tensor cores, 3.35 TB/s
// HBM3): 4*B*H*T*S*hd operations for the two products and the bytes of q,
// k, v, the mask and the output once each. Serving (B=1, H=8, T=S=200,
// hd=64): 81.9 MFLOP -> 1.22 us, set by operations; 1.80 MB -> 0.54 us.
// This kernel is the simple right version: it keeps scores out of device
// memory but computes them on CUDA cores, 56 blocks at the serving shape
// on 132 SMs. wgmma, TMA and a tensor-core data type are later work.

#include <cuda_runtime.h>

namespace prt_attn {

constexpr int BT = 32;             // query rows per block
constexpr int BS = 32;             // keys per source tile
constexpr int TPR = 4;             // threads per query row
constexpr int NTHREADS = BT * TPR;
constexpr float NEG = -1e10f;

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* mask;
  float* out;
  int H, T, S;
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long m_sb, m_st;
  long long o_sb, o_sh, o_st;
  float scale;
};

template <int HD>
__global__ void __launch_bounds__(NTHREADS) attn_kernel(Args a) {
  constexpr int LD = HD + 4;
  constexpr int NC = BS / TPR;     // score columns per thread
  constexpr int ND = HD / TPR;     // output dims per thread
  __shared__ __align__(16) float sq[BT][LD];
  __shared__ __align__(16) float sk[BS][LD];
  __shared__ __align__(16) float sv[BS][LD];
  __shared__ float sp[BT][BS + 1];

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int t0 = blockIdx.y * BT;
  const int tid = threadIdx.x;
  const int r = tid / TPR, sub = tid % TPR;
  const int t = t0 + r;
  const bool row_ok = t < a.T;

  const float* qb = a.q + b * a.q_sb + h * a.q_sh;
  const float* kb = a.k + b * a.k_sb + h * a.k_sh;
  const float* vb = a.v + b * a.v_sb + h * a.v_sh;
  const float* mrow = a.mask + b * a.m_sb + (row_ok ? t : 0) * a.m_st;

  for (int i = tid; i < BT * HD; i += NTHREADS) {
    const int rr = i / HD, d = i % HD, tt = t0 + rr;
    sq[rr][d] = tt < a.T ? qb[tt * a.q_st + d] : 0.f;
  }
  __syncthreads();
  float qr[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) qr[d] = sq[r][d];

  float acc[ND];
#pragma unroll
  for (int e = 0; e < ND; ++e) acc[e] = 0.f;
  float m_prev = NEG, l_prev = 0.f;

  for (int s0 = 0; s0 < a.S; s0 += BS) {
    __syncthreads();               // the previous tile's readers are done
    for (int i = tid; i < BS * HD; i += NTHREADS) {
      const int j = i / HD, d = i % HD, ss = s0 + j;
      const bool ok = ss < a.S;
      sk[j][d] = ok ? kb[ss * a.k_ss + d] : 0.f;
      sv[j][d] = ok ? vb[ss * a.v_ss + d] : 0.f;
    }
    __syncthreads();

    float sc[NC], mk[NC];
    float mx = NEG;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = sub + TPR * c, ss = s0 + j;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot += qr[d] * sk[j][d];
      const float m = (row_ok && ss < a.S) ? mrow[ss] : 0.f;
      const float s = dot * a.scale;
      sc[c] = s * m + NEG * (1.f - m);
      mk[c] = m;
      mx = fmaxf(mx, sc[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_cur = fmaxf(m_prev, mx);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float p = expf(sc[c] - m_cur) * mk[c];   // re-masked after exp
      sp[r][sub + TPR * c] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float alpha = expf(m_prev - m_cur);
    l_prev = l_prev * alpha + psum;
    m_prev = m_cur;
    __syncwarp();                  // the row's four threads share sp[r]

#pragma unroll
    for (int e = 0; e < ND; ++e) acc[e] *= alpha;
#pragma unroll 4
    for (int j = 0; j < BS; ++j) {
      const float p = sp[r][j];
#pragma unroll
      for (int e = 0; e < ND; ++e) acc[e] += p * sv[j][sub + TPR * e];
    }
  }

  if (row_ok) {
    float* ob = a.out + b * a.o_sb + h * a.o_sh + t * a.o_st;
    const float l = fmaxf(l_prev, 1e-20f);
#pragma unroll
    for (int e = 0; e < ND; ++e) ob[sub + TPR * e] = acc[e] / l;
  }
}

template <int HD>
cudaError_t launch(const Args& a, int BH, cudaStream_t stream) {
  dim3 grid(BH, (a.T + BT - 1) / BT);
  attn_kernel<HD><<<grid, NTHREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

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
  const long long B = iv[0], H = iv[1], hd = iv[4];
  a.H = (int)H;
  a.T = (int)iv[2];
  a.S = (int)iv[3];
  a.q_sb = iv[5];  a.q_sh = iv[6];  a.q_st = iv[7];
  a.k_sb = iv[8];  a.k_sh = iv[9];  a.k_ss = iv[10];
  a.v_sb = iv[11]; a.v_sh = iv[12]; a.v_ss = iv[13];
  a.m_sb = iv[14]; a.m_st = iv[15];
  a.o_sb = iv[16]; a.o_sh = iv[17]; a.o_st = iv[18];
  a.scale = scale;
  const long long BH = B * H;
  if (BH <= 0 || a.T <= 0) return (int)cudaSuccess;
  if (BH > 0x7fffffffLL || (a.T + prt_attn::BT - 1) / prt_attn::BT > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 16: return (int)prt_attn::launch<16>(a, (int)BH, s);
    case 32: return (int)prt_attn::launch<32>(a, (int)BH, s);
    case 64: return (int)prt_attn::launch<64>(a, (int)BH, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* prt_attn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

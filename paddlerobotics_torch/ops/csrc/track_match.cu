// The Deep-SORT tracker's matching step as one warp, for sm_90a.
//
// No TPU kernel is replaced: the JAX package computes this step as jitted
// XLA, the matching cascade of paddlerobotics_tpu/hri/tracker.py
// (tracker_update, steps 1 and 2) over the exact assignment of
// paddlerobotics_tpu/ops/lap.py (min_cost_match, solve_lap). Eager PyTorch
// on the card would read a scalar back to the host on every iteration of
// the assignment's two data-dependent loops, thousands of synchronisations
// per frame; one launch here runs the whole step. Its plain version is
// ops/lap.track_match_plain.
//
// One launch, one warp:
//  1. the appearance cascade: for age levels 0 .. max_age-1, the rows are
//     the confirmed tracks with time_since_update == 1 + level not yet
//     assigned, the columns the valid detections not yet matched; a level
//     with a row and a column gets one exact min_cost_match on cost1;
//  2. the IoU stage: tentative tracks and confirmed tracks unmatched for
//     exactly one frame, still unassigned, against the detections still
//     unmatched, one min_cost_match on iou_cost;
//  3. assign (T,) = the cascade's match, else the IoU stage's, else -1;
//     matched (D,) = the detections some track took.
// A stage without an eligible row or column is skipped: min_cost_match
// would return -1 for every row there.
//
// min_cost_match clips the (T, D) costs at clip = float32(max_cost + 1e-5)
// (invalid rows and columns, and the padding to the n x n square,
// n = max(T, D) <= 32, take clip), solves the square exactly and keeps a
// row's column where it is a real, valid column with cost <= max_cost.
// The solve is successive shortest augmenting paths with dual potentials
// (solve_lap), copied operation for operation: lane j owns column j (v,
// shortest, path, remaining, row4col) and row j (u, col4row, scanned);
// the padded square sits in shared memory; the Dijkstra argmin is a
// butterfly of shuffles that keeps the lower lane on a tie, as jnp.argmin
// and torch.argmin take the first minimum. Every float operation keeps the
// plain version's order (r = min_val + c[i] - u[i] - v; u += min_val - d;
// v -= min_val - shortest), there is no multiply to fuse, so assignments
// and duals are bit-equal to the plain version on the same inputs.
//
// Bound on an H100 SXM: the inputs are 2*T*D floats of cost, two int rows
// and a byte row, a few KB (about 2 ns at 3.35 TB/s), and the operations
// a few tens of thousands (well under a ns at 67 TFLOP/s). The kernel is
// a dependent chain instead: each Dijkstra scan is a shared-memory read,
// three adds, a compare and a five-step shuffle reduction, each waiting on
// the last, on one warp of one SM. Its time is that chain's latency, a
// few hundred cycles per scan; a wider launch could only run other
// streams' steps beside it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace prt_tm {

constexpr int W = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float BIG = 1e18f;
constexpr int TENTATIVE = 1;
constexpr int CONFIRMED = 2;

struct Args {
  const float* cost1;
  const float* iou_cost;
  const int* status;
  const int* tsu;
  const uint8_t* det_valid;
  int T, D, max_age;
  float max_cos, clip_cos, max_iou, clip_iou;
  int* assign;
  uint8_t* matched;
  int* work;          // optional: += (Dijkstra scans, solves)
};

// First minimum over the warp: (d, j) of the lane with the least d, the
// lower j on a tie. d is never NaN (see solve).
__device__ __forceinline__ void warp_argmin(float& d, int& j) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(FULL, d, off);
    const int oj = __shfl_xor_sync(FULL, j, off);
    if (od < d || (od == d && oj < j)) {
      d = od;
      j = oj;
    }
  }
}

// min_cost_match of lap.py for this warp: returns the lane's row's column
// (-1 for none; lanes >= T return -1) and counts the Dijkstra scans.
__device__ int min_cost_match(const float* __restrict__ cost, int T, int D,
                              bool row_ok, bool col_ok, float max_cost,
                              float clip, float (*sq)[W + 1], int& scans) {
  const int lane = threadIdx.x;
  const int n = T > D ? T : D;
  const unsigned rmask = __ballot_sync(FULL, row_ok);
  const unsigned cmask = __ballot_sync(FULL, col_ok);
  // the gated square, column `lane`: min(cost, clip) where row and column
  // are valid (a NaN cost stays NaN, as jnp.minimum keeps it), else clip
  for (int i = 0; i < n; ++i) {
    float g = clip;
    if (i < T && lane < D && ((rmask >> i) & 1u) && col_ok) {
      const float c = cost[i * D + lane];
      g = (c > clip) ? clip : c;
    }
    if (lane < n) sq[i][lane] = g;
  }
  __syncwarp();

  const float INF = __int_as_float(0x7f800000);
  float u = 0.f, v = 0.f;
  int row4col = -1, col4row = -1;
  for (int cur = 0; cur < n; ++cur) {
    // Dijkstra over the equality graph from row cur
    float shortest = BIG;
    int path = cur;
    bool remaining = true, scanned = false;
    int sink = -1, i = cur;
    float min_val = 0.f;
    while (sink < 0) {
      if (lane == i) scanned = true;
      const float ui = __shfl_sync(FULL, u, i);
      // shortest starts at BIG and takes r only where r < shortest, so it
      // is never NaN, and neither is d
      float d = INF;
      if (lane < n) {
        const float r = min_val + sq[i][lane] - ui - v;
        if (remaining && r < shortest) {
          shortest = r;
          path = i;
        }
        d = remaining ? shortest : BIG;
      }
      int j = lane;
      warp_argmin(d, j);
      min_val = d;
      if (lane == j) remaining = false;
      const int i_next = __shfl_sync(FULL, row4col, j);
      if (i_next < 0) sink = j;
      else i = i_next;
      ++scans;
    }
    // dual updates: scanned rows u += Δ − d[col4row] (cur: d = 0),
    // scanned columns v −= Δ − d
    int cj = col4row < 0 ? 0 : col4row;
    cj = cj > n - 1 ? n - 1 : cj;
    const float sh = __shfl_sync(FULL, shortest, cj);
    const float d_of_row = (lane == cur) ? 0.f : sh;
    if (scanned) u = u + min_val - d_of_row;
    if (!remaining) v = v - (min_val - shortest);
    // augment along the alternating path
    int j = sink;
    while (j >= 0) {
      const int pi = __shfl_sync(FULL, path, j);
      if (lane == j) row4col = pi;
      const int j_next = __shfl_sync(FULL, col4row, pi);
      if (lane == pi) col4row = j;
      j = j_next;
    }
  }
  __syncwarp();
  int out = -1;
  if (lane < T) {
    const int a = col4row < 0 ? 0 : (col4row > D - 1 ? D - 1 : col4row);
    const bool ok = col4row < D && row_ok && ((cmask >> a) & 1u) &&
                    cost[lane * D + a] <= max_cost;
    out = ok ? a : -1;
  }
  return out;
}

__global__ void __launch_bounds__(W) track_match_kernel(Args p) {
  __shared__ float sq[W][W + 1];
  __shared__ int hit[W];
  const int lane = threadIdx.x;
  const int st = lane < p.T ? p.status[lane] : 0;
  const int ts = lane < p.T ? p.tsu[lane] : 0;
  const bool dv = lane < p.D && p.det_valid[lane] != 0;
  const bool confirmed = st == CONFIRMED;
  int assign1 = -1;
  bool det_matched = false;
  int scans = 0, solves = 0;

  // 1) the appearance cascade, freshest tracks first
  for (int level = 0; level < p.max_age; ++level) {
    const bool rows = lane < p.T && confirmed && ts == 1 + level &&
                      assign1 < 0;
    const bool cols = dv && !det_matched;
    if (!(__any_sync(FULL, rows) && __any_sync(FULL, cols))) continue;
    const int a = min_cost_match(p.cost1, p.T, p.D, rows, cols, p.max_cos,
                                 p.clip_cos, sq, scans);
    ++solves;
    if (a >= 0) assign1 = a;
    hit[lane] = 0;
    __syncwarp();
    if (a >= 0) hit[a] = 1;
    __syncwarp();
    det_matched = det_matched || (lane < p.D && hit[lane] != 0);
    __syncwarp();
  }

  // 2) IoU matching: tentative tracks and confirmed ones one frame old
  const bool rows2 = lane < p.T &&
                     (st == TENTATIVE || (confirmed && ts == 1)) &&
                     assign1 < 0;
  const bool cols2 = dv && !det_matched;
  int a2 = -1;
  if (__any_sync(FULL, rows2) && __any_sync(FULL, cols2)) {
    a2 = min_cost_match(p.iou_cost, p.T, p.D, rows2, cols2, p.max_iou,
                        p.clip_iou, sq, scans);
    ++solves;
  }

  // 3) the step's assignment and the detections it took
  const int assign = assign1 >= 0 ? assign1 : a2;
  hit[lane] = 0;
  __syncwarp();
  if (assign >= 0) hit[assign] = 1;
  __syncwarp();
  if (lane < p.T) p.assign[lane] = assign;
  if (lane < p.D) p.matched[lane] = hit[lane] != 0;
  if (lane == 0 && p.work != nullptr) {
    p.work[0] += scans;
    p.work[1] += solves;
  }
}

}  // namespace prt_tm

// One matching step: cost1 and iou_cost (T, D) float32 row-major, status
// and tsu (T,) int32, det_valid (D,) bytes; writes assign (T,) int32 and
// matched (D,) bytes, and adds (scans, solves) to work when it is not
// null. T and D in 1..32. Returns a cudaError_t.
extern "C" int prt_track_match(const void* const* ptrs, int T, int D,
                               int max_age, float max_cos, float clip_cos,
                               float max_iou, float clip_iou, void* stream) {
  if (T < 1 || D < 1 || T > prt_tm::W || D > prt_tm::W || max_age < 0)
    return (int)cudaErrorInvalidValue;
  prt_tm::Args a;
  a.cost1 = (const float*)ptrs[0];
  a.iou_cost = (const float*)ptrs[1];
  a.status = (const int*)ptrs[2];
  a.tsu = (const int*)ptrs[3];
  a.det_valid = (const uint8_t*)ptrs[4];
  a.assign = (int*)ptrs[5];
  a.matched = (uint8_t*)ptrs[6];
  a.work = (int*)ptrs[7];
  a.T = T;
  a.D = D;
  a.max_age = max_age;
  a.max_cos = max_cos;
  a.clip_cos = clip_cos;
  a.max_iou = max_iou;
  a.clip_iou = clip_iou;
  prt_tm::track_match_kernel<<<1, prt_tm::W, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* prt_tm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

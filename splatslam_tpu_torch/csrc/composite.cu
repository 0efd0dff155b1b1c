// 3DGS tile compositor, forward (B1) and backward (B2), for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   B1 composite_fwd  <- splatslam_tpu/ops/raster_pallas.py composite_fwd_pallas
//                        (_fwd_kernel, _chunk_eval, _prefix_prod, _pix_coords)
//   B2 composite_bwd  <- splatslam_tpu/ops/raster_pallas.py composite_bwd_pallas
//                        (_bwd_kernel, _bwd_tile, _prefix_sum)
// Plain PyTorch versions with the same arithmetic: composite_fwd_torch /
// composite_bwd_torch in splatslam_tpu_torch/ops/rasterizer.py.
//
// Semantics kept from the JAX package:
//   * alpha = min(0.99, opacity * exp(power)); a contributor is live iff
//     power <= 0, alpha >= 1/255 and k < min(count, K);
//   * the weight is zeroed once T_before*(1-alpha) < 1e-4, but T keeps
//     multiplying by (1-alpha) (no 3DGS-style frozen "done" pixels);
//   * the gradient is zero through the 0.99 clamp; padding adds nothing.
//
// What bounds these kernels on an H100, and what the design does about it.
// Counted in FP32 operations against the card's 67 TFLOP/s, both kernels are
// operation-bound on a dense input (their bytes are several times
// below). The first design for this
// card (one thread per pixel, 256 threads per tile) never came near that
// bound: it stood at the SM's load/store-and-shuffle pipe, which issues one
// warp-wide shared-memory load, store or shuffle per clock. Per contributor
// and warp it spent 11 scalar shared loads, and in B2 a five-step shuffle
// butterfly for each of the 10 gradient fields plus 10 shared stores: ~71
// such issues per 32 (pixel, contributor) pairs, which alone is the time
// it measured. This design spends 2-4 (B2) and 1-3 (B1) per 32 pairs:
//   * P pixels per thread (lane l, slot j -> pixel l + 32 j of the warp's
//     rows, so global reads and writes of the per-pixel rows stay
//     coalesced): a warp composites 2 P rows of a tile, on its own down to
//     its staging, cull and atomics, so there are no cross-warp partial sums
//     and no block-wide barriers; a block is WARPS independent warps. A
//     staged contributor is read once, as three 16-byte broadcast loads,
//     for 32 P pairs. B2 runs one warp per tile (P = 8) on a full keyframe
//     window and two (P = 4) on small grids (one camera is 800 tiles, too
//     few warps for 132 SMs); B1, with less state per pixel, was faster
//     with two warps per tile (P = 4) and four (P = 2) on small grids.
//   * B2 sums its 10 gradient fields over the thread's own P pixels in
//     registers, then over the 32 lanes with a transposing butterfly
//     (reduce10: each step halves the values a lane still carries, 12
//     shuffles instead of 50); the lane left holding field f issues the
//     atomicAdd: 10 neighbouring addresses in one instruction, so the
//     gradient needs no padded rows for vector atomics.
//   * B1 counts n_touched in registers: a hardware warp sum of each
//     thread's hits, kept by lane k for contributor k of the batch and
//     flushed with one atomicAdd per lane and batch. want_touched is a
//     template parameter, so the count is compiled out when not wanted.
//   * staging: lane k of the warp gathers contributor k of the next batch
//     (40-byte packet row, 8-byte aligned) with five 8-byte cp.async copies
//     into the other half of a double buffer while the current batch
//     computes; the ids are loaded one batch further ahead. Rows are staged
//     as 12 floats [10 fields, id, candidate threshold]. Padding (-1) and
//     entries beyond min(count, K) are staged as zero rows. TMA does not
//     fit here: it copies dense boxes of a tensor map, not an index gather
//     of 40-byte rows.
// With that pipe out of the way the kernels are bound by instruction issue
// on work that the data decides, so the rest of the design skips work, and
// every skipped term is an exact zero of the plain version:
//   * per contributor (Stager::acquire, one lane each): the staging lane
//     computes the candidate threshold log(1/(255 opacity)) - 1e-3 and
//     whether the ellipse power >= threshold reaches the tile at all
//     (reaches_tile: the least of the quadratic form over the tile's
//     rectangle, with a margin for its own rounding). Binning lists a
//     Gaussian by its bounding square, so a good share of the listed
//     contributors reach no pixel of their tile; the loop walks only the
//     bits of the `keep` ballot. Zero rows (padding) are never kept, so the
//     loop needs no validity flag.
//   * per pixel: exp and everything after it run only where power >=
//     threshold (the margin covers the rounding of logf and expf; a
//     candidate is then gated by the exact test alpha >= 1/255, power <= 0).
//     A contributor with no candidate in the tile costs the power
//     evaluation and one vote. Within a taken pixel slot only part of
//     the lanes are live: that divergence and the unfused arithmetic are
//     what keeps the kernels at several times their FP32 bound (which
//     charges a dead pair its evaluation and one comparison).
// The code is compiled with -fmad=false so that power, alpha, T and the
// colour sums round as in the plain version: n_touched is compared exactly
// and colour/depth to 1e-5, so the live test must not move by an ulp (with
// -fmad=true the image moves by more than 1e-3). B2 fuses by hand (fmaf)
// only its gradient sums, which are held to rtol 1e-3; s and the prefix sum
// round as in the plain version because their difference s_tot - pre
// cancels. Its one division has a denominator in [0.01, 1], so it is a
// reciprocal estimate and a Newton step instead of the general IEEE
// routine. The tensor cores are not used.
//
// The forward stops a tile once all 256 pixels have T < 1e-4 (a vote per
// batch), which bounds the alpha difference to the plain version by 1e-4, as
// the TPU kernel's saturation skip did; color, depth and n_touched are
// unaffected (every later weight is zero). The backward walks all
// min(count, K) contributors.
//
// Cross-tile reduction: tiles run in parallel in no order, so per-Gaussian
// sums (n_touched, packet gradients) go to global memory with atomics.
//
// Compile with -fmad=false and without --use_fast_math (expf, not __expf).

#include <cuda_runtime.h>
#include <cuda_pipeline_primitives.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;   // pixels per tile
constexpr int WARPS = 4;            // tiles per block, one warp each
constexpr int BATCH = 32;           // contributors staged per round
constexpr int NF = 10;              // packet fields
constexpr int RS = 12;              // floats per staged row
constexpr unsigned FULL = 0xffffffffu;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_MIN = 1e-4f;
constexpr float MAX_ALPHA = 0.99f;
constexpr float CAND_MARGIN = 1e-3f;

// q(X, t) = A X^2 + 2 B X t + C t^2 minimised over t in [lo, hi], less a
// bound on its own rounding error (C > 0).
__device__ __forceinline__ float edge_min(float A, float B, float C, float X,
                                          float lo, float hi) {
  const float t = fminf(fmaxf(-B * X / C, lo), hi);
  const float t1 = A * X * X, t2 = C * t * t, t3 = 2.0f * B * X * t;
  return (t1 + t2 + t3) - 2e-5f * (t1 + t2 + fabsf(t3));
}

// Can any pixel centre of the rectangle [tx0, tx0 + 15] x [ty0, ty0 + rows - 1]
// have power >= -L for this packet row? Conservative: true unless the conic is
// positive definite and the least of its quadratic form over the rectangle
// (attained on the border when the mean lies outside) exceeds 2 L.
__device__ __forceinline__ bool reaches_tile(const float* row, float L,
                                             float tx0, float ty0,
                                             int rows) {
  const float a = row[2], b = row[3], c = row[4];
  if (!(a > 0.0f && c > 0.0f && a * c > b * b)) return true;
  const float xl = tx0 - row[0], xh = xl + (TILE - 1);
  const float yl = ty0 - row[1], yh = yl + (float)(rows - 1);
  if (xl <= 0.0f && xh >= 0.0f && yl <= 0.0f && yh >= 0.0f) return true;
  const float q = fminf(
      fminf(edge_min(a, b, c, xl, yl, yh), edge_min(a, b, c, xh, yl, yh)),
      fminf(edge_min(c, b, a, yl, xl, xh), edge_min(c, b, a, yh, xl, xh)));
  return !(0.5f * q > L);
}

// Double-buffered gather of one tile's contributor list by one warp, for the
// `nrows` pixel rows of the tile that the warp composites.
struct Stager {
  float (*rows)[BATCH][RS];   // this warp's two buffers
  const float* pk_cam;        // the camera's packets (N, 10)
  const int* tile_ids;        // the tile's list (K)
  float tx0, ty0;             // the warp's first pixel centre
  int nrows;                  // pixel rows of the tile the warp handles
  int count, lane, id_next;
  unsigned keep;              // bit k: contributor k of the acquired batch
                              // can reach the tile

  __device__ __forceinline__ int load_id(int k) const {
    return k < count ? __ldg(tile_ids + k) : -1;
  }

  __device__ __forceinline__ void issue(int buf, int id) {
    float* row = rows[buf][lane];
    if (id >= 0) {
      const float* src = pk_cam + (size_t)id * NF;
#pragma unroll
      for (int f = 0; f < NF; f += 2)
        __pipeline_memcpy_async(row + f, src + f, 8);
    } else {
#pragma unroll
      for (int f = 0; f < NF; ++f) row[f] = 0.0f;
    }
    row[10] = __int_as_float(id);
    __pipeline_commit();
  }

  // batch 0 in flight, the ids of batch 1 on their way
  __device__ __forceinline__ void start() {
    issue(0, load_id(lane));
    id_next = load_id(BATCH + lane);
  }

  // Batches are acquired in order, each once. Starts batch n + 1, waits for
  // batch n, sets `keep` and returns the batch's rows as float4[BATCH][3]:
  // (mean_x, mean_y, conic a, b), (conic c, r, g, b),
  // (opacity, depth, id bits, candidate threshold).
  __device__ __forceinline__ const float4* acquire(int n, int nbatch) {
    if (n + 1 < nbatch) {
      issue((n + 1) & 1, id_next);
      id_next = load_id((n + 2) * BATCH + lane);
    } else {
      __pipeline_commit();
    }
    __pipeline_wait_prior(1);
    float* row = rows[n & 1][lane];
    const float thr = logf(ALPHA_MIN / row[8]) - CAND_MARGIN;
    row[11] = thr;
    keep = __ballot_sync(
        FULL, thr <= 0.0f && reaches_tile(row, -thr, tx0, ty0, nrows));
    __syncwarp();
    return reinterpret_cast<const float4*>(rows[n & 1]);
  }

  // every lane is done reading batch n
  __device__ __forceinline__ void release() { __syncwarp(); }
};

// What a thread needs of one contributor for its column of P pixels.
template <int P>
struct Eval {
  float dx, cadx, cbdx, pw[P];
  unsigned cand;   // bit j: power >= threshold in pixel slot j
};

template <int P>
__device__ __forceinline__ Eval<P> evaluate(const float4& a, float cc,
                                            float thr, float px, float py0) {
  Eval<P> e;
  e.dx = px - a.x;
  e.cadx = a.z * e.dx;
  e.cbdx = a.w * e.dx;
  const float t1 = e.cadx * e.dx;
  e.cand = 0u;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const float dy = (py0 + (float)(2 * j)) - a.y;
    e.pw[j] = -0.5f * (t1 + cc * dy * dy) - e.cbdx * dy;
    if (e.pw[j] >= thr) e.cand |= 1u << j;
  }
  return e;
}

// x / y for y in [0.01, 1] and finite x: a reciprocal estimate and one Newton
// step on the quotient, within an ulp of the rounded quotient; the general
// division's special cases (denormals, overflow) cannot occur here.
__device__ __forceinline__ float divide(float x, float y) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y));
  const float q = x * r;
  return fmaf(fmaf(-y, q, x), r, q);
}

// Sums each of 10 per-lane values over the warp. Each step sends half of
// what a lane still carries to its partner and keeps the other half
// (10 -> 5 -> 3 -> 2 -> 1 values, odd sizes padded with zero), then one
// plain step: 12 shuffles. Lane l ends with field field_of_lane(l).
__device__ __forceinline__ float reduce10(const float (&v)[NF], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  float w[5], x[3], y[2];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    w[i] = (b4 ? v[i + 5] : v[i])
           + __shfl_xor_sync(FULL, b4 ? v[i] : v[i + 5], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    x[i] = (b3 ? w[i + 3] : w[i])
           + __shfl_xor_sync(FULL, b3 ? w[i] : w[i + 3], 8);
  x[2] = (b3 ? 0.0f : w[2]) + __shfl_xor_sync(FULL, b3 ? w[2] : 0.0f, 8);
  y[0] = (b2 ? x[2] : x[0]) + __shfl_xor_sync(FULL, b2 ? x[0] : x[2], 4);
  y[1] = (b2 ? 0.0f : x[1]) + __shfl_xor_sync(FULL, b2 ? x[1] : 0.0f, 4);
  float z = (b1 ? y[1] : y[0]) + __shfl_xor_sync(FULL, b1 ? y[0] : y[1], 2);
  return z + __shfl_xor_sync(FULL, z, 1);
}

// The field that reduce10 leaves in lane l, or -1 (padding, or the odd lane
// of a pair that holds the same sum).
__device__ __forceinline__ int field_of_lane(int lane) {
  const int b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1;
  const int lo = (lane >> 1) & 3;          // 2 * b2 + b1
  const int r = 3 * b3 + lo;
  return ((lane & 1) || lo >= 3 || r >= 5) ? -1 : 5 * b4 + r;
}

// A warp composites P pixels per thread: 2 P rows of one tile, so a tile is
// 8 / P independent units (own staging, own cull, own atomics). More pixels
// per thread is less work per pixel, but a single camera is only a few
// hundred tiles: then the card is filled by splitting each tile over more
// warps. The caller picks P from the size of the grid
// (raster_cuda.pixels_per_thread, from times measured on the card); B1 is
// built for P = 2 and 4, B2 for P = 4 and 8.
// Registers are capped for 6 blocks (24 warps) per SM.
template <int P, bool TOUCH>
__global__ void __launch_bounds__(WARPS * 32, 6)
composite_fwd_kernel(const float* __restrict__ packets,
                     const int* __restrict__ ids,
                     const int* __restrict__ counts,
                     float* __restrict__ out, int* __restrict__ ntouch,
                     int N, int T, int K, int ntx, int BT) {
  __shared__ __align__(16) float rows[WARPS][2][BATCH][RS];
  constexpr int SUB = NPIX / 32 / P;   // units per tile

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int unit = blockIdx.x * WARPS + warp;
  const int bt = unit / SUB, sub = unit - bt * SUB;
  if (bt >= BT) return;
  const int b = bt / T, t = bt - b * T;
  const int ty = (t / ntx) * TILE + 2 * P * sub;   // the unit's first row
  const float px = (float)((t % ntx) * TILE + (lane & 15));
  const float py0 = (float)(ty + (lane >> 4));
  const int count = min(counts[bt], K);
  const int nbatch = (count + BATCH - 1) / BATCH;
  int* nt_cam = ntouch + (size_t)b * N;

  float tr[P], c0[P], c1[P], c2[P], dep[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    tr[j] = 1.0f;
    c0[j] = c1[j] = c2[j] = dep[j] = 0.0f;
  }

  if (nbatch > 0) {
    Stager st{rows[warp], packets + (size_t)b * N * NF,
              ids + (size_t)bt * K, (float)((t % ntx) * TILE), (float)ty,
              2 * P, count, lane, -1, 0u};
    st.start();
    for (int n = 0; n < nbatch; ++n) {
      bool open = false;
#pragma unroll
      for (int j = 0; j < P; ++j) open |= tr[j] >= T_MIN;
      if (!__any_sync(FULL, open)) break;   // every pixel saturated
      const float4* sp = st.acquire(n, nbatch);
      int mine = 0;   // n_touched of contributor `lane` of this batch
      for (unsigned m = st.keep; m; m &= m - 1) {
        const int k = __ffs(m) - 1;
        const float4 a = sp[3 * k], c = sp[3 * k + 1], d = sp[3 * k + 2];
        const Eval<P> e = evaluate<P>(a, c.x, d.w, px, py0);
        if (!__any_sync(FULL, e.cand != 0u)) continue;
        int hits = 0;
#pragma unroll
        for (int j = 0; j < P; ++j) {
          if (e.cand & (1u << j)) {
            const float alpha = fminf(MAX_ALPHA, d.x * expf(e.pw[j]));
            if (alpha >= ALPHA_MIN && e.pw[j] <= 0.0f) {
              const float test = tr[j] * (1.0f - alpha);
              const float w = test < T_MIN ? 0.0f : alpha * tr[j];
              c0[j] = c0[j] + w * c.y;
              c1[j] = c1[j] + w * c.z;
              c2[j] = c2[j] + w * c.w;
              dep[j] = dep[j] + w * d.y;
              tr[j] = test;
              hits += w > 0.0f;
            }
          }
        }
        if (TOUCH) {
          const int total = __reduce_add_sync(FULL, hits);
          if (lane == k) mine = total;
        }
      }
      if (TOUCH && mine > 0)
        atomicAdd(nt_cam + __float_as_int(st.rows[n & 1][lane][10]), mine);
      st.release();
    }
    __pipeline_wait_prior(0);
  }

  float* o = out + (size_t)bt * 5 * NPIX + 32 * P * sub + lane;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    o[0 * NPIX + 32 * j] = c0[j];
    o[1 * NPIX + 32 * j] = c1[j];
    o[2 * NPIX + 32 * j] = c2[j];
    o[3 * NPIX + 32 * j] = dep[j];
    o[4 * NPIX + 32 * j] = 1.0f - tr[j];
  }
}

// P = 8: 4 blocks (16 warps) per SM, 128 registers, else 143 and 12 warps
template <int P>
__global__ void __launch_bounds__(WARPS * 32, P == 8 ? 4 : 6)
composite_bwd_kernel(const float* __restrict__ packets,
                     const int* __restrict__ ids,
                     const int* __restrict__ counts,
                     const float* __restrict__ gout,
                     const float* __restrict__ fwdout,
                     float* __restrict__ grad, int N, int T, int K, int ntx,
                     int BT) {
  __shared__ __align__(16) float rows[WARPS][2][BATCH][RS];
  constexpr int SUB = NPIX / 32 / P;   // units per tile

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int unit = blockIdx.x * WARPS + warp;
  const int bt = unit / SUB, sub = unit - bt * SUB;
  if (bt >= BT) return;
  const int b = bt / T, t = bt - b * T;
  const int ty = (t / ntx) * TILE + 2 * P * sub;   // the unit's first row
  const float px = (float)((t % ntx) * TILE + (lane & 15));
  const float py0 = (float)(ty + (lane >> 4));
  const int count = min(counts[bt], K);
  const int nbatch = (count + BATCH - 1) / BATCH;
  if (nbatch == 0) return;
  float* g_cam = grad + (size_t)b * N * NF;
  const int field = field_of_lane(lane);

  const float* go = gout + (size_t)bt * 5 * NPIX + 32 * P * sub + lane;
  const float* fo = fwdout + (size_t)bt * 5 * NPIX + 32 * P * sub + lane;
  float tr[P], pre[P], gc0[P], gc1[P], gc2[P], gd[P], G[P], s_tot[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int p = 32 * j;
    gc0[j] = go[p];
    gc1[j] = go[NPIX + p];
    gc2[j] = go[2 * NPIX + p];
    gd[j] = go[3 * NPIX + p];
    // T_final and the total sum_i w_i s_i come from the forward's output
    G[j] = go[4 * NPIX + p] * (1.0f - fo[4 * NPIX + p]);
    s_tot[j] = fo[p] * gc0[j] + fo[NPIX + p] * gc1[j]
               + fo[2 * NPIX + p] * gc2[j] + fo[3 * NPIX + p] * gd[j];
    tr[j] = 1.0f;
    pre[j] = 0.0f;
  }

  Stager st{rows[warp], packets + (size_t)b * N * NF, ids + (size_t)bt * K,
            (float)((t % ntx) * TILE), (float)ty, 2 * P, count, lane, -1, 0u};
  st.start();
  for (int n = 0; n < nbatch; ++n) {
    const float4* sp = st.acquire(n, nbatch);
    for (unsigned m = st.keep; m; m &= m - 1) {
      const int k = __ffs(m) - 1;
      const float4 a = sp[3 * k], c = sp[3 * k + 1], d = sp[3 * k + 2];
      const Eval<P> e = evaluate<P>(a, c.x, d.w, px, py0);
      if (!__any_sync(FULL, e.cand != 0u)) continue;
      const float hdxdx = -0.5f * e.dx * e.dx;
      float r[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) r[f] = 0.0f;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        if (e.cand & (1u << j)) {
          const float ex = expf(e.pw[j]);
          const float araw = d.x * ex;
          const float alpha = fminf(MAX_ALPHA, araw);
          if (alpha >= ALPHA_MIN && e.pw[j] <= 0.0f) {
            const float dy = (py0 + (float)(2 * j)) - a.y;
            const float test = tr[j] * (1.0f - alpha);
            const bool wl = test >= T_MIN;
            const float w = wl ? alpha * tr[j] : 0.0f;
            // s and pre round as in the plain version: s_tot - pre cancels
            const float s = c.y * gc0[j] + c.z * gc1[j] + c.w * gc2[j]
                            + d.y * gd[j];
            pre[j] = pre[j] + w * s;
            const float s_after = s_tot[j] - pre[j];   // later contributors
            const float galpha = (wl ? tr[j] * s : 0.0f)
                                 + divide(G[j] - s_after, 1.0f - alpha);
            const bool unc = araw < MAX_ALPHA;
            const float gpow = unc ? galpha * araw : 0.0f;
            r[0] = fmaf(gpow, fmaf(a.w, dy, e.cadx), r[0]);
            r[1] = fmaf(gpow, fmaf(c.x, dy, e.cbdx), r[1]);
            r[2] = fmaf(gpow, hdxdx, r[2]);
            r[3] = fmaf(gpow, -e.dx * dy, r[3]);
            r[4] = fmaf(gpow, -0.5f * dy * dy, r[4]);
            r[5] = fmaf(w, gc0[j], r[5]);
            r[6] = fmaf(w, gc1[j], r[6]);
            r[7] = fmaf(w, gc2[j], r[7]);
            r[8] = r[8] + (unc ? galpha * ex : 0.0f);
            r[9] = fmaf(w, gd[j], r[9]);
            tr[j] = test;
          }
        }
      }
      const float sum = reduce10(r, lane);
      if (field >= 0 && sum != 0.0f)
        atomicAdd(g_cam + (size_t)__float_as_int(d.z) * NF + field, sum);
    }
    st.release();
  }
  __pipeline_wait_prior(0);
}

template <int P>
void launch_fwd(const float* packets, const int* ids, const int* counts,
                float* out, int* ntouch, int N, int T, int K, int ntx, int BT,
                bool touch, cudaStream_t s) {
  const int blocks = (BT * (NPIX / 32 / P) + WARPS - 1) / WARPS;
  if (touch)
    composite_fwd_kernel<P, true><<<blocks, WARPS * 32, 0, s>>>(
        packets, ids, counts, out, ntouch, N, T, K, ntx, BT);
  else
    composite_fwd_kernel<P, false><<<blocks, WARPS * 32, 0, s>>>(
        packets, ids, counts, out, ntouch, N, T, K, ntx, BT);
}

template <int P>
void launch_bwd(const float* packets, const int* ids, const int* counts,
                const float* gout, const float* fwdout, float* grad, int N,
                int T, int K, int ntx, int BT, cudaStream_t s) {
  const int blocks = (BT * (NPIX / 32 / P) + WARPS - 1) / WARPS;
  composite_bwd_kernel<P><<<blocks, WARPS * 32, 0, s>>>(
      packets, ids, counts, gout, fwdout, grad, N, T, K, ntx, BT);
}

}  // namespace

// `ppt`: pixels per thread, 2 or 4; anything else is refused.
extern "C" int composite_fwd(const float* packets, const int* ids,
                             const int* counts, float* out, int* ntouch,
                             int B, int N, int T, int K, int ntx,
                             int want_touched, int ppt, void* stream) {
  const int BT = B * T;
  cudaStream_t s = (cudaStream_t)stream;
  const bool touch = want_touched != 0;
  if (ppt != 2 && ppt != 4) return (int)cudaErrorInvalidValue;
  if (BT > 0) {
    if (ppt == 2)
      launch_fwd<2>(packets, ids, counts, out, ntouch, N, T, K, ntx, BT,
                    touch, s);
    else
      launch_fwd<4>(packets, ids, counts, out, ntouch, N, T, K, ntx, BT,
                    touch, s);
  }
  return (int)cudaGetLastError();
}

// `ppt`: pixels per thread, 4 or 8; anything else is refused.
extern "C" int composite_bwd(const float* packets, const int* ids,
                             const int* counts, const float* gout,
                             const float* fwdout, float* grad, int B, int N,
                             int T, int K, int ntx, int ppt, void* stream) {
  const int BT = B * T;
  cudaStream_t s = (cudaStream_t)stream;
  if (ppt != 4 && ppt != 8) return (int)cudaErrorInvalidValue;
  if (BT > 0) {
    if (ppt == 4)
      launch_bwd<4>(packets, ids, counts, gout, fwdout, grad, N, T, K, ntx,
                    BT, s);
    else
      launch_bwd<8>(packets, ids, counts, gout, fwdout, grad, N, T, K, ntx,
                    BT, s);
  }
  return (int)cudaGetLastError();
}

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
// Design: one block of 256 threads per (camera, 16x16 tile), one thread per
// pixel. Each tile's depth-sorted contributor list (ids into the camera's
// packets, -1 padding) is walked front to back in batches of BATCH packets
// staged in shared memory (10 f32 fields each, gathered straight from the
// packet array by id). Each thread keeps its own transmittance in a
// register, so the sequential per-contributor product of the TPU kernel's
// prefix scan is exact here.
//
// Semantics kept from the JAX package:
//   * alpha = min(0.99, opacity * exp(power)); a contributor is live iff
//     power <= 0, alpha >= 1/255 and k < min(count, K);
//   * the weight is zeroed once T_before*(1-alpha) < 1e-4, but T keeps
//     multiplying by (1-alpha) (no 3DGS-style frozen "done" pixels);
//   * the gradient is zero through the 0.99 clamp; padding adds nothing.
// The forward stops a block once all 256 pixels have T < 1e-4
// (__syncthreads_count at each batch), which bounds the alpha difference to
// the plain version by 1e-4, as the TPU kernel's saturation skip did; color,
// depth and n_touched are unaffected (every later weight is zero). The
// backward walks all min(count, K) contributors and has no such skip.
//
// Cross-block reduction: blocks run in parallel in no order, so per-Gaussian
// sums (n_touched, packet gradients) go to global memory with atomics. Per
// batch, each warp reduces its 32 pixels with shuffles (gradients) or a
// ballot/popc (n_touched) into shared memory, then one thread per
// (contributor, field) sums the 8 warp partials and issues one atomicAdd.
//
// Bound on an H100 (3.35 TB/s HBM, 67 TFLOP/s non-tensor FP32): each kernel
// reads the tile lists (4*K B per tile), the packets (40 B per Gaussian and
// camera) and writes 5 f32 per pixel (B2: reads 10 f32 per pixel, writes
// 40 B per Gaussian). Per (pixel, contributor) pair B1 does ~25 FP32
// operations and B2 ~60, so at the replica_scale shapes (10 cameras, 800
// tiles, K=256) the operation count, not the bytes, bounds both kernels.
// This simple design keeps every intermediate in registers and shared
// memory and reads each packet once per tile from L2; it does not yet use
// the tensor cores or overlap the staging loads with compute.
//
// Compile with -fmad=false and without --use_fast_math: expf (not __expf)
// and unfused multiply/add keep each operation rounded as in the plain
// PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;   // threads per block, pixels per tile
constexpr int NWARP = NPIX / 32;
constexpr int BATCH = 64;           // contributors staged per round
constexpr int NF = 10;              // packet fields
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_MIN = 1e-4f;
constexpr float MAX_ALPHA = 0.99f;

// Cooperative staging of contributors [base, base + nb) of one tile.
__device__ __forceinline__ void stage(const float* __restrict__ pk_cam,
                                      const int* __restrict__ tile_ids,
                                      int base, int nb,
                                      float (*sp)[NF], int* sid) {
  for (int i = threadIdx.x; i < nb * NF; i += NPIX) {
    const int k = i / NF, f = i - k * NF;
    const int g = tile_ids[base + k];
    sp[k][f] = g >= 0 ? pk_cam[(size_t)g * NF + f] : 0.0f;
  }
  if (threadIdx.x < nb) sid[threadIdx.x] = tile_ids[base + threadIdx.x];
}

__global__ void __launch_bounds__(NPIX)
composite_fwd_kernel(const float* __restrict__ packets,
                     const int* __restrict__ ids,
                     const int* __restrict__ counts,
                     float* __restrict__ out, int* __restrict__ ntouch,
                     int N, int T, int K, int ntx, int want_touched) {
  __shared__ float sp[BATCH][NF];
  __shared__ int sid[BATCH];
  __shared__ int wcount[BATCH][NWARP];

  const int bt = blockIdx.x;
  const int b = bt / T, t = bt - b * T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float px = (float)((t % ntx) * TILE + (tid % TILE));
  const float py = (float)((t / ntx) * TILE + (tid / TILE));
  const int count = min(counts[bt], K);
  const int* tile_ids = ids + (size_t)bt * K;
  const float* pk_cam = packets + (size_t)b * N * NF;
  int* nt_cam = ntouch + (size_t)b * N;

  float tr = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, dep = 0.0f;
  for (int base = 0; base < count; base += BATCH) {
    if (__syncthreads_count(tr >= T_MIN) == 0) break;   // tile saturated
    const int nb = min(BATCH, count - base);
    stage(pk_cam, tile_ids, base, nb, sp, sid);
    __syncthreads();
    for (int k = 0; k < nb; ++k) {
      float w = 0.0f;
      if (sid[k] >= 0) {
        const float dx = px - sp[k][0];
        const float dy = py - sp[k][1];
        const float power = -0.5f * (sp[k][2] * dx * dx + sp[k][4] * dy * dy)
                            - sp[k][3] * dx * dy;
        float alpha = fminf(MAX_ALPHA, sp[k][8] * expf(power));
        if (!(power <= 0.0f && alpha >= ALPHA_MIN)) alpha = 0.0f;
        const float test = tr * (1.0f - alpha);
        w = test < T_MIN ? 0.0f : alpha * tr;
        c0 = c0 + w * sp[k][5];
        c1 = c1 + w * sp[k][6];
        c2 = c2 + w * sp[k][7];
        dep = dep + w * sp[k][9];
        tr = test;
      }
      if (want_touched) {
        const unsigned m = __ballot_sync(0xffffffffu, w > 0.0f);
        if (lane == 0) wcount[k][warp] = __popc(m);
      }
    }
    __syncthreads();
    if (want_touched && tid < nb) {
      int s = 0;
      for (int i = 0; i < NWARP; ++i) s += wcount[tid][i];
      if (s > 0 && sid[tid] >= 0) atomicAdd(&nt_cam[sid[tid]], s);
    }
  }
  float* o = out + (size_t)bt * 5 * NPIX + tid;
  o[0 * NPIX] = c0;
  o[1 * NPIX] = c1;
  o[2 * NPIX] = c2;
  o[3 * NPIX] = dep;
  o[4 * NPIX] = 1.0f - tr;
}

__global__ void __launch_bounds__(NPIX)
composite_bwd_kernel(const float* __restrict__ packets,
                     const int* __restrict__ ids,
                     const int* __restrict__ counts,
                     const float* __restrict__ gout,
                     const float* __restrict__ fwdout,
                     float* __restrict__ grad, int N, int T, int K, int ntx) {
  __shared__ float sp[BATCH][NF];
  __shared__ int sid[BATCH];
  __shared__ float part[BATCH][NWARP][NF];

  const int bt = blockIdx.x;
  const int b = bt / T, t = bt - b * T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float px = (float)((t % ntx) * TILE + (tid % TILE));
  const float py = (float)((t / ntx) * TILE + (tid / TILE));
  const int count = min(counts[bt], K);
  const int* tile_ids = ids + (size_t)bt * K;
  const float* pk_cam = packets + (size_t)b * N * NF;
  float* g_cam = grad + (size_t)b * N * NF;

  const float* go = gout + (size_t)bt * 5 * NPIX + tid;
  const float* fo = fwdout + (size_t)bt * 5 * NPIX + tid;
  const float gc0 = go[0], gc1 = go[NPIX], gc2 = go[2 * NPIX];
  const float gd = go[3 * NPIX], ga = go[4 * NPIX];
  // T_final and the total sum_i w_i s_i come from the forward's output
  const float G = ga * (1.0f - fo[4 * NPIX]);
  const float s_tot = fo[0] * gc0 + fo[NPIX] * gc1 + fo[2 * NPIX] * gc2
                      + fo[3 * NPIX] * gd;

  float tr = 1.0f, pre = 0.0f;
  for (int base = 0; base < count; base += BATCH) {
    const int nb = min(BATCH, count - base);
    __syncthreads();
    stage(pk_cam, tile_ids, base, nb, sp, sid);
    __syncthreads();
    for (int k = 0; k < nb; ++k) {
      float r[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) r[f] = 0.0f;
      if (sid[k] >= 0) {
        const float ca = sp[k][2], cb = sp[k][3], cc = sp[k][4];
        const float dx = px - sp[k][0];
        const float dy = py - sp[k][1];
        const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
        const float ex = expf(power);
        const float araw = sp[k][8] * ex;
        const bool live = power <= 0.0f && fminf(MAX_ALPHA, araw) >= ALPHA_MIN;
        const float alpha = live ? fminf(MAX_ALPHA, araw) : 0.0f;
        const float test = tr * (1.0f - alpha);
        const bool wl = test >= T_MIN;
        const float w = wl ? alpha * tr : 0.0f;
        const float s = sp[k][5] * gc0 + sp[k][6] * gc1 + sp[k][7] * gc2
                        + sp[k][9] * gd;
        pre = pre + w * s;
        const float s_after = s_tot - pre;   // sum over later contributors
        const float galpha = ((wl && live) ? tr * s : 0.0f)
                             + (live ? (G - s_after) / (1.0f - alpha) : 0.0f);
        const bool unc = live && araw < MAX_ALPHA;
        const float gpow = unc ? galpha * araw : 0.0f;
        const float gopa = unc ? galpha * ex : 0.0f;
        r[0] = gpow * (ca * dx + cb * dy);
        r[1] = gpow * (cc * dy + cb * dx);
        r[2] = gpow * (-0.5f * dx * dx);
        r[3] = gpow * (-dx * dy);
        r[4] = gpow * (-0.5f * dy * dy);
        r[5] = w * gc0;
        r[6] = w * gc1;
        r[7] = w * gc2;
        r[8] = gopa;
        r[9] = w * gd;
        tr = test;
      }
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        float v = r[f];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        r[f] = v;
      }
      if (lane == 0) {
#pragma unroll
        for (int f = 0; f < NF; ++f) part[k][warp][f] = r[f];
      }
    }
    __syncthreads();
    for (int i = tid; i < nb * NF; i += NPIX) {
      const int k = i / NF, f = i - k * NF;
      if (sid[k] < 0) continue;
      float s = 0.0f;
      for (int wi = 0; wi < NWARP; ++wi) s += part[k][wi][f];
      if (s != 0.0f) atomicAdd(&g_cam[(size_t)sid[k] * NF + f], s);
    }
  }
}

}  // namespace

extern "C" int composite_fwd(const float* packets, const int* ids,
                             const int* counts, float* out, int* ntouch,
                             int B, int N, int T, int K, int ntx,
                             int want_touched, void* stream) {
  if (B * T > 0)
    composite_fwd_kernel<<<B * T, NPIX, 0, (cudaStream_t)stream>>>(
        packets, ids, counts, out, ntouch, N, T, K, ntx, want_touched);
  return (int)cudaGetLastError();
}

extern "C" int composite_bwd(const float* packets, const int* ids,
                             const int* counts, const float* gout,
                             const float* fwdout, float* grad, int B, int N,
                             int T, int K, int ntx, void* stream) {
  if (B * T > 0)
    composite_bwd_kernel<<<B * T, NPIX, 0, (cudaStream_t)stream>>>(
        packets, ids, counts, gout, fwdout, grad, N, T, K, ntx);
  return (int)cudaGetLastError();
}

// DSPO stage 2 (depth, scale and shift, poses frozen) for Hopper (sm_90a):
//   dspo_scale_shift   one Gauss-Newton iteration of the stage-2 system
//                      <- ops/ba.py _scale_shift_iteration_torch
//   dspo_depth_filter  the multiview consistency count
//                      <- tracking/depth_video.py depth_filter_torch
//
// Neither replaces a TPU kernel: the JAX package runs both functions as XLA
// programs. They were added because their plain PyTorch versions are chains
// of some 330 (an iteration) and 900 (a stage-2 round's filter) small
// operations, each a launch the host has to issue: the card waited on the
// host, not on the work. On the tracker's shapes (E ~ 100 edges, M ~ 40
// depth frames of 40 x 80 or 48 x 64 pixels) an iteration is ~3e7 FP32
// operations and ~6 MB of reads, a few microseconds of the card at its peak
// rates; what bounds these kernels is one launch each and, at these sizes,
// the few blocks in flight. The design follows from that:
//
//   * dspo_scale_shift runs one block per depth frame k of edges.kx. An edge
//     (i -> j) with kk == k reads disps[i], the two poses and its own target
//     and weight rows, so a frame's block needs nothing from another block:
//     no atomics and no second pass. Threads walk the frame's pixels; for a
//     pixel a thread loops over the frame's edges (edges.by_frame(): the
//     edges sorted stably by kk, so in the order index_add_ sums them on the
//     CPU), forms the projection, its validity, the residual and the
//     disparity Jacobian Jz, and sums Ck and wk in registers. The pose
//     Jacobians are never formed: stage 2 does not read them. The block then
//     sums the ten per-frame terms of the 2x2 Schur system at once (the
//     five of H and u, and the five products with Q), solves it with the
//     plain version's det, isfinite and kx_mask tests, and writes the
//     frame's new disparities, scale and shift. Q, w, E0 and E1 of each
//     pixel go to a scratch row between the passes (the same thread reads
//     them back, so no barrier guards them).
//   * dspo_depth_filter runs one thread per (frame, pixel): the 6
//     neighbours, each with its pose product, projection and 4 taps.
//
// Arithmetic follows the plain versions operation by operation (the
// quaternion products of ops/lie.py, the projection of ops/projective.py)
// and the code is compiled with -fmad=false, so an element differs from the
// plain version only where the plain version's own kernels fuse or reorder
// (its index_add_ and sums on the card take another order). The per-frame
// sums are taken in a tree over the block's threads.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SS_THREADS = 512;     // threads a frame's block
constexpr int DF_THREADS = 256;
constexpr int NSUM = 10;            // per-frame sums of the 2x2 system
constexpr unsigned FULL = 0xffffffffu;
constexpr float MIN_DEPTH = 0.2f;   // ops/projective.py MIN_DEPTH

struct Pose {
  float tx, ty, tz, qx, qy, qz, qw;
};

__device__ __forceinline__ Pose load_pose(const float* p) {
  return Pose{p[0], p[1], p[2], p[3], p[4], p[5], p[6]};
}

// torch.linalg.cross(a, b)
__device__ __forceinline__ void cross(float ax, float ay, float az, float bx,
                                      float by, float bz, float& rx,
                                      float& ry, float& rz) {
  rx = ay * bz - az * by;
  ry = az * bx - ax * bz;
  rz = ax * by - ay * bx;
}

// lie.quat_rotate(q, v) = v + 2 (qw (qv x v) + qv x (qv x v))
__device__ __forceinline__ void rotate(const Pose& g, float vx, float vy,
                                       float vz, float& ox, float& oy,
                                       float& oz) {
  float ux, uy, uz, wx, wy, wz;
  cross(g.qx, g.qy, g.qz, vx, vy, vz, ux, uy, uz);
  cross(g.qx, g.qy, g.qz, ux, uy, uz, wx, wy, wz);
  ox = vx + 2.0f * (g.qw * ux + wx);
  oy = vy + 2.0f * (g.qw * uy + wy);
  oz = vz + 2.0f * (g.qw * uz + wz);
}

// lie.mul(gj, lie.inv(gi))
__device__ __forceinline__ Pose relative(const Pose& gj, const Pose& gi) {
  const Pose c{0.0f, 0.0f, 0.0f, -gi.qx, -gi.qy, -gi.qz, gi.qw};
  float rx, ry, rz;
  rotate(c, gi.tx, gi.ty, gi.tz, rx, ry, rz);
  float sx, sy, sz;
  rotate(gj, -rx, -ry, -rz, sx, sy, sz);
  const float x1 = gj.qx, y1 = gj.qy, z1 = gj.qz, w1 = gj.qw;
  const float x2 = c.qx, y2 = c.qy, z2 = c.qz, w2 = c.qw;
  Pose g;
  g.tx = gj.tx + sx;
  g.ty = gj.ty + sy;
  g.tz = gj.tz + sz;
  g.qx = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2;
  g.qy = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2;
  g.qz = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2;
  g.qw = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2;
  return g;
}

// The sums of v over the block, in every thread. `red` holds
// (blockDim.x / 32) * N floats; every thread adds the warps' partial sums
// in the same order, so all get the same value.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[i] += __shfl_xor_sync(FULL, v[i], o);
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < N; ++i) red[warp * N + i] = v[i];
  __syncthreads();
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = 0.0f;
    for (int q = 0; q < nw; ++q) s += red[q * N + i];
    v[i] = s;
  }
}

__global__ void __launch_bounds__(SS_THREADS)
scale_shift_kernel(const float* __restrict__ poses,
                   const float* __restrict__ disps,
                   const float* __restrict__ intr,
                   const float* __restrict__ target,
                   const float* __restrict__ weight,
                   const float* __restrict__ eta,
                   const float* __restrict__ mono,
                   const float* __restrict__ scales,
                   const float* __restrict__ shifts,
                   const unsigned char* __restrict__ vmask,
                   const int64_t* __restrict__ jj,
                   const int64_t* __restrict__ kx,
                   const int64_t* __restrict__ order,
                   const int64_t* __restrict__ offsets,
                   const unsigned char* __restrict__ kx_mask, float lm,
                   float ep, float alpha, int hw, int w,
                   float* __restrict__ disps_out,
                   float* __restrict__ scales_out,
                   float* __restrict__ shifts_out,
                   float4* __restrict__ scratch) {
  __shared__ float red[(SS_THREADS / 32) * NSUM];
  const int k = blockIdx.x;
  const int64_t f = kx[k];
  const float fx = intr[0], fy = intr[1], cx = intr[2], cy = intr[3];
  const float sqrt_a = sqrtf(alpha);
  const float sa_valid = sqrt_a * 10.0f;
  const float sc = scales[f], sh = shifts[f];
  const int64_t n0 = offsets[k], n1 = offsets[k + 1];
  const Pose gi = load_pose(poses + 7 * f);
  const float* d_row = disps + f * hw;
  const float* m_row = mono + f * hw;
  const unsigned char* v_row = vmask + f * hw;
  const float* eta_row = eta + (int64_t)k * hw;
  float4* scr = scratch + (int64_t)k * hw;

  // sums: H00, H01, H11, -u0, -u1, E0QE0, E0QE1, E1QE1, E0Qw, E1Qw
  float acc[NSUM];
#pragma unroll
  for (int i = 0; i < NSUM; ++i) acc[i] = 0.0f;

  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    const float X = ((float)(p % w) - cx) / fx;
    const float Y = ((float)(p / w) - cy) / fy;
    const float d = d_row[p];
    float C = 0.0f, wp = 0.0f;
    for (int64_t n = n0; n < n1; ++n) {
      const int64_t e = order[n];
      const int64_t j = jj[e];
      // self-edges get a fixed baseline (ops/projective.py)
      const Pose g = j == f ? Pose{-0.1f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f}
                            : relative(load_pose(poses + 7 * j), gi);
      float rx, ry, rz;
      rotate(g, X, Y, 1.0f, rx, ry, rz);
      const float X1 = rx + d * g.tx;
      const float Y1 = ry + d * g.ty;
      const float Z1 = rz + d * g.tz;
      const float dd = 1.0f / (Z1 < 0.5f * MIN_DEPTH ? 1.0f : Z1);
      const float x = fx * (X1 * dd) + cx;
      const float y = fy * (Y1 * dd) + cy;
      const float valid = Z1 > MIN_DEPTH ? 1.0f : 0.0f;
      const float jz0 = (fx * dd) * g.tx + (-fx * X1 * dd * dd) * g.tz;
      const float jz1 = (fy * dd) * g.ty + (-fy * Y1 * dd * dd) * g.tz;
      const int64_t o = 2 * (e * hw + p);
      const float r0 = target[o] - x, r1 = target[o + 1] - y;
      const float w0 = 0.001f * valid * weight[o];
      const float w1 = 0.001f * valid * weight[o + 1];
      wp = wp + (w0 * r0 * jz0 + w1 * r1 * jz1);
      C = C + (w0 * jz0 * jz0 + w1 * jz1 * jz1);
    }
    // the prior's residual and its Jacobians in d, w and q
    const float m = m_row[p];
    const bool vm = v_row[p] != 0;
    const bool invalid = m < 1e-6f;
    const float r_d = sqrt_a * (d - (sc * m + sh));
    const float sa = vm ? sa_valid : sqrt_a;
    const float J_d = invalid && vm ? 0.0f : sa;
    const float J_s = invalid ? 0.0f : -m * sa;
    const float J_q = invalid ? 0.0f : -sa;
    const float Ct = C + J_d * J_d + eta_row[p];
    const float Q = Ct != 0.0f ? 1.0f / Ct : 0.0f;
    const float wv = wp - J_d * r_d;
    const float E0 = J_s * J_d, E1 = J_q * J_d;
    acc[0] += J_s * J_s;
    acc[1] += J_s * J_q;
    acc[2] += J_q * J_q;
    acc[3] += J_s * r_d;
    acc[4] += J_q * r_d;
    acc[5] += E0 * Q * E0;
    acc[6] += E0 * Q * E1;
    acc[7] += E1 * Q * E1;
    acc[8] += E0 * Q * wv;
    acc[9] += E1 * Q * wv;
    scr[p] = make_float4(Q, wv, E0, E1);
  }
  block_sum<NSUM>(acc, red);

  const float H00 = acc[0], H01 = acc[1], H11 = acc[2];
  const float u0 = -acc[3], u1 = -acc[4];
  const float S00 = H00 + ep + lm * H00 - acc[5];
  const float S01 = H01 - acc[6];
  const float S11 = H11 + ep + lm * H11 - acc[7];
  const float r0 = u0 - acc[8], r1 = u1 - acc[9];
  float det = S00 * S11 - S01 * S01;
  const bool safe = fabsf(det) > 1e-12f;
  det = safe ? det : 1.0f;
  const float dws = safe ? (S11 * r0 - S01 * r1) / det : 0.0f;
  const float dq = safe ? (-S01 * r0 + S00 * r1) / det : 0.0f;

  bool finite = true;
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    float4 t = scr[p];
    const float dz = t.x * (t.y - (t.z * dws + t.w * dq));
    finite = finite && isfinite(dz);
    t.x = dz;
    scr[p] = t;
  }
  const bool ok = __syncthreads_and(finite) && isfinite(dws) &&
                  isfinite(dq) && (kx_mask == nullptr || kx_mask[k] != 0);
  float* out_row = disps_out + f * hw;
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    const float d = d_row[p];
    const float nd = d + scr[p].x;
    // torch.clamp(min=1e-5), which keeps a NaN
    out_row[p] = ok ? (nd < 1e-5f ? 1e-5f : nd) : d;
  }
  if (threadIdx.x == 0) {
    scales_out[f] = sc + (ok ? dws : 0.0f);
    shifts_out[f] = sh + (ok ? dq : 0.0f);
  }
}

__global__ void __launch_bounds__(DF_THREADS)
depth_filter_kernel(const float* __restrict__ poses,
                    const float* __restrict__ disps,
                    const float* __restrict__ intr,
                    const int64_t* __restrict__ inds,
                    const float* __restrict__ thresh, int n, int num, int h,
                    int w, float* __restrict__ counts) {
  const int64_t hw = (int64_t)h * w;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)n * hw) return;
  const int b = (int)(idx / hw);
  const int p = (int)(idx - b * hw);
  const float fx = intr[0], fy = intr[1], cx = intr[2], cy = intr[3];
  const int64_t i = inds[b];
  const float X = ((float)(p % w) - cx) / fx;
  const float Y = ((float)(p / w) - cy) / fy;
  const float d = disps[i * hw + p];
  const float t = thresh[b];
  const Pose gi = load_pose(poses + 7 * i);
  const int offs[6] = {-1, -2, -3, 3, 4, 5};
  float count = 0.0f;
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const int64_t jx = i + offs[q];
    if (jx < 0 || jx >= num) continue;
    const Pose g = relative(load_pose(poses + 7 * jx), gi);
    float rx, ry, rz;
    rotate(g, X, Y, 1.0f, rx, ry, rz);
    const float X1 = rx + d * g.tx;
    const float Y1 = ry + d * g.ty;
    const float Z1 = rz + d * g.tz;
    const float uj = fx * X1 / Z1 + cx;
    const float vj = fy * Y1 / Z1 + cy;
    const float idj = 1.0f / (d / Z1);
    const float u0 = floorf(uj), v0 = floorf(vj);
    if (!(u0 >= 0.0f && v0 >= 0.0f && u0 < (float)(w - 1) &&
          v0 < (float)(h - 1)))
      continue;
    const float* dn = disps + jx * hw + (int64_t)v0 * w + (int64_t)u0;
    const bool agree = fabsf(idj - 1.0f / dn[0]) < t ||
                       fabsf(idj - 1.0f / dn[1]) < t ||
                       fabsf(idj - 1.0f / dn[w]) < t ||
                       fabsf(idj - 1.0f / dn[w + 1]) < t;
    count += agree ? 1.0f : 0.0f;
  }
  counts[idx] = count;
}

}  // namespace

// One stage-2 iteration; the outputs hold copies of disps, scales and shifts
// and get the rows of kx. kx_mask may be null (every frame applies).
// scratch: M * h * w float4.
extern "C" int dspo_scale_shift(
    const float* poses, const float* disps, const float* intr,
    const float* target, const float* weight, const float* eta,
    const float* mono, const float* scales, const float* shifts,
    const unsigned char* vmask, const int64_t* jj, const int64_t* kx,
    const int64_t* order, const int64_t* offsets,
    const unsigned char* kx_mask, float lm, float ep, float alpha, int M,
    int h, int w, float* disps_out, float* scales_out, float* shifts_out,
    float* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M > 0)
    scale_shift_kernel<<<M, SS_THREADS, 0, s>>>(
        poses, disps, intr, target, weight, eta, mono, scales, shifts, vmask,
        jj, kx, order, offsets, kx_mask, lm, ep, alpha, h * w, w, disps_out,
        scales_out, shifts_out, (float4*)scratch);
  return (int)cudaGetLastError();
}

// counts (n, h, w) of the frames inds against their 6 neighbours.
extern "C" int dspo_depth_filter(const float* poses, const float* disps,
                                 const float* intr, const int64_t* inds,
                                 const float* thresh, int n, int num, int h,
                                 int w, float* counts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t total = (int64_t)n * h * w;
  if (total > 0)
    depth_filter_kernel<<<(unsigned)((total + DF_THREADS - 1) / DF_THREADS),
                          DF_THREADS, 0, s>>>(poses, disps, intr, inds,
                                              thresh, n, num, h, w, counts);
  return (int)cudaGetLastError();
}

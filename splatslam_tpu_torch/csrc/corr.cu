// The update operator's local correlation for Hopper (sm_90a):
//   corr_alt  the 7x7 windows of every edge at all four pyramid levels
//             <- ops/corr.py alt_corr
//
// It replaces no TPU kernel: the JAX package computes alt_corr as XLA
// programs. It was added because the plain version builds the whole
// level-0 volume (N x 3072 x 3072 float32 at 48x64, 37.7 MB an edge) to read
// a window of it: about 3.2 GFLOP an edge on float32 SIMT matrix products
// and, chunked by the volume's bytes (7 edges a call), about 100 launches a
// chunk, 1 100 to 2 500 a round, which the host issued slower than the card
// ran them.
//
// The window needs far less. Bilinear sampling is linear in f2, so a window
// sample at c + d is the hat-weighted sum of the correlations <f1, f2(p)> at
// the integer positions p around it: the 7 samples a side are covered by 8
// integer taps, so a (edge, source pixel, level) needs 64 dot products of
// 128 channels and a combine of the 64 into 49 outputs with the weights
// max(0, 1 - |p - c - d|) that _bilinear_window_sample forms (computed here
// by the same expression, so they are its weights bit for bit). No volume
// is stored.
//
// The dot products run on the tensor cores (mma.sync m16n8k16, bf16 inputs,
// float32 accumulation: a product of bf16 values is exact in float32):
//
//   * a warp owns 16 source pixels, an 8 x 2 tile, the 16 rows of the mma;
//     their f1 (level 0) stays in registers for all four levels. A
//     neighbouring pixel's window is the same window moved by about a
//     pixel, so at each level the warp correlates its 16 pixels with every
//     target position of the rectangle their windows cover (clipped to the
//     map), 8 positions (the mma's columns) at a time, and keeps of each
//     result the taps that fall in that pixel's window. At level 0 that
//     rectangle is about 17 x 10 positions where the pixels ask for 16 x 64
//     taps; the coarser levels cover less.
//   * where the windows scatter (a depth edge, wild targets), the warp
//     splits its pixels, in order, into groups whose rectangle holds at
//     most REGION positions, one pass each: a lone pixel's window always
//     fits.
//   * the 128 channels are permuted so that a lane's share of a k-step of
//     both mma operands is 4 consecutive channels: the pyramid is
//     channel-last (the wrapper makes it so) and a lane reads the A and B
//     fragments of two k-steps in one 16-byte load, from L1 (the 4 warps of
//     a block cover a 16 x 4 tile, whose rectangles overlap) or L2, which
//     holds a round's pyramid (~25 frames, ~1 MB each).
//   * each pixel's 64 taps are gathered in shared memory; the warp then
//     combines them into the 49 outputs per level and writes them in the
//     layout the network reads: (N, 196, h, w), channel level * 49 + ix * 7
//     + iy.
//
// A tap outside the level's map is zero (the plain version has no entry
// there); a window wholly outside it, an infinite coordinate among them, is
// zero; a NaN coordinate gives NaN at every sample of the level, as the
// plain version's NaN weights do. The dot products are summed in another
// order than the plain version's matrix products; nothing else differs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CH = 128;              // feature channels
constexpr int LEVELS = 4;
constexpr int RAD = 3;               // window radius
constexpr int RD = 2 * RAD + 1;      // 7 samples a side
constexpr int TAPS = RD + 1;         // 8 integer taps a side cover them
constexpr int WIN = RD * RD;         // 49
constexpr int OUT_C = LEVELS * WIN;  // 196
constexpr int TW = 8, TH = 2;        // a warp's source pixels (16 rows)
constexpr int BW = 2, BH = 2;        // a block's warps: a 16 x 4 tile
constexpr int WARPS = BW * BH;
constexpr int THREADS = 32 * WARPS;
constexpr int REGION = 320;          // most target positions of a pass
constexpr int CHUNKS = 2;            // chunks of 8 positions in flight
constexpr int TSTRIDE = TAPS * TAPS + 1;  // a pixel's taps, +1: no bank
                                          // conflicts in the combine
static_assert(16 * TSTRIDE % 4 == 0, "a warp's taps in float4 stores");
constexpr int FAR = -0x40000000;     // the window origin of a pixel without
                                     // one: no position falls in it
constexpr unsigned FULL = 0xffffffffu;

struct Pyramid {
  const __nv_bfloat16* f[LEVELS];    // (P, h_l, w_l, 128) channel-last
  int h[LEVELS];
  int w[LEVELS];
};

__device__ __forceinline__ uint4 ld16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// c += A B for one k-step: A 16 x 16 (rows: pixels), B 16 x 8 (columns:
// positions), bf16 operands, float32 accumulation
__device__ __forceinline__ void mma(float c[4], unsigned a0, unsigned a1,
                                    unsigned a2, unsigned a3, unsigned b0,
                                    unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 8 values of shared memory to 8 consecutive outputs, 16-byte aligned
__device__ __forceinline__ void store_row(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = reinterpret_cast<const float4*>(v)[0];
  reinterpret_cast<float4*>(p)[1] = reinterpret_cast<const float4*>(v)[1];
}
__device__ __forceinline__ void store_row(__nv_bfloat16* p, const float* v) {
  const float4 a = reinterpret_cast<const float4*>(v)[0];
  const float4 b = reinterpret_cast<const float4*>(v)[1];
  const __nv_bfloat162 h[4] = {
      __floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(a.z, a.w),
      __floats2bfloat162_rn(b.x, b.y), __floats2bfloat162_rn(b.z, b.w)};
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
}

// _bilinear_window_sample's weight of integer position p for the sample at
// c + d: max(0, 1 - |(p - c) - d|), in its order of operations
__device__ __forceinline__ float hat(int p, float c, int d) {
  const float w = 1.0f - fabsf(((float)p - c) - (float)d);
  return fmaxf(w, 0.0f);
}

// The channel permutation: a lane with t = lane % 4 holds, for k-steps 2q
// and 2q + 1, the channels q * 32 + t * 8 + [0, 4) and + [4, 8), read in
// one 16-byte load. Within a k-step the mma's k = 2t, 2t + 1, 2t + 8,
// 2t + 9 of the lane are those 4 channels in order, in A and B alike, so
// the sum over k is the sum over all 128 channels.
struct Frag {
  uint4 v[4];                        // q = 0..3
};

__device__ __forceinline__ void load_frag(const __nv_bfloat16* p, Frag& f) {
#pragma unroll
  for (int q = 0; q < 4; ++q) f.v[q] = ld16(p + q * 32);
}

__device__ __forceinline__ void zero_frag(Frag& f) {
#pragma unroll
  for (int q = 0; q < 4; ++q) f.v[q] = make_uint4(0u, 0u, 0u, 0u);
}

// c = <f1 of the pixels g, g + 8, f2 of position g> over 128 channels, in
// two chains of 4 k-steps (the even and odd q) that the mma pipe overlaps
__device__ __forceinline__ void dot(float c[4], const Frag& ag,
                                    const Frag& ah, const Frag& b) {
  float d[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float* e = d[q & 1];
    mma(e, ag.v[q].x, ah.v[q].x, ag.v[q].y, ah.v[q].y, b.v[q].x, b.v[q].y);
    mma(e, ag.v[q].z, ah.v[q].z, ag.v[q].w, ah.v[q].w, b.v[q].z, b.v[q].w);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = d[0][i] + d[1][i];
}

// Region position n -> its row of the rectangle (n / rw, exact for the
// small n and rw here: (n + 0.5) / rw is at least 0.5 / rw from an integer)
__device__ __forceinline__ int row_of(int n, float inv_rw) {
  return (int)(((float)n + 0.5f) * inv_rw);
}

// One pass: the warp's 16 pixels against every position of the rectangle
// [rx0, rx0 + rw) x [ry0, ry0 + rh) of the level's map f2 (row length w2),
// keeping of each result the taps that fall in the pixel's window
// (origin (bx, by) of the pixels g and g + 8 of this lane) in T.
__device__ __forceinline__ void pass(const __nv_bfloat16* f2, int w2,
                                     int rx0, int ry0, int rw, int rh,
                                     const Frag& ag, const Frag& ah, int g,
                                     int t, int bxg, int byg, int bxh,
                                     int byh, float* T) {
  const int R = rw * rh;
  const float inv = 1.0f / (float)rw;
  // B of the CHUNKS chunks from n0 on: column g of each
  auto load = [&](int n0, Frag b[CHUNKS]) {
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      const int n = n0 + 8 * j + g;
      if (n < R) {
        const int r = row_of(n, inv);
        load_frag(f2 + ((int64_t)(ry0 + r) * w2 + rx0 + n - r * rw) * CH +
                      t * 8,
                  b[j]);
      } else {
        zero_frag(b[j]);
      }
    }
  };
  Frag b[CHUNKS];
  load(0, b);
#pragma unroll 1
  for (int n0 = 0; n0 < R; n0 += 8 * CHUNKS) {
    float c[CHUNKS][4];
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) dot(c[j], ag, ah, b[j]);
    // the next positions load while this lane scatters these
    if (n0 + 8 * CHUNKS < R) load(n0 + 8 * CHUNKS, b);
    // c[j] = (pixel g, column 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int n = n0 + 8 * j + 2 * t + s;
        if (n < R) {
          const int r = row_of(n, inv);
          const int py = ry0 + r, px = rx0 + n - r * rw;
          int dy = py - byg, dx = px - bxg;
          if ((unsigned)(dy | dx) < (unsigned)TAPS)
            T[g * TSTRIDE + dy * TAPS + dx] = c[j][s];
          dy = py - byh;
          dx = px - bxh;
          if ((unsigned)(dy | dx) < (unsigned)TAPS)
            T[(g + 8) * TSTRIDE + dy * TAPS + dx] = c[j][2 + s];
        }
      }
    }
  }
}

template <typename Tout>
__global__ void __launch_bounds__(THREADS, 4)
    corr_kernel(Pyramid pyr, const int64_t* __restrict__ ii,
                const int64_t* __restrict__ jj,
                const float* __restrict__ coords, int h, int w, int tiles_y,
                int tiles_x, Tout* __restrict__ out) {
  __shared__ __align__(16) float taps[WARPS][16 * TSTRIDE];
  __shared__ __align__(16) float stage[WARPS][WIN * 16];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = tiles_y * tiles_x;
  const int e = blockIdx.x / tiles;
  const int tile = blockIdx.x - e * tiles;
  const int x0 = (tile % tiles_x) * (BW * TW) + (warp % BW) * TW;
  const int y0 = (tile / tiles_x) * (BH * TH) + (warp / BW) * TH;
  if (y0 >= h || x0 >= w) return;    // the warp owns no pixel
  const int64_t hw = (int64_t)h * w;
  const int64_t fi = ii[e], fj = jj[e];
  float* T = taps[warp];

  // the mma's A: f1 of pixels g (row y0) and g + 8 (row y0 + 1), column
  // x0 + g; a pixel off the map correlates as zero
  Frag ag, ah;
  {
    const __nv_bfloat16* f1 = pyr.f[0] + fi * hw * CH + t * 8;
    const int x = x0 + g;
    if (x < w) load_frag(f1 + ((int64_t)y0 * w + x) * CH, ag);
    else zero_frag(ag);
    if (x < w && y0 + 1 < h) load_frag(f1 + ((int64_t)(y0 + 1) * w + x) * CH,
                                       ah);
    else zero_frag(ah);
  }

  // this lane's pixel of the combine: p = lane % 16, the row-major 8 x 2
  // tile's pixel p (the mma's row p)
  const int p = lane & 15;
  const int px = x0 + p % TW, py = y0 + p / TW;
  const bool on_map = px < w && py < h;
  float2 c0 = make_float2(0.0f, 0.0f);
  if (on_map)
    c0 = reinterpret_cast<const float2*>(coords)[e * hw + (int64_t)py * w +
                                                 px];
  Tout* o_base = out + e * OUT_C * hw + (int64_t)py * w + px;
  // whole 8-pixel rows at 16-byte aligned addresses
  const bool vector_rows = w % 8 == 0 && x0 + TW <= w;

#pragma unroll 1
  for (int l = 0; l < LEVELS; ++l) {
    // coords / 2^l, exact as the plain version's division
    const float sc = 1.0f / (float)(1 << l);
    const float cx = c0.x * sc, cy = c0.y * sc;
    const int H2 = pyr.h[l], W2 = pyr.w[l];
    const bool is_nan = isnan(cx) || isnan(cy);
    // the window touches the map (an infinite coordinate never does)
    const bool valid = on_map && !is_nan && H2 > 0 && W2 > 0 &&
                       cx >= -4.0f && cx < W2 + 3.0f && cy >= -4.0f &&
                       cy < H2 + 3.0f;
    const int bx = valid ? (int)floorf(cx) - RAD : FAR;
    const int by = valid ? (int)floorf(cy) - RAD : FAR;
    const int bxg = __shfl_sync(FULL, bx, g), byg = __shfl_sync(FULL, by, g);
    const int bxh = __shfl_sync(FULL, bx, g + 8);
    const int byh = __shfl_sync(FULL, by, g + 8);
    for (int i = lane; i < 16 * TSTRIDE / 4; i += 32)
      reinterpret_cast<float4*>(T)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncwarp();

    // one pass over the rectangle of all the windows where it holds at
    // most REGION positions; else the pixels in order, grouped while their
    // rectangle does (warp-uniform: every lane reads the same windows)
    const __nv_bfloat16* f2 = pyr.f[l] + fj * H2 * W2 * CH;
    const int ux0 = __reduce_min_sync(FULL, valid ? max(bx, 0) : W2);
    const int ux1 = __reduce_max_sync(FULL, valid ? min(bx + TAPS, W2) : 0);
    const int uy0 = __reduce_min_sync(FULL, valid ? max(by, 0) : H2);
    const int uy1 = __reduce_max_sync(FULL, valid ? min(by + TAPS, H2) : 0);
    const bool whole = (ux1 - ux0) * (uy1 - uy0) <= REGION;
    if (whole && ux1 > ux0 && uy1 > uy0)
      pass(f2, W2, ux0, uy0, ux1 - ux0, uy1 - uy0, ag, ah, g, t, bxg, byg,
           bxh, byh, T);
    int gx0 = 0, gx1 = 0, gy0 = 0, gy1 = 0;
    bool open = false;
#pragma unroll 1
    for (int q = 0; q < (whole ? 0 : 16); ++q) {
      const int qx = __shfl_sync(FULL, bx, q), qy = __shfl_sync(FULL, by, q);
      if (qx == FAR) continue;
      const int wx0 = max(qx, 0), wx1 = min(qx + TAPS, W2);
      const int wy0 = max(qy, 0), wy1 = min(qy + TAPS, H2);
      if (open) {
        const int nx0 = min(gx0, wx0), nx1 = max(gx1, wx1);
        const int ny0 = min(gy0, wy0), ny1 = max(gy1, wy1);
        if ((nx1 - nx0) * (ny1 - ny0) <= REGION) {
          gx0 = nx0, gx1 = nx1, gy0 = ny0, gy1 = ny1;
          continue;
        }
        pass(f2, W2, gx0, gy0, gx1 - gx0, gy1 - gy0, ag, ah, g, t, bxg, byg,
             bxh, byh, T);
      }
      gx0 = wx0, gx1 = wx1, gy0 = wy0, gy1 = wy1;
      open = true;
    }
    if (open)
      pass(f2, W2, gx0, gy0, gx1 - gx0, gy1 - gy0, ag, ah, g, t, bxg, byg,
           bxh, byh, T);
    __syncwarp();

    // combine: lanes 0-15 the outputs of the even window columns ix of
    // their pixel, 16-31 those of the odd ones, into the warp's stage
    // (output channel-major, 16 pixels a channel)
    float* O = stage[warp];
    if (valid) {
      const float* S = T + p * TSTRIDE;
      float wy0[RD], wy1[RD];
#pragma unroll
      for (int iy = 0; iy < RD; ++iy) {
        wy0[iy] = hat(by + iy, cy, iy - RAD);
        wy1[iy] = hat(by + iy + 1, cy, iy - RAD);
      }
#pragma unroll 1
      for (int ix = lane >> 4; ix < RD; ix += 2) {
        const float wx0 = hat(bx + ix, cx, ix - RAD);
        const float wx1 = hat(bx + ix + 1, cx, ix - RAD);
        float u[TAPS], v[TAPS];      // tap columns ix and ix + 1
#pragma unroll
        for (int r = 0; r < TAPS; ++r) {
          u[r] = S[r * TAPS + ix];
          v[r] = S[r * TAPS + ix + 1];
        }
#pragma unroll
        for (int iy = 0; iy < RD; ++iy) {
          // the plain version's order: rows (y) first, then columns
          const float t0 = wy0[iy] * u[iy] + wy1[iy] * u[iy + 1];
          const float t1 = wy0[iy] * v[iy] + wy1[iy] * v[iy + 1];
          O[(ix * RD + iy) * 16 + p] = wx0 * t0 + wx1 * t1;
        }
      }
    } else {
      const float v = is_nan ? nanf("") : 0.0f;
      for (int k = lane >> 4; k < WIN; k += 2) O[k * 16 + p] = v;
    }
    __syncwarp();
    // write: a row of the tile's 8 pixels of a channel in 16-byte stores
    // where the map's rows allow it, else pixel by pixel
    Tout* o_lvl = out + (e * OUT_C + l * WIN) * hw + (int64_t)y0 * w + x0;
    if (vector_rows) {
      for (int i = lane; i < WIN * TH; i += 32) {
        const int k = i / TH, row = i - k * TH;
        if (y0 + row < h)
          store_row(o_lvl + k * hw + (int64_t)row * w, O + k * 16 + row * TW);
      }
    } else if (on_map) {
      for (int k = lane >> 4; k < WIN; k += 2)
        store(o_base + (int64_t)(l * WIN + k) * hw, O[k * 16 + p]);
    }
    __syncwarp();
  }
}

template <typename Tout>
int launch(const Pyramid& pyr, const int64_t* ii, const int64_t* jj,
           const float* coords, int n, int h, int w, Tout* out,
           cudaStream_t s) {
  const int tiles_y = (h + BH * TH - 1) / (BH * TH);
  const int tiles_x = (w + BW * TW - 1) / (BW * TW);
  const int64_t blocks = (int64_t)n * tiles_y * tiles_x;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  if (blocks > 0)
    corr_kernel<Tout><<<(unsigned)blocks, THREADS, 0, s>>>(
        pyr, ii, jj, coords, h, w, tiles_y, tiles_x, out);
  return (int)cudaGetLastError();
}

}  // namespace

// out (n, 196, h, w) of edges ii -> jj (rows of the pyramid) at level-0
// targets coords (n, h, w, 2); the levels f0..f3 are bf16, channel-last.
// out_bf16: out is bf16 (rounded to nearest even), else float32.
extern "C" int corr_alt(const void* f0, const void* f1, const void* f2,
                        const void* f3, const int* level_h,
                        const int* level_w, const int64_t* ii,
                        const int64_t* jj, const float* coords, int n, int h,
                        int w, int out_bf16, void* out, void* stream) {
  Pyramid pyr;
  const void* f[LEVELS] = {f0, f1, f2, f3};
  for (int l = 0; l < LEVELS; ++l) {
    pyr.f[l] = static_cast<const __nv_bfloat16*>(f[l]);
    pyr.h[l] = level_h[l];
    pyr.w[l] = level_w[l];
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (out_bf16)
    return launch(pyr, ii, jj, coords, n, h, w, (__nv_bfloat16*)out, s);
  return launch(pyr, ii, jj, coords, n, h, w, (float*)out, s);
}

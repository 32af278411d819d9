// Tile raster kernels for Hopper (sm_90a), bound to Python through ctypes.
//
// What they replace. K1 raster_tile_launch replaces clap_tpu/render/raster.py
// _raster_tile_kernel (the main G-buffer walk: per pixel the nearest covering
// record, first record winning ties, with its float id and three attribute
// planes); K2 raster_depth_launch replaces _raster_depth_kernel (the same walk
// over 16-float records keeping only the minimum z, for the shadow atlas and
// the static bake). The plain PyTorch versions are raster_tile_ref /
// raster_depth_ref in clap_tpu_torch/render/raster.py; both kernels reproduce
// them bit for bit.
//
// Inputs. crec (B, Tc, cluster * NC) float32 coefficient records, one row per
// cluster of `cluster` triangles; tile_list (B, n_tiles * sub, cap_c) int32
// cluster ids of each 128-px sub-list, depth-sorted by quantized cluster
// near-z (ids past the count are 0); big_idx (B, n_big_c) the big list;
// counts (B, n_tiles, sub + 1) records in each sub-list, then in the big list.
// The TPU kernel needed the records pre-gathered per tile (no dynamic
// indexing); here a CTA reads its own ids and copies the cluster rows it
// walks, so no per-tile copy of the records exists.
//
// What bounds them on this card. The TPU brute-forced every record against
// every pixel of its lattice; at the slice 99.7 % of those tests fail
// coverage, so the old walk was bound by instruction issue on tests that
// could not pass. What a correct walk must do is depth-test the covered
// pixel-record pairs and write the planes: a few MFLOP and, for K1, 84 MB of
// planes (bytes); K2 is a 67 MB write of mostly empty atlas (bytes).
//
// Design.
// - One CTA of 8 warps per (sub-column, coarse tile, env). A warp owns a
//   compact 32 x PPT rectangle of the tile_h x 128 sub-tile (4 across,
//   2 down; lane = column, rows r0 + j), so px is one register, py is
//   computed per row, and stores stay 128-byte coalesced.
// - Per-warp conservative reject, in list order. For each staged chunk of
//   up to 32 records, lane l tests record l against the warp's rectangle:
//   rejected when, for some edge k, the largest value of a*x + b*y + c over
//   the rectangle's corner pixel centres is below -m, or when the smallest
//   value of the z plane there, minus m, is >= the warp's current maximum
//   depth. One __ballot_sync gives the records the warp must shade; it walks
//   them with __ffs in ascending (list) order, so "first record wins ties"
//   holds. Margin: the per-pixel value is fl(fl(fl(a*px) + fl(b*py)) + c);
//   each of its three roundings is at most u = 2^-24 relative to a partial
//   sum bounded by S = |a| max|x| + |b| max|y| + |c|, so it lies within
//   (3u + 3u^2) S of the exact plane. With m = 2^-22 S + 2^-120 (the
//   constant covers subnormal products) and the corner value taken in double
//   (exact products, sums rounded at 2^-53 S), a rejected record's edge is
//   negative at every pixel of the rectangle, or its z is >= every depth
//   there, so it cannot win any pixel: the walk is unchanged. Dead records
//   (zero a/b, c = -1) fail the edge test for free. A kept record is shaded
//   exactly as the plain version does, (a*px + b*py) + c with __fmul_rn /
//   __fadd_rn (no FMA contraction); a*px is hoisted out of the row loop,
//   the same rounded value.
// - Asynchronous staging. A chunk is chunk / cluster cluster rows, each
//   contiguous in crec; threads copy it with 16-byte cp.async into a ring of
//   two stages, the next chunk loading while the current one is shaded. One
//   __syncthreads per chunk makes the landed chunk visible, frees the other
//   stage and carries the per-warp maxima.
// - The depth-sorted early-out is the block rule of the TPU kernel: after a
//   chunk of the small list, stop when every pixel's depth is below the
//   chunk's minimum cluster zmin - 1e-3 (every warp reduces the same zmin
//   from the staged rows; the eight warp maxima meet in the ring's barrier).
//   The big list is walked in full.
// - A CTA whose lists are both empty skips the chunk loop and writes its
//   background. K2 stages its plane through shared memory and stores it as
//   float4 (K1 stores its five planes a row of a warp at a time, 128
//   coalesced bytes). A separate early return for empty CTAs, float4
//   stores and no lattice set-up, measured no faster on the atlas, where
//   most CTAs are empty, so there is one path.
// - Occupancy: launch bounds of 3 CTAs of 256 threads per SM for K1 at
//   PPT 4 and 8 (80 registers; 16 % faster than 2 CTAs uncapped; PPT 16
//   holds 80 floats of planes a thread and is left unbounded), 4 for K2
//   (64 registers).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 128;       // sub-tile width: 4 warps of 32 columns
constexpr int kMaxChunk = 32;    // one record per lane
constexpr int kStages = 2;

__device__ __forceinline__ float plane(const float* r, int i, float px,
                                       float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r[i], px), __fmul_rn(r[i + 1], py)),
                   r[i + 2]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// margin of a plane over a rectangle with max |x| = x1, max |y| = y1
__device__ __forceinline__ double margin(double a, double b, double c,
                                         double x1, double y1) {
  return 0x1p-22 * (fabs(a) * x1 + fabs(b) * y1 + fabs(c)) + 0x1p-120;
}

// true when record R can win no pixel of the warp's rectangle, 32 x PPT
// pixel centres from (X0 + 0.5, Y0 + 0.5), whose largest depth is wmax;
// NaN coefficients keep it. The corners are made here, not kept live.
template <int PPT>
__device__ __forceinline__ bool rejected(const float* R, int X0, int Y0,
                                         float wmax) {
  const double x0 = X0 + 0.5, x1 = X0 + 31.5;
  const double y0 = Y0 + 0.5, y1 = Y0 + PPT - 0.5;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const double a = R[3 * k], b = R[3 * k + 1], c = R[3 * k + 2];
    const double hi = a * (a > 0.0 ? x1 : x0) + b * (b > 0.0 ? y1 : y0) + c;
    if (hi < -margin(a, b, c, x1, y1)) return true;
  }
  const double a = R[9], b = R[10], c = R[11];
  const double lo = a * (a > 0.0 ? x0 : x1) + b * (b > 0.0 ? y0 : y1) + c;
  return lo - margin(a, b, c, x1, y1) >= (double)wmax;
}

// copy records [r0, r0 + chunk) of the id list `ids` into dst: chunk /
// cluster cluster rows of `row4` float4 each, 16 bytes a thread
__device__ __forceinline__ void stage(float* dst, const float* crec_env,
                                      const int* ids, int r0, int chunk,
                                      int cluster, int row4) {
  const int n4 = chunk / cluster * row4;
  const int c0 = r0 / cluster;
  for (int i = threadIdx.x; i < n4; i += kThreads) {
    const int q = i / row4;
    const int o = i - q * row4;
    const int id = __ldg(ids + c0 + q);
    cp_async16(dst + 4 * i, crec_env + ((size_t)id * row4 + o) * 4);
  }
  cp_async_commit();
}

constexpr int kK1Blocks = 3;     // K1's CTAs per SM at PPT 4 and 8

template <int PPT, int NC, bool ATTRS>
__global__ void __launch_bounds__(kThreads,
                                  ATTRS ? (PPT >= 16 ? 1 : kK1Blocks) : 4)
raster_kernel(const float* __restrict__ crec, const int* __restrict__ tile_list,
              const int* __restrict__ big_idx, const int* __restrict__ counts,
              float* __restrict__ o_depth, float* __restrict__ o_tid,
              float* __restrict__ o_d0, float* __restrict__ o_d1,
              float* __restrict__ o_s, int Tc, int cluster, int cap_c,
              int n_big_c, int n_tiles, int ntx, int sub, int chunk, int Hp,
              int Wp) {
  constexpr int ZCOL = ATTRS ? 22 : 12;
  constexpr int TH = 2 * PPT;                     // sub-tile rows
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  __shared__ float red[kStages][kWarps];

  const int b = blockIdx.y;
  const int ti = blockIdx.x / sub;
  const int sc = blockIdx.x - ti * sub;
  const int tx0 = (ti % ntx) * sub * kCols + sc * kCols;
  const int ty0 = (ti / ntx) * TH;
  const int* cnt = counts + ((size_t)b * n_tiles + ti) * (sub + 1);
  const int count = cnt[sc];
  const int big_count = cnt[sub];
  const int ns = (count + chunk - 1) / chunk;
  const int total = ns + (big_count + chunk - 1) / chunk;
  const size_t out0 = ((size_t)b * Hp + ty0) * Wp + tx0;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int X0 = tx0 + (warp & 3) * 32;
  const int Y0 = ty0 + (warp >> 2) * PPT;
  const float px = (float)(X0 + lane) + 0.5f;

  float depth[PPT];
  float tid[ATTRS ? PPT : 1], d0[ATTRS ? PPT : 1], d1[ATTRS ? PPT : 1],
      s[ATTRS ? PPT : 1];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    depth[j] = CUDART_INF_F;
    if (ATTRS) {
      tid[j] = -1.0f;
      d0[j] = 0.0f;
      d1[j] = 0.0f;
      s[j] = 1.0f;
    }
  }

  if (total > 0) {
    const int row4 = cluster * NC / 4;
    const float* cenv = crec + (size_t)b * Tc * cluster * NC;
    const int* small_ids = tile_list + ((size_t)b * n_tiles * sub + blockIdx.x)
                                           * cap_c;
    const int* big_ids = big_idx + (size_t)b * n_big_c;
    auto issue = [&](int q, int st) {
      float* dst = smem + st * chunk * NC;
      if (q < ns)
        stage(dst, cenv, small_ids, q * chunk, chunk, cluster, row4);
      else
        stage(dst, cenv, big_ids, (q - ns) * chunk, chunk, cluster, row4);
    };

    float wmax = CUDART_INF_F;   // this warp's largest depth
    float zprev = 0.0f;          // previous chunk's minimum cluster zmin
    bool prev_small = false;
    int q = 0, st = 0;
    issue(0, 0);
    for (;;) {
      cp_async_wait_all();
      __syncthreads();           // chunk q landed; stage st ^ 1 is free
      if (prev_small && q < ns) {
        float bm = red[st ^ 1][0];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) bm = fmaxf(bm, red[st ^ 1][w]);
        if (bm < zprev - 1e-3f) {                 // uniform across the CTA
          q = ns;                                 // on to the big list
          if (q == total) break;
          issue(q, st);
          cp_async_wait_all();
          __syncthreads();
        }
      }
      if (q + 1 < total) issue(q + 1, st ^ 1);

      const float* S = smem + st * chunk * NC;
      const bool small = q < ns;
      const int n_valid = small ? min(chunk, count - q * chunk)
                                : min(chunk, big_count - (q - ns) * chunk);
      bool keep = false;
      float zl = CUDART_INF_F;
      if (lane < chunk) {
        const float* R = S + lane * NC;
        zl = R[ZCOL];
        keep = lane < n_valid && !rejected<PPT>(R, X0, Y0, wmax);
      }
      unsigned mask = __ballot_sync(0xffffffffu, keep);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        zl = fminf(zl, __shfl_xor_sync(0xffffffffu, zl, o));

      while (mask) {                              // list order
        const int r = __ffs(mask) - 1;
        mask &= mask - 1;
        const float* R = S + r * NC;
        const float ax0 = __fmul_rn(R[0], px), ax1 = __fmul_rn(R[3], px),
                    ax2 = __fmul_rn(R[6], px), axz = __fmul_rn(R[9], px);
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
          const float py = (float)(Y0 + j) + 0.5f;
          const float e0 = __fadd_rn(__fadd_rn(ax0, __fmul_rn(R[1], py)), R[2]);
          const float e1 = __fadd_rn(__fadd_rn(ax1, __fmul_rn(R[4], py)), R[5]);
          const float e2 = __fadd_rn(__fadd_rn(ax2, __fmul_rn(R[7], py)), R[8]);
          const float z = __fadd_rn(__fadd_rn(axz, __fmul_rn(R[10], py)), R[11]);
          const bool ok = (e0 >= 0.0f) & (e1 >= 0.0f) & (e2 >= 0.0f) &
                          (z >= -1.0f) & (z <= 1.0f);
          if (ok && z < depth[j]) {
            depth[j] = z;
            if (ATTRS) {
              tid[j] = R[21];
              d0[j] = plane(R, 12, px, py);
              d1[j] = plane(R, 15, px, py);
              s[j] = plane(R, 18, px, py);
            }
          }
        }
      }

      float m = depth[0];
#pragma unroll
      for (int j = 1; j < PPT; ++j) m = fmaxf(m, depth[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      wmax = m;
      if (lane == 0) red[st][warp] = m;
      zprev = zl;
      prev_small = small;
      ++q;
      st ^= 1;
      if (q == total) break;
    }
  }

  if (ATTRS) {
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const size_t o = ((size_t)b * Hp + Y0 + j) * Wp + X0 + lane;
      o_depth[o] = depth[j];
      o_tid[o] = tid[j];
      o_d0[o] = d0[j];
      o_d1[o] = d1[j];
      o_s[o] = s[j];
    }
  } else {
    // through shared memory, out as float4
    __syncthreads();                              // the ring is consumed
    float* tile = smem;                           // TH x 128
#pragma unroll
    for (int j = 0; j < PPT; ++j)
      tile[(Y0 - ty0 + j) * kCols + (X0 - tx0) + lane] = depth[j];
    __syncthreads();
    for (int i = threadIdx.x; i < TH * kCols / 4; i += kThreads) {
      const size_t o = out0 + (size_t)(i / (kCols / 4)) * Wp + 4 * (i % 32);
      *reinterpret_cast<float4*>(o_depth + o) = smem4[i];
    }
  }
}

template <int NC, bool ATTRS>
int launch(const float* crec, const int* tile_list, const int* big_idx,
           const int* counts, float* depth, float* tid, float* d0, float* d1,
           float* s, int B, int Tc, int cluster, int cap_c, int n_big_c,
           int n_tiles, int ntx, int tile_h, int tile_w, int sub, int chunk,
           int Hp, int Wp, cudaStream_t stream) {
  if (B == 0 || n_tiles == 0) return 0;
  if (sub <= 0 || tile_w != sub * kCols || cluster <= 0 || chunk <= 0 ||
      chunk > kMaxChunk || chunk % cluster || (cap_c * cluster) % chunk ||
      (n_big_c * cluster) % chunk || (cluster * NC) % 4 || Tc <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_tiles * sub, B);
  const int ring = kStages * chunk * NC;
  const int plane_floats = ATTRS ? 0 : tile_h * kCols;
  const size_t smem = (size_t)(ring > plane_floats ? ring : plane_floats) *
                      sizeof(float);
  switch (tile_h) {
#define CLAP_LAUNCH(TH)                                                     \
  case TH:                                                                  \
    raster_kernel<TH / 2, NC, ATTRS><<<grid, kThreads, smem, stream>>>(     \
        crec, tile_list, big_idx, counts, depth, tid, d0, d1, s, Tc,        \
        cluster, cap_c, n_big_c, n_tiles, ntx, sub, chunk, Hp, Wp);         \
    break;
    CLAP_LAUNCH(8)
    CLAP_LAUNCH(16)
    CLAP_LAUNCH(32)
#undef CLAP_LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int raster_tile_launch(const float* crec, const int* tile_list,
                                  const int* big_idx, const int* counts,
                                  float* depth, float* tid, float* d0,
                                  float* d1, float* s, int B, int Tc,
                                  int cluster, int cap_c, int n_big_c,
                                  int n_tiles, int ntx, int tile_h, int tile_w,
                                  int sub, int chunk, int Hp, int Wp,
                                  void* stream) {
  return launch<24, true>(crec, tile_list, big_idx, counts, depth, tid, d0,
                          d1, s, B, Tc, cluster, cap_c, n_big_c, n_tiles, ntx,
                          tile_h, tile_w, sub, chunk, Hp, Wp,
                          (cudaStream_t)stream);
}

extern "C" int raster_depth_launch(const float* crec, const int* tile_list,
                                   const int* big_idx, const int* counts,
                                   float* depth, int B, int Tc, int cluster,
                                   int cap_c, int n_big_c, int n_tiles,
                                   int ntx, int tile_h, int tile_w, int sub,
                                   int chunk, int Hp, int Wp, void* stream) {
  return launch<16, false>(crec, tile_list, big_idx, counts, depth, nullptr,
                           nullptr, nullptr, nullptr, B, Tc, cluster, cap_c,
                           n_big_c, n_tiles, ntx, tile_h, tile_w, sub, chunk,
                           Hp, Wp, (cudaStream_t)stream);
}

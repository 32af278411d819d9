// Tile raster kernels for Hopper (sm_90a), bound to Python through ctypes.
//
// K1 raster_tile_kernel replaces clap_tpu/render/raster.py
// _raster_tile_kernel (the main G-buffer walk); K2 raster_depth_kernel
// replaces _raster_depth_kernel (the shadow-atlas walk). The plain PyTorch
// versions are raster_tile_ref / raster_depth_ref in
// clap_tpu_torch/render/raster.py; both kernels reproduce them exactly.
//
// Layout. One CTA per (sub-column, coarse tile, env): blockIdx.x =
// tile * sub + sc, blockIdx.y = env. The sub-column is a tile_h x 128
// pixel lattice; 256 threads own PPT = tile_h * 128 / 256 pixels each
// (pixel p = threadIdx.x + j * 256, so neighbouring threads write
// neighbouring addresses). Inputs: counts (B, n_tiles, sub + 1) int32 —
// records in each sub-list, then in the shared big list; trec
// (B, n_tiles, sub * cap, NC) float32 pre-gathered coefficient records,
// depth-sorted by cluster near-z; brec (B, n_big, NC) the big list.
//
// Walk. Each list is consumed in chunks of `chunk` records staged in
// shared memory; every thread tests each staged record against its pixels
// in list order and takes it only when strictly nearer, which is exactly
// "nearest wins, first record wins among equal z" of the TPU kernel's
// chunk reduction. Planes are evaluated as (a*px + b*py) + c with
// explicitly rounded multiplies and adds (no FMA contraction), the
// arithmetic of the plain version. After each chunk of the small list a
// block-wide max of the depth plane is compared with the chunk's minimum
// cluster zmin - 1e-3 (the list is sorted by 12-bit quantized zmin): once
// every pixel is nearer, no later record can win and the walk stops. The
// big list is walked in full afterwards.
//
// Bounds on this card: each staged record costs ~4 (K2) or ~7 (K1) plane
// evaluations per pixel; the walk is bound by instruction issue on the
// lattice and by the per-chunk barrier, not by memory (a 32-record chunk
// is 3 KiB read once per CTA). The design keeps records in shared memory
// and pixels in registers, and stops early on occluded lists; tensor
// cores, TMA and warp specialisation are left for later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float plane(const float* r, int i, float px,
                                       float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r[i], px), __fmul_rn(r[i + 1], py)),
                   r[i + 2]);
}

template <int PPT, int NC, bool ATTRS>
__global__ void __launch_bounds__(kThreads)
raster_kernel(const int* __restrict__ counts, const float* __restrict__ trec,
              const float* __restrict__ brec, float* __restrict__ o_depth,
              float* __restrict__ o_tid, float* __restrict__ o_d0,
              float* __restrict__ o_d1, float* __restrict__ o_s,
              int n_tiles, int ntx, int tile_h, int tile_w, int sub, int cap,
              int n_big, int chunk, int Hp, int Wp) {
  constexpr int ZCOL = ATTRS ? 22 : 12;
  extern __shared__ float slab[];                 // chunk * NC floats
  __shared__ float red[kWarps];

  const int b = blockIdx.y;
  const int ti = blockIdx.x / sub;
  const int sc = blockIdx.x - ti * sub;
  const int tws = tile_w / sub;
  const int tx0 = (ti % ntx) * tile_w + sc * tws;
  const int ty0 = (ti / ntx) * tile_h;
  const int* cnt = counts + ((size_t)b * n_tiles + ti) * (sub + 1);
  const int count = cnt[sc];
  const int big_count = cnt[sub];
  const float* list =
      trec + (((size_t)b * n_tiles + ti) * sub + sc) * (size_t)cap * NC;
  const float* big = brec + (size_t)b * n_big * NC;

  float px[PPT], py[PPT], depth[PPT];
  float tid[ATTRS ? PPT : 1], d0[ATTRS ? PPT : 1], d1[ATTRS ? PPT : 1],
      s[ATTRS ? PPT : 1];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = threadIdx.x + j * kThreads;
    const int row = p / tws;
    px[j] = (float)(tx0 + (p - row * tws)) + 0.5f;
    py[j] = (float)(ty0 + row) + 0.5f;
    depth[j] = CUDART_INF_F;
    if (ATTRS) {
      tid[j] = -1.0f;
      d0[j] = 0.0f;
      d1[j] = 0.0f;
      s[j] = 1.0f;
    }
  }

  // stage rows [row0, row0 + chunk) of `src` (n_rows valid rows)
  auto stage = [&](const float* src, int row0, int n_rows) {
    __syncthreads();                              // previous chunk consumed
    const int n = chunk * NC;
    const int avail = (n_rows - row0) * NC;
    for (int i = threadIdx.x; i < n; i += kThreads)
      slab[i] = i < avail ? src[(size_t)row0 * NC + i] : 0.0f;
    __syncthreads();
  };

  auto shade = [&](int n_valid) {
    for (int r = 0; r < n_valid; ++r) {
      const float* R = slab + r * NC;
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const float e0 = plane(R, 0, px[j], py[j]);
        const float e1 = plane(R, 3, px[j], py[j]);
        const float e2 = plane(R, 6, px[j], py[j]);
        const float z = plane(R, 9, px[j], py[j]);
        const bool ok = (e0 >= 0.0f) & (e1 >= 0.0f) & (e2 >= 0.0f) &
                        (z >= -1.0f) & (z <= 1.0f);
        if (ok && z < depth[j]) {
          depth[j] = z;
          if (ATTRS) {
            tid[j] = R[21];
            d0[j] = plane(R, 12, px[j], py[j]);
            d1[j] = plane(R, 15, px[j], py[j]);
            s[j] = plane(R, 18, px[j], py[j]);
          }
        }
      }
    }
  };

  // small list: depth-sorted, with the block-wide early-out
  const int n_small = (count + chunk - 1) / chunk;
  for (int k = 0; k < n_small; ++k) {
    stage(list, k * chunk, cap);
    shade(min(chunk, count - k * chunk));
    float m = depth[0];
#pragma unroll
    for (int j = 1; j < PPT; ++j) m = fmaxf(m, depth[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
    __syncthreads();
    float block_max = red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) block_max = fmaxf(block_max, red[w]);
    float zmin = slab[ZCOL];
    for (int r = 1; r < chunk; ++r) zmin = fminf(zmin, slab[r * NC + ZCOL]);
    if (block_max < zmin - 1e-3f) break;          // uniform across the CTA
  }

  // big list: walked in full
  const int n_bigc = (big_count + chunk - 1) / chunk;
  for (int k = 0; k < n_bigc; ++k) {
    stage(big, k * chunk, n_big);
    shade(min(chunk, big_count - k * chunk));
  }

#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = threadIdx.x + j * kThreads;
    const int row = p / tws;
    const size_t o =
        ((size_t)b * Hp + ty0 + row) * Wp + tx0 + (p - row * tws);
    o_depth[o] = depth[j];
    if (ATTRS) {
      o_tid[o] = tid[j];
      o_d0[o] = d0[j];
      o_d1[o] = d1[j];
      o_s[o] = s[j];
    }
  }
}

template <int NC, bool ATTRS>
int launch(const int* counts, const float* trec, const float* brec,
           float* depth, float* tid, float* d0, float* d1, float* s, int B,
           int n_tiles, int ntx, int tile_h, int tile_w, int sub, int cap,
           int n_big, int chunk, int Hp, int Wp, cudaStream_t stream) {
  if (B == 0 || n_tiles == 0) return 0;
  if (sub <= 0 || tile_w % sub || chunk <= 0) return (int)cudaErrorInvalidValue;
  const int npx = tile_h * (tile_w / sub);
  const dim3 grid(n_tiles * sub, B);
  const size_t smem = (size_t)chunk * NC * sizeof(float);
  switch (npx / kThreads) {
#define CLAP_LAUNCH(P)                                                     \
  case P:                                                                  \
    if (npx != P * kThreads) return (int)cudaErrorInvalidValue;           \
    raster_kernel<P, NC, ATTRS><<<grid, kThreads, smem, stream>>>(        \
        counts, trec, brec, depth, tid, d0, d1, s, n_tiles, ntx, tile_h,   \
        tile_w, sub, cap, n_big, chunk, Hp, Wp);                           \
    break;
    CLAP_LAUNCH(4)
    CLAP_LAUNCH(8)
    CLAP_LAUNCH(16)
#undef CLAP_LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int raster_tile_launch(const int* counts, const float* trec,
                                  const float* brec, float* depth, float* tid,
                                  float* d0, float* d1, float* s, int B,
                                  int n_tiles, int ntx, int tile_h,
                                  int tile_w, int sub, int cap, int n_big,
                                  int chunk, int Hp, int Wp, void* stream) {
  return launch<24, true>(counts, trec, brec, depth, tid, d0, d1, s, B,
                          n_tiles, ntx, tile_h, tile_w, sub, cap, n_big,
                          chunk, Hp, Wp, (cudaStream_t)stream);
}

extern "C" int raster_depth_launch(const int* counts, const float* trec,
                                   const float* brec, float* depth, int B,
                                   int n_tiles, int ntx, int tile_h,
                                   int tile_w, int sub, int cap, int n_big,
                                   int chunk, int Hp, int Wp, void* stream) {
  return launch<16, false>(counts, trec, brec, depth, nullptr, nullptr,
                           nullptr, nullptr, B, n_tiles, ntx, tile_h, tile_w,
                           sub, cap, n_big, chunk, Hp, Wp,
                           (cudaStream_t)stream);
}

// 2D cellular-automaton kernel for Hopper (sm_90a), bound to Python through
// ctypes.
//
// K3 replaces clap_tpu/ops/ca2d.py _ca2d_kernel: `steps` synchronous
// generations of one rule over a batch of uint8 (B, H, W) grids, zero
// boundary, neighbourhoods m1 / vn1 (count non-zero neighbours, 8 / 4) and
// mv / vnv (count neighbours greater than the cell). The plain PyTorch
// version is ca2d_run in clap_tpu_torch/ops/ca2d.py; the kernel reproduces
// it bit for bit (integer arithmetic only), and _packed_step_ref there
// repeats its per-word formulas in torch for the CPU tests.
//
// What bounds it on this card. Each generation reads every cell's
// neighbourhood and writes the cell; nothing goes to device memory between
// the load and the final store, as in the TPU kernel, so the run is bound
// by integer issue (a few operations per cell and generation) and, for a
// single grid, by one barrier per generation. The design:
//
// - Four cells to a word (SWAR). Shared memory holds each grid row as
//   32-bit words, cell x in byte x % 4 (little-endian), with a zero word on
//   each side. m1 / vn1 use the TPU kernel's separable count: a nonzero bit
//   per byte, the row sum of three (the neighbours' edge bytes shifted in
//   beside the word's own), computed once per row and reused by the three
//   rows that read it, then the column sum minus the centre. mv / vnv take
//   the neighbours' bytes through __funnelshift_l / _r and compare bytes
//   exactly (the carry out of a + ~v). Counts are at most 8, so bytes never
//   carry into each other. Born / survive is a 9-entry lookup per byte:
//   __byte_perm on the mask's 8-byte table, count 8 patched in. The pad
//   bytes past W in a row's last word are never born, so they stay 0.
// - A thread walks a run of rows down one word column, keeping the three
//   rows' features in registers, so every row is loaded once per run.
// - Cluster route: a grid is split into row bands over a thread-block
//   cluster (cudaLaunchKernelEx with a cluster dimension; sizes above 8 are
//   non-portable). Each CTA keeps its band in two shared buffers. At
//   generation g it reads buffer g % 2 (its own band, and the rows above and
//   below it straight from the neighbour CTAs' buffer g % 2 through
//   distributed shared memory), writes buffer (g + 1) % 2, then one
//   cluster.sync(). No CTA writes a buffer its neighbours may still read in
//   that generation, and the last generation's cluster.sync() keeps every
//   CTA's shared memory alive until its neighbours' last remote reads are
//   done. One grid (the JAX bench's config #1) spreads over up to 16 SMs;
//   a batch that fills the card takes one CTA per grid (a cluster of 1
//   when a grid is too wide for the in-place route below).
// - In-place route, for a batch of grids that each take one CTA: one
//   buffer and a saved row, on packed words, so three 256^2 grids fit an SM
//   where two buffers allow one. A generation walks strips of rows; each
//   thread holds the new words of its run in registers; barrier; writes
//   them back; barrier. The writers of a strip's last row first save its
//   old words in a spare row, which the next strip reads as the row above.
// - Device-memory route, for a grid no cluster holds: one launch per
//   generation of the same packed stencil over two ping-pong buffers in
//   device memory (zero rows and words around each grid), plus a pack and
//   an unpack launch.
//
// The route, the cluster size, the bands and the run length come from the
// Python planner (ops/ca2d.py ca2d_plan), chosen before the launch; a
// launch the card refuses returns its CUDA error, and nothing falls back.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;        // a cluster-route CTA
constexpr int kInplaceThreads = 256;  // an in-place CTA ...
constexpr int kInplaceBlocks = 3;     // ... three resident per SM at 256^2
constexpr int kInplaceRun = 16;       // rows an in-place thread holds
constexpr int kGlobalThreads = 256;   // a device-memory-route CTA
constexpr int kGlobalRun = 4;         // rows a thread walks there

enum Neigh { kM1 = 0, kVN1 = 1, kMV = 2, kVNV = 3 };

constexpr uint32_t kH7 = 0x7F7F7F7Fu, kH8 = 0x80808080u, kL1 = 0x01010101u;

// A mask over neighbour counts as a per-byte lookup: bytes 0..7 hold bits
// 0..7 of the mask (0 or 1), `eight` is 0x01010101 when bit 8 is set.
struct Table {
  uint32_t lo, hi, eight;
};

struct Rule {
  Table born, surv;
  uint32_t nr_states;  // the byte written at a birth
  int decay;
};

Table make_table(uint32_t mask) {
  Table t = {0, 0, ((mask >> 8) & 1u) ? kL1 : 0u};
  for (int k = 0; k < 4; ++k) {
    t.lo |= ((mask >> k) & 1u) << (8 * k);
    t.hi |= ((mask >> (k + 4)) & 1u) << (8 * k);
  }
  return t;
}

// 1 in every byte of x that is not 0.
__device__ __forceinline__ uint32_t nz(uint32_t x) {
  return ((((x & kH7) + kH7) | x) & kH8) >> 7;
}

// 1 in every byte where a > v, unsigned: the carry out of a + ~v, from the
// low 7 bits' sum and the majority of the top bits.
__device__ __forceinline__ uint32_t gt(uint32_t a, uint32_t v) {
  const uint32_t nv = ~v;
  const uint32_t s = (a & kH7) + (nv & kH7);
  return (((a & nv) | (a & s) | (nv & s)) & kH8) >> 7;
}

// Bit n of the table's mask in every byte, for counts n <= 8.
__device__ __forceinline__ uint32_t lookup(const Table& t, uint32_t n) {
  const uint32_t m = n & 0x07070707u;
  const uint32_t q = m | (m >> 4);
  const uint32_t sel = (q & 0xFFu) | ((q >> 8) & 0xFF00u);  // nibble k: n_k
  const uint32_t eight = (n >> 3) & kL1;
  return (__byte_perm(t.lo, t.hi, sel) & ~eight) | (eight & t.eight);
}

// What the rows above and below need of a row at one word column, from
// the words left of (L), at (C) and right of (R) it. m1: a = the row sum
// of three nonzero bits, b = the centre's bit, c = C. vn1: a = the two
// side neighbours' bits. mv / vnv: a = cells x - 1, b = C, c = cells x + 1.
struct Feat {
  uint32_t a, b, c;
};

template <int MODE>
__device__ __forceinline__ Feat feat(uint32_t L, uint32_t C, uint32_t R) {
  if (MODE == kM1 || MODE == kVN1) {
    const uint32_t b = nz(C);
    const uint32_t side = ((b << 8) | (uint32_t)((L >> 24) != 0)) +
                          ((b >> 8) | ((uint32_t)((R & 0xFFu) != 0) << 24));
    return {MODE == kM1 ? b + side : side, b, C};
  }
  return {__funnelshift_l(L, C, 8), C, __funnelshift_r(C, R, 8)};
}

template <int MODE>
__device__ __forceinline__ uint32_t old_value(const Feat& m) {
  return (MODE == kM1 || MODE == kVN1) ? m.c : m.b;
}

// The next generation of the middle row's word. colmask is 0 in the pad
// bytes of a row's last word, so those are never born.
template <int MODE>
__device__ __forceinline__ uint32_t next_word(const Feat& u, const Feat& m,
                                              const Feat& d, const Rule& r,
                                              uint32_t colmask) {
  uint32_t n;
  const uint32_t v = old_value<MODE>(m);
  if (MODE == kM1) {
    n = u.a + m.a + d.a - m.b;
  } else if (MODE == kVN1) {
    n = u.b + m.a + d.b;
  } else {
    n = gt(u.b, v) + gt(m.a, v) + gt(m.c, v) + gt(d.b, v);
    if (MODE == kMV) n += gt(u.a, v) + gt(u.c, v) + gt(d.a, v) + gt(d.c, v);
  }
  const uint32_t alive = (MODE == kM1 || MODE == kVN1) ? m.b : nz(v);
  uint32_t out = v + (lookup(r.born, n) & ~alive & colmask) * r.nr_states;
  if (r.decay) out -= alive & ~lookup(r.surv, n);
  return out;
}

// 0xFF in the bytes of word column i (1-based) that hold cells.
__device__ __forceinline__ uint32_t col_mask(int i, int W) {
  const int valid = W - 4 * (i - 1);
  return valid >= 4 ? 0xFFFFFFFFu : (1u << (8 * valid)) - 1u;
}

// Walks rows [y0, y1) of word column i: row(y) gives the words of row y
// (for y0 - 1 <= y <= y1, zero word at index 0), emit(j, y, new, old) takes
// each new word with the old one. UNROLL > 0 unrolls a run of at most
// UNROLL rows, so that emit may index a register array by j.
template <int MODE, int UNROLL, typename RowFn, typename Emit>
__device__ __forceinline__ void walk(RowFn row, int i, int y0, int y1,
                                     const Rule& r, uint32_t colmask,
                                     Emit emit) {
  const uint32_t* p = row(y0 - 1);
  Feat u = feat<MODE>(p[i - 1], p[i], p[i + 1]);
  p = row(y0);
  Feat m = feat<MODE>(p[i - 1], p[i], p[i + 1]);
  auto one = [&](int j) {
    const uint32_t* q = row(y0 + j + 1);
    const Feat d = feat<MODE>(q[i - 1], q[i], q[i + 1]);
    emit(j, y0 + j, next_word<MODE>(u, m, d, r, colmask), old_value<MODE>(m));
    u = m;
    m = d;
  };
  if constexpr (UNROLL > 0) {
#pragma unroll
    for (int j = 0; j < UNROLL; ++j)
      if (y0 + j < y1) one(j);
  } else {
    for (int j = 0; y0 + j < y1; ++j) one(j);
  }
}

// Packs rows of W bytes (src, pitch W) into rows of words (dst, pitch P,
// word column i at dst[i + 1]); the pad bytes are 0.
__device__ __forceinline__ void pack_rows(const uint8_t* src, uint32_t* dst,
                                          int R, int W, int P) {
  const int WW = (W + 3) >> 2;
  for (int k = threadIdx.x; k < R * WW; k += blockDim.x) {
    const int y = k / WW, i = k - y * WW;
    const uint8_t* s = src + (size_t)y * W + 4 * i;
    const int n = min(4, W - 4 * i);
    uint32_t v = 0;
    for (int j = 0; j < n; ++j) v |= (uint32_t)s[j] << (8 * j);
    dst[y * P + i + 1] = v;
  }
}

__device__ __forceinline__ void unpack_rows(const uint32_t* src, uint8_t* dst,
                                            int R, int W, int P) {
  for (int k = threadIdx.x; k < R * W; k += blockDim.x) {
    const int y = k / W, x = k - y * W;
    dst[(size_t)y * W + x] =
        (uint8_t)(src[y * P + (x >> 2) + 1] >> (8 * (x & 3)));
  }
}

// Cluster route: cluster c steps grid c; CTA `rank` holds rows
// [rank * H / cs, (rank + 1) * H / cs). Shared memory: buffer 0 and buffer
// 1 of the band (R rows of P words each), then one zero row.
template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
ca2d_cluster_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                    int H, int W, int steps, Rule rule, int run) {
  extern __shared__ uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int WW = (W + 3) >> 2, P = WW + 2;
  const int r0 = rank * H / cs, R = (rank + 1) * H / cs - r0;
  const size_t base = (size_t)(blockIdx.x / cs) * H * W + (size_t)r0 * W;
  uint32_t* const buf0 = smem;
  uint32_t* const buf1 = smem + R * P;
  const uint32_t* const zero = smem + 2 * R * P;
  for (int k = threadIdx.x; k < (2 * R + 1) * P; k += kThreads) smem[k] = 0;
  __syncthreads();
  pack_rows(in + base, buf0, R, W, P);

  // the row above the band is the upper neighbour's last row, the row
  // below it the lower neighbour's first row, in buffer 0 and in buffer 1
  const uint32_t *up0 = zero, *up1 = zero, *dn0 = zero, *dn1 = zero;
  if (rank > 0) {
    const int Ru = r0 - (rank - 1) * H / cs;
    const uint32_t* s = cluster.map_shared_rank(smem, rank - 1);
    up0 = s + (Ru - 1) * P;
    up1 = s + (2 * Ru - 1) * P;
  }
  if (rank < cs - 1) {
    const int Rd = (rank + 2) * H / cs - (rank + 1) * H / cs;
    const uint32_t* s = cluster.map_shared_rank(smem, rank + 1);
    dn0 = s;
    dn1 = s + Rd * P;
  }
  cluster.sync();  // every band is loaded before a neighbour reads it

  const int items = WW * ((R + run - 1) / run);
  for (int g = 0; g < steps; ++g) {
    const bool odd = g & 1;
    const uint32_t* const cur = odd ? buf1 : buf0;
    uint32_t* const nxt = odd ? buf0 : buf1;
    const uint32_t* const up = odd ? up1 : up0;
    const uint32_t* const dn = odd ? dn1 : dn0;
    for (int k = threadIdx.x; k < items; k += kThreads) {
      const int i = k % WW + 1, y0 = (k / WW) * run;
      walk<MODE, 0>(
          [&](int y) { return y < 0 ? up : (y >= R ? dn : cur + y * P); }, i,
          y0, min(R, y0 + run), rule, col_mask(i, W),
          [&](int, int y, uint32_t v, uint32_t) { nxt[y * P + i] = v; });
    }
    cluster.sync();
  }
  unpack_rows((steps & 1) ? buf1 : buf0, out + base, R, W, P);
}

// In-place route: CTA b steps grid b in one buffer. Shared memory: the grid
// (H rows of P words), the saved row, a zero row. Needs WW <= threads.
template <int MODE>
__global__ void __launch_bounds__(kInplaceThreads, kInplaceBlocks)
ca2d_inplace_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                    int H, int W, int steps, Rule rule) {
  extern __shared__ uint32_t smem[];
  const int WW = (W + 3) >> 2, P = WW + 2;
  const size_t base = (size_t)blockIdx.x * H * W;
  uint32_t* const g = smem;
  uint32_t* const saved = smem + H * P;
  const uint32_t* const zero = saved + P;
  for (int k = threadIdx.x; k < (H + 2) * P; k += kInplaceThreads) smem[k] = 0;
  __syncthreads();
  pack_rows(in + base, g, H, W, P);
  __syncthreads();

  const int segs = kInplaceThreads / WW;
  const int strip = segs * kInplaceRun;
  const int i = threadIdx.x % WW + 1, seg = threadIdx.x / WW;
  const uint32_t cm = col_mask(i, W);
  for (int s = 0; s < steps; ++s) {
    for (int t0 = 0; t0 < H; t0 += strip) {
      const int t1 = min(H, t0 + strip);
      const int y0 = t0 + seg * kInplaceRun, y1 = min(t1, y0 + kInplaceRun);
      const bool mine = seg < segs && y0 < y1;
      const uint32_t* const up = t0 == 0 ? zero : saved;
      uint32_t res[kInplaceRun];
      uint32_t keep = 0;
      if (mine)
        walk<MODE, kInplaceRun>(
            [&](int y) { return y < t0 ? up : (y >= H ? zero : g + y * P); },
            i, y0, y1, rule, cm, [&](int j, int, uint32_t v, uint32_t old) {
              res[j] = v;
              keep = old;
            });
      __syncthreads();
      if (mine) {
        if (y1 == t1) saved[i] = keep;  // the strip's last row, still old
#pragma unroll
        for (int j = 0; j < kInplaceRun; ++j)
          if (y0 + j < y1) g[(y0 + j) * P + i] = res[j];
      }
      __syncthreads();
    }
  }
  unpack_rows(g, out + base, H, W, P);
}

// Device-memory route: one generation. Each grid is (H + 2) rows of P
// words with zero rows and words around it; CTA blockIdx.x steps band
// blockIdx.x % bands of grid blockIdx.x / bands.
template <int MODE>
__global__ void __launch_bounds__(kGlobalThreads)
ca2d_global_kernel(const uint32_t* __restrict__ cur, uint32_t* __restrict__ nxt,
                   int H, int W, int bands, Rule rule) {
  const int WW = (W + 3) >> 2, P = WW + 2;
  const int band = blockIdx.x % bands;
  const int r0 = band * H / bands, R = (band + 1) * H / bands - r0;
  const size_t off =
      (size_t)(blockIdx.x / bands) * (H + 2) * P + (size_t)(r0 + 1) * P;
  const uint32_t* const c = cur + off;
  uint32_t* const n = nxt + off;
  const int items = WW * ((R + kGlobalRun - 1) / kGlobalRun);
  for (int k = threadIdx.x; k < items; k += kGlobalThreads) {
    const int i = k % WW + 1, y0 = (k / WW) * kGlobalRun;
    walk<MODE, 0>([&](int y) { return c + (long long)y * P; }, i, y0,
                  min(R, y0 + kGlobalRun), rule, col_mask(i, W),
                  [&](int, int y, uint32_t v, uint32_t) {
                    n[(size_t)y * P + i] = v;
                  });
  }
}

// Packs B grids into buffer a (zero rows and words around each) and zeroes
// buffer b.
__global__ void ca2d_pack_kernel(const uint8_t* __restrict__ in,
                                 uint32_t* __restrict__ a,
                                 uint32_t* __restrict__ b, int B, int H,
                                 int W) {
  const int WW = (W + 3) >> 2, P = WW + 2;
  const size_t per = (size_t)(H + 2) * P, total = per * B;
  for (size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x; k < total;
       k += (size_t)gridDim.x * blockDim.x) {
    const size_t gi = k / per, rem = k - gi * per;
    const int y = (int)(rem / P) - 1, i = (int)(rem % P) - 1;
    uint32_t v = 0;
    if (y >= 0 && y < H && i >= 0 && i < WW) {
      const uint8_t* s = in + (gi * H + y) * W + 4 * i;
      const int n = min(4, W - 4 * i);
      for (int j = 0; j < n; ++j) v |= (uint32_t)s[j] << (8 * j);
    }
    a[k] = v;
    b[k] = 0;
  }
}

__global__ void ca2d_unpack_kernel(const uint32_t* __restrict__ a,
                                   uint8_t* __restrict__ out, int B, int H,
                                   int W) {
  const int P = ((W + 3) >> 2) + 2;
  const size_t total = (size_t)B * H * W;
  for (size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x; k < total;
       k += (size_t)gridDim.x * blockDim.x) {
    const size_t gi = k / ((size_t)H * W), rem = k - gi * H * W;
    const int y = (int)(rem / W), x = (int)(rem % W);
    out[k] = (uint8_t)(a[(gi * (H + 2) + y + 1) * P + (x >> 2) + 1] >>
                       (8 * (x & 3)));
  }
}

// The cluster barrier alone: n cluster.sync() in one cluster of cs CTAs of
// kThreads threads (the barrier part of a single grid's generations).
__global__ void __launch_bounds__(kThreads, 1) cluster_sync_probe(int n) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int k = 0; k < n; ++k) cluster.sync();
}

template <typename Kernel>
cudaError_t cluster_config(Kernel k, int cs, int blocks, int smem,
                           cudaStream_t stream, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1);
  if (e != cudaSuccess) return e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int MODE>
int launch_shared(const uint8_t* in, uint8_t* out, int B, int H, int W,
                  int steps, const Rule& r, int inplace, int cs, int run,
                  int smem, cudaStream_t stream) {
  cudaError_t e;
  if (inplace) {
    e = cudaFuncSetAttribute(ca2d_inplace_kernel<MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    ca2d_inplace_kernel<MODE><<<B, kInplaceThreads, smem, stream>>>(
        in, out, H, W, steps, r);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  e = cluster_config(ca2d_cluster_kernel<MODE>, cs, B * cs, smem, stream, &cfg,
                     &attr);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, ca2d_cluster_kernel<MODE>, in, out, H, W, steps,
                         r, run);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_global(const uint8_t* in, uint8_t* out, uint32_t* words, int B,
                  int H, int W, int steps, const Rule& r, int bands,
                  cudaStream_t stream) {
  const size_t plane = (size_t)B * (H + 2) * (((W + 3) >> 2) + 2);
  uint32_t* a = words;
  uint32_t* b = words + plane;
  const size_t want = (plane + 255) / 256;
  const int blocks = (int)(want < 65536 ? want : 65536);
  ca2d_pack_kernel<<<blocks, 256, 0, stream>>>(in, a, b, B, H, W);
  cudaError_t e = cudaGetLastError();
  for (int s = 0; s < steps && e == cudaSuccess; ++s) {
    ca2d_global_kernel<MODE><<<B * bands, kGlobalThreads, 0, stream>>>(
        a, b, H, W, bands, r);
    e = cudaGetLastError();
    uint32_t* t = a;
    a = b;
    b = t;
  }
  if (e != cudaSuccess) return (int)e;
  ca2d_unpack_kernel<<<blocks, 256, 0, stream>>>(a, out, B, H, W);
  return (int)cudaGetLastError();
}

Rule make_rule(unsigned born, unsigned surv, int nr_states, int decay) {
  return Rule{make_table(born), make_table(surv), (uint32_t)nr_states & 0xFFu,
              decay};
}

}  // namespace

// The device's opt-in shared memory per block, or -1 on error.
extern "C" int ca2d_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// cudaOccupancyMaxActiveClusters for clusters of cs cluster-route CTAs with
// smem bytes each on `device`, or minus the CUDA error.
extern "C" int ca2d_active_clusters(int device, int cs, int smem) {
  int prev = 0;
  cudaGetDevice(&prev);
  cudaError_t e = cudaSetDevice(device);
  int n = 0;
  if (e == cudaSuccess) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    e = cluster_config(ca2d_cluster_kernel<kM1>, cs, cs, smem, 0, &cfg,
                       &attr);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(
          &n, (const void*)ca2d_cluster_kernel<kM1>, &cfg);
  }
  cudaGetLastError();
  cudaSetDevice(prev);
  return e == cudaSuccess ? n : -(int)e;
}

// mode: 0 m1, 1 vn1, 2 mv, 3 vnv; inplace 0 is the cluster route with cs
// CTAs per grid. Returns a cudaError_t (0 on success).
extern "C" int ca2d_launch(const uint8_t* in, uint8_t* out, int B, int H,
                           int W, int steps, unsigned born, unsigned surv,
                           int nr_states, int decay, int mode, int inplace,
                           int cs, int run, int smem, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || steps < 0 || cs <= 0 || cs > H ||
      run <= 0 || (inplace && (cs != 1 || (W + 3) / 4 > kInplaceThreads)))
    return (int)cudaErrorInvalidValue;
  const Rule r = make_rule(born, surv, nr_states, decay);
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kM1:
      return launch_shared<kM1>(in, out, B, H, W, steps, r, inplace, cs, run,
                                smem, s);
    case kVN1:
      return launch_shared<kVN1>(in, out, B, H, W, steps, r, inplace, cs, run,
                                 smem, s);
    case kMV:
      return launch_shared<kMV>(in, out, B, H, W, steps, r, inplace, cs, run,
                                smem, s);
    case kVNV:
      return launch_shared<kVNV>(in, out, B, H, W, steps, r, inplace, cs, run,
                                 smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Device-memory route: words is 2 x B x (H + 2) x ((W + 3) / 4 + 2) int32
// of scratch; bands CTAs per grid. Launches steps + 2 kernels.
extern "C" int ca2d_global_launch(const uint8_t* in, uint8_t* out,
                                  uint32_t* words, int B, int H, int W,
                                  int steps, unsigned born, unsigned surv,
                                  int nr_states, int decay, int mode,
                                  int bands, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || steps < 0 || bands <= 0 || bands > H)
    return (int)cudaErrorInvalidValue;
  const Rule r = make_rule(born, surv, nr_states, decay);
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kM1:
      return launch_global<kM1>(in, out, words, B, H, W, steps, r, bands, s);
    case kVN1:
      return launch_global<kVN1>(in, out, words, B, H, W, steps, r, bands, s);
    case kMV:
      return launch_global<kMV>(in, out, words, B, H, W, steps, r, bands, s);
    case kVNV:
      return launch_global<kVNV>(in, out, words, B, H, W, steps, r, bands, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// n cluster barriers in one cluster of cs CTAs (a measurement probe).
extern "C" int ca2d_barrier_probe(int cs, int n, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = cluster_config(cluster_sync_probe, cs, cs, 0,
                                 (cudaStream_t)stream, &cfg, &attr);
  if (e == cudaSuccess) e = cudaLaunchKernelEx(&cfg, cluster_sync_probe, n);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* ca2d_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

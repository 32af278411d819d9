// Fused 2D cellular-automaton kernel for Hopper (sm_90a), bound to Python
// through ctypes.
//
// K3 ca2d_kernel replaces clap_tpu/ops/ca2d.py _ca2d_kernel: `steps`
// synchronous generations of one rule, all in one launch, with the grid
// resident on chip between generations. The plain PyTorch version is
// ca2d_run in clap_tpu_torch/ops/ca2d.py; the kernel reproduces it bit for
// bit (integer arithmetic only).
//
// Layout. One CTA of 1,024 threads per grid (blockIdx.x = env). The grid,
// with a one-cell zero halo on all four sides, sits in dynamic shared
// memory as uint8: row y of the grid is shared row y + 1, pitch W + 2
// (a 256^2 grid is 66,564 bytes). One more row, `saved`, follows it.
//
// A generation walks the grid in strips of `rows` rows, at most
// kThreads * kCells cells each. For one strip every thread computes the
// new values of its (at most kCells) cells into registers; barrier; it
// writes them back; barrier. Rows below the strip are still the old
// generation when the strip reads them; the row above was already
// overwritten, so the writers of each strip's last row first copy its old
// values into `saved`, which the next strip reads in its place. The last
// strip writes zeros there: the halo above row 0 for the next generation.
// So the kernel needs the grid's halo'd bytes plus one row, not two grids.
//
// Neighbourhoods: m1 / vn1 count non-zero neighbours (8 / 4); mv / vnv
// count neighbours greater than the cell (8 / 4). Out-of-range neighbours
// read the zero halo: zero boundary, not torus, and 0 > v is false.
//
// Bounds on this card: the generation loop is bound by instruction issue
// on shared-memory byte loads (9 per cell) and by the 2 barriers per strip
// (8 per generation at 256^2); nothing goes to device memory between the
// load and the final store, which is the point of the TPU kernel. One grid
// uses one SM, so a single grid (the JAX bench's config #1) leaves the
// other SMs idle; batches of grids fill the card. Grids larger than one
// CTA's opt-in shared memory are refused by the wrapper (clusters with
// distributed shared memory are later work).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kCells = 16;   // cells a thread holds in registers per strip

enum Neigh { kM1 = 0, kVN1 = 1, kMV = 2, kVNV = 3 };

// Neighbour count of the cell at column c (halo'd index) whose value is v;
// up / mid / dn are the halo'd rows above, at and below it.
template <int MODE>
__device__ __forceinline__ int neighbours(const uint8_t* up,
                                          const uint8_t* mid,
                                          const uint8_t* dn, int c, int v) {
  if (MODE == kM1 || MODE == kVN1) {
    int n = (up[c] != 0) + (dn[c] != 0) + (mid[c - 1] != 0) +
            (mid[c + 1] != 0);
    if (MODE == kM1)
      n += (up[c - 1] != 0) + (up[c + 1] != 0) + (dn[c - 1] != 0) +
           (dn[c + 1] != 0);
    return n;
  }
  int n = (up[c] > v) + (dn[c] > v) + (mid[c - 1] > v) + (mid[c + 1] > v);
  if (MODE == kMV)
    n += (up[c - 1] > v) + (up[c + 1] > v) + (dn[c - 1] > v) +
         (dn[c + 1] > v);
  return n;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
ca2d_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
            int H, int W, int steps, uint32_t born, uint32_t surv,
            int nr_states, int decay) {
  extern __shared__ uint8_t smem[];
  const int P = W + 2;
  uint8_t* g = smem;                                // (H + 2) x P
  uint8_t* saved = smem + (size_t)(H + 2) * P;      // P bytes
  const int total = (H + 3) * P;
  for (int i = threadIdx.x; i < total; i += kThreads) smem[i] = 0;
  __syncthreads();

  const size_t base = (size_t)blockIdx.x * H * W;
  for (int i = threadIdx.x; i < H * W; i += kThreads) {
    const int y = i / W;
    g[(y + 1) * P + (i - y * W) + 1] = in[base + i];
  }
  __syncthreads();

  // a strip's cell i sits at row i / W, column i % W of the strip; the
  // split is the same for every strip, so each thread keeps it
  const int rows = (kThreads * kCells) / W;
  int at[kCells];
#pragma unroll
  for (int j = 0; j < kCells; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int y = i / W;
    at[j] = (y << 16) | (i - y * W);
  }
  const uint8_t born_v = (uint8_t)nr_states;

  for (int s = 0; s < steps; ++s) {
    for (int r0 = 0; r0 < H; r0 += rows) {
      const int n = (min(H, r0 + rows) - r0) * W;
      uint8_t nv[kCells];
#pragma unroll
      for (int j = 0; j < kCells; ++j) {
        if (threadIdx.x + j * kThreads < n) {
          const int y = r0 + (at[j] >> 16);
          const int c = (at[j] & 0xFFFF) + 1;
          const uint8_t* mid = g + (y + 1) * P;
          const uint8_t* up = (y == r0) ? saved : mid - P;
          const int v = mid[c];
          const int k = neighbours<MODE>(up, mid, mid + P, c, v);
          uint8_t o = (uint8_t)v;
          if (v == 0) {
            if ((born >> k) & 1u) o = born_v;
          } else if (decay && !((surv >> k) & 1u)) {
            o = (uint8_t)(v - 1);
          }
          nv[j] = o;
        }
      }
      __syncthreads();
      const int last_row = min(H, r0 + rows) - 1;
      const bool last_strip = last_row == H - 1;
#pragma unroll
      for (int j = 0; j < kCells; ++j) {
        if (threadIdx.x + j * kThreads < n) {
          const int y = r0 + (at[j] >> 16);
          const int c = (at[j] & 0xFFFF) + 1;
          uint8_t* cell = g + (y + 1) * P + c;
          if (y == last_row) saved[c] = last_strip ? 0 : *cell;
          *cell = nv[j];
        }
      }
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < H * W; i += kThreads) {
    const int y = i / W;
    out[base + i] = g[(y + 1) * P + (i - y * W) + 1];
  }
}

template <int MODE>
int launch(const uint8_t* in, uint8_t* out, int B, int H, int W, int steps,
           uint32_t born, uint32_t surv, int nr_states, int decay,
           cudaStream_t stream) {
  const size_t smem = (size_t)(H + 3) * (W + 2);
  cudaError_t e = cudaFuncSetAttribute(
      ca2d_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  ca2d_kernel<MODE><<<B, kThreads, smem, stream>>>(
      in, out, H, W, steps, born, surv, nr_states, decay);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory one CTA of ca2d_launch needs for an H x W grid.
extern "C" long long ca2d_smem_bytes(int H, int W) {
  return (long long)(H + 3) * (W + 2);
}

// The device's opt-in shared memory per block, or -1 on error.
extern "C" int ca2d_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// mode: 0 m1, 1 vn1, 2 mv, 3 vnv. Returns a cudaError_t (0 on success).
extern "C" int ca2d_launch(const uint8_t* in, uint8_t* out, int B, int H,
                           int W, int steps, unsigned int born,
                           unsigned int surv, int nr_states, int decay,
                           int mode, void* stream) {
  if (B == 0) return 0;
  if (H <= 0 || W <= 0 || W > kThreads * kCells || W > 0xFFFF || steps < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kM1:
      return launch<kM1>(in, out, B, H, W, steps, born, surv, nr_states,
                         decay, s);
    case kVN1:
      return launch<kVN1>(in, out, B, H, W, steps, born, surv, nr_states,
                          decay, s);
    case kMV:
      return launch<kMV>(in, out, B, H, W, steps, born, surv, nr_states,
                         decay, s);
    case kVNV:
      return launch<kVNV>(in, out, B, H, W, steps, born, surv, nr_states,
                          decay, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

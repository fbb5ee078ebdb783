// Kernel K1: connected-component labelling of the range-image seed mask.
//
// Replaces: legoloam_tpu/ops/ccl_pallas.py::_ccl_kernel (wrapper
// label_propagation_pallas), which sweeps segmented min-scans over the
// (N, H) label grid held in TPU VMEM until a fixpoint.
//
// Output (see legoloam_tpu_torch/ops/ccl_cuda.py): per cell the component's
// minimum flat index within its scan's image (non-seeds: N*H), its minimum
// ring (label / H) and its maximum ring (non-seeds: -1).  These values are
// fully determined by the partition, so any correct labelling gives
// bit-identical output.  A batch of B scans (B x N x H, scan-major) is one
// launch of each kernel below: the scans' images are disjoint arrays, each
// addressed by its scan's offset, so no component crosses a scan and a scan
// computes what it computes alone.  The batch is what fills the card: one
// VLP-16 scan gives the local pass 29 blocks and the seam pass one, of the
// H100's 132 SMs (the JAX package's vmap adds the same leading grid axis).
//
// What bounds it on the H100: latency.  A VLP-16 scan is 28.8K cells; the
// inputs are ~86 KB of masks and the outputs 346 KB of int32 planes, well
// under a microsecond of HBM time at 3.35 TB/s, so the time is launch
// latency plus the dependent pointer chases of the union-find; the design
// keeps those chases short and mostly in shared memory.
//
// Design: a block-tiled union-find (Playne & Hawick 2018; Allegretti et al.
// 2019).  Every link points a larger root at a smaller one (atomicMin), so
// parents only decrease and each root is its tree's minimum index; any
// ancestor may then replace a parent (path compression) without a race
// breaking the forest.  Three launches:
//   ccl_local   one block per tile of all N rings x W columns and scan (W a
//               multiple of 32, chosen in ccl_launch; VLP-16: 16 x 64 =
//               1024 cells, one thread each).  In shared memory: each
//               32-column row segment points every cell at its run's start
//               (one __ballot_sync, so no chain grows along a run), then
//               the remaining right and down links of the tile are united,
//               every cell is compressed onto its root, and each root takes
//               the component's ring maximum (atomicMax).  Writes every
//               seed cell's global parent (its tile root) and the tile
//               component's ring maximum.
//   ccl_seams   one block a scan: unites across the tile seams, the column-wrap
//               seam included, in global memory; then every cell of a
//               linked seam folds its tile component's ring maximum into the
//               global root and points its tile root at the global root.  A
//               tile component that joins another has such a cell, so
//               every root ends with its component's ring maximum, and
//               a cell is a few links at most from its root.
//   ccl_resolve one thread per cell of the batch: root, ring minimum, ring
//               maximum.

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace {

constexpr int kMinTileW = 64;  // columns per tile, at least
constexpr int kLocalThreads = 1024;  // at most; one per cell up to 1024
constexpr int kSeamThreads = 1024;
constexpr int kThreads = 256;

__device__ __forceinline__ int find_root(const volatile int* parent, int x) {
  int p = parent[x];
  while (p != x) {
    x = p;
    p = parent[x];
  }
  return x;
}

// find_root with path halving: each visited cell is pointed at its
// grandparent (atomicMin, so parents still only decrease).  A node that is
// not a root never becomes one again, so this never undoes a link.
__device__ __forceinline__ int find_halve(int* parent, int x) {
  const volatile int* vp = parent;
  int p = vp[x];
  while (p != x) {
    const int gp = vp[p];
    if (gp != p) atomicMin(parent + x, gp);
    x = gp;
    p = vp[x];
  }
  return x;
}

// Link the trees of a and b: the larger root is pointed at the smaller one.
__device__ void unite(int* parent, int a, int b) {
  while (true) {
    a = find_halve(parent, a);
    b = find_halve(parent, b);
    if (a == b) return;
    if (a < b) {
      int t = a;
      a = b;
      b = t;
    }
    int old = atomicMin(parent + a, b);
    if (old == a) return;  // a was still a root and now hangs under b
    a = old;               // a was linked meanwhile: retry from its parent
  }
}

__global__ void __launch_bounds__(kLocalThreads)
    ccl_local(const uint8_t* __restrict__ seed,
              const uint8_t* __restrict__ conn_h,
              const uint8_t* __restrict__ conn_v, int* __restrict__ parent,
              int* __restrict__ rmax, int n, int h, int w) {
  // This block's scan: every array below is that scan's image.
  const size_t scan = static_cast<size_t>(blockIdx.y) * n * h;
  seed += scan;
  conn_h += scan;
  conn_v += static_cast<size_t>(blockIdx.y) * (n - 1) * h;
  parent += scan;
  rmax += scan;
  extern __shared__ int smem[];
  int* sp = smem;          // tile-local parents, index r * w + j
  int* srm = smem + n * w;  // ring maximum at each tile root
  volatile int* vsp = sp;
  const int c0 = blockIdx.x * w;
  const int tw = min(w, h - c0);
  const int cells = n * w;
  const int lane = threadIdx.x % 32;

  for (int l = threadIdx.x; l < cells; l += blockDim.x) srm[l] = -1;
  // Runs of each 32-column row segment: every cell points at its run's
  // first cell.
  for (int l = threadIdx.x; l < cells; l += blockDim.x) {
    const int r = l / w, j = l - (l / w) * w;
    const int g = r * h + c0 + j;
    const bool s = j < tw && seed[g];
    const bool link = s && lane > 0 && seed[g - 1] && conn_h[g - 1];
    const unsigned zeros = ~__ballot_sync(0xffffffffu, link) &
                           ((2u << lane) - 1u);
    sp[l] = l - lane + (31 - __clz(zeros));
  }
  __syncthreads();
  for (int l = threadIdx.x; l < cells; l += blockDim.x) {
    const int r = l / w, j = l - (l / w) * w;
    const int g = r * h + c0 + j;
    if (j >= tw || !seed[g]) continue;
    if (lane == 31 && j + 1 < tw && conn_h[g] && seed[g + 1])
      unite(sp, l, l + 1);
    if (r + 1 < n && conn_v[g] && seed[g + h]) unite(sp, l, l + w);
  }
  __syncthreads();
  for (int l = threadIdx.x; l < cells; l += blockDim.x) {
    const int r = l / w, j = l - (l / w) * w;
    if (j >= tw || !seed[r * h + c0 + j]) continue;
    const int root = find_root(vsp, l);
    vsp[l] = root;
    atomicMax(srm + root, r);
  }
  __syncthreads();
  for (int l = threadIdx.x; l < cells; l += blockDim.x) {
    const int r = l / w, j = l - (l / w) * w;
    const int g = r * h + c0 + j;
    if (j >= tw || !seed[g]) continue;
    const int root = sp[l];
    parent[g] = (root / w) * h + c0 + root % w;
    rmax[g] = srm[root];
  }
}

// The seam between tile t's last column and the next tile's first (with
// wrap) in ring r: its two cells, and whether they are linked.
__device__ __forceinline__ bool seam(const uint8_t* seed,
                                     const uint8_t* conn_h, int r, int t,
                                     int h, int w, int* a, int* b) {
  const int cl = min((t + 1) * w, h) - 1;
  *a = r * h + cl;
  *b = r * h + (cl + 1 == h ? 0 : cl + 1);
  return seed[*a] && seed[*b] && conn_h[*a];
}

__global__ void __launch_bounds__(kSeamThreads)
    ccl_seams(const uint8_t* __restrict__ seed,
              const uint8_t* __restrict__ conn_h, int* parent, int* rmax,
              int n, int h, int w) {
  const size_t scan = static_cast<size_t>(blockIdx.x) * n * h;
  seed += scan;
  conn_h += scan;
  parent += scan;
  rmax += scan;
  const int n_tiles = (h + w - 1) / w;
  volatile int* vp = parent;
  for (int s = threadIdx.x; s < n * n_tiles; s += kSeamThreads) {
    const int r = s / n_tiles, t = s - r * n_tiles;
    int a, b;
    if (seam(seed, conn_h, r, t, h, w, &a, &b)) unite(parent, a, b);
  }
  __syncthreads();
  // Every tile component that was joined has a cell on a linked seam: fold
  // its ring maximum into the root, and point its tile root at the root.
  for (int s = threadIdx.x; s < 2 * n * n_tiles; s += kSeamThreads) {
    const int r = (s >> 1) / n_tiles, t = (s >> 1) - r * n_tiles;
    int a, b;
    if (!seam(seed, conn_h, r, t, h, w, &a, &b)) continue;
    const int x = s & 1 ? b : a;
    const int root = find_root(vp, x);
    atomicMax(rmax + root, rmax[x]);
    const int tile_root = vp[x];
    if (tile_root != root) vp[tile_root] = root;
    if (x != root) vp[x] = root;
  }
}

__global__ void ccl_resolve(const uint8_t* __restrict__ seed,
                            const int* __restrict__ parent,
                            const int* __restrict__ rmax, int* labels,
                            int* ring_min, int* ring_max, int n_cells,
                            int h, size_t total) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const size_t scan = i / n_cells * n_cells;  // the cell's scan's offset
  if (!seed[i]) {
    labels[i] = n_cells;
    ring_min[i] = n_cells / h;
    ring_max[i] = -1;
    return;
  }
  const int root = find_root(parent + scan, static_cast<int>(i - scan));
  labels[i] = root;
  ring_min[i] = root / h;
  ring_max[i] = rmax[scan + root];
}

}  // namespace

extern "C" int ccl_launch(const void* seed, const void* conn_h,
                          const void* conn_v, void* parent, void* labels,
                          void* ring_min, void* ring_max, void* rmax_root,
                          int b, int n, int h, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Tiles of at least kMinTileW columns, W a multiple of 32; tall sensors
  // take wider tiles so that the one-block seam pass runs at most two rounds
  // of kSeamThreads seams.  VLP-16 and HDL-32E get W = 64, VLS-128 W = 128.
  const int w_seams = ((h * n + 2 * kSeamThreads - 1) / (2 * kSeamThreads)
                       + 31) / 32 * 32;
  const int w = max(kMinTileW, w_seams);
  const int n_tiles = (h + w - 1) / w;
  const int n_cells = n * h;
  const size_t smem = 2 * static_cast<size_t>(n) * w * sizeof(int);
  if (n < 1 || h < 1 || b < 0 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  if (smem > 48 * 1024) {
    cudaError_t e = raise_smem_limit(
        reinterpret_cast<const void*>(ccl_local), static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const auto* sd = static_cast<const uint8_t*>(seed);
  const auto* ch = static_cast<const uint8_t*>(conn_h);
  int* par = static_cast<int*>(parent);
  int* rmx = static_cast<int*>(rmax_root);
  const size_t total = static_cast<size_t>(b) * n_cells;
  ccl_local<<<dim3(n_tiles, b), min(kLocalThreads, n * w), smem, s>>>(
      sd, ch, static_cast<const uint8_t*>(conn_v), par, rmx, n, h, w);
  ccl_seams<<<b, kSeamThreads, 0, s>>>(sd, ch, par, rmx, n, h, w);
  ccl_resolve<<<static_cast<unsigned>((total + kThreads - 1) / kThreads),
                kThreads, 0, s>>>(
      sd, par, rmx, static_cast<int*>(labels), static_cast<int*>(ring_min),
      static_cast<int*>(ring_max), n_cells, h, total);
  return static_cast<int>(cudaGetLastError());
}

// Kernel K1: connected-component labelling of the range-image seed mask.
//
// Replaces: legoloam_tpu/ops/ccl_pallas.py::_ccl_kernel (wrapper
// label_propagation_pallas), which sweeps segmented min-scans over the
// (N, H) label grid held in TPU VMEM until a fixpoint.
//
// Output (see legoloam_tpu_torch/ops/ccl_cuda.py): per cell the component's
// minimum flat index (non-seeds: N*H), its minimum ring (label / H) and its
// maximum ring (non-seeds: -1).  These values are fully determined by the
// partition, so any correct labelling gives bit-identical output.
//
// What bounds it on the H100: latency.  A VLP-16 scan is 28.8K cells; the
// inputs are ~115 KB of masks and the outputs 346 KB of int32 planes, well
// under a microsecond of HBM time at 3.35 TB/s, so the time is launch
// latency plus the dependent pointer chases of the union-find through L2.
//
// Design: a GPU union-find (Playne & Hawick 2018 / Komura 2015) instead of
// the TPU's label sweeps.  Sweeps cost one pass per bend of a component's
// min-label path and need a fixpoint test; union-find links every connected
// pair once with atomicMin on the larger root, so the root of each tree is
// always its minimum index and the result is exact after one pass,
// whatever the component's shape.  Four short kernels, each one thread per
// cell over the whole card: init, merge (union along the right neighbour —
// with column wrap — and the lower neighbour), resolve (path walk to the
// root + atomicMax of the ring into the root's slot), finalize (read the
// root's ring maximum back).  The parent plane and ring-max plane stay in
// device memory (230 KB for VLP-16 — over a block's 227 KB of shared
// memory, but resident in the 50 MB L2).
//
// One intended difference from the JAX path: the JAX sweeps stop after
// ccl_max_iters (32) sweeps; union-find always reaches the fixpoint.  The
// two agree whenever the sweeps converged (<= 6 on real scans).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int find_root(const volatile int* parent, int x) {
  int p = parent[x];
  while (p != x) {
    x = p;
    p = parent[x];
  }
  return x;
}

// Link the trees of a and b: the larger root is pointed at the smaller one.
// Parents only ever decrease, so every root is its tree's minimum index.
__device__ void unite(int* parent, int a, int b) {
  const volatile int* vp = parent;
  while (true) {
    a = find_root(vp, a);
    b = find_root(vp, b);
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

__global__ void ccl_init(int* parent, int* rmax_root, int n_cells) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_cells) return;
  parent[i] = i;
  rmax_root[i] = -1;
}

__global__ void ccl_merge(const uint8_t* seed, const uint8_t* conn_h,
                          const uint8_t* conn_v, int* parent, int n, int h) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * h || !seed[i]) return;
  int r = i / h;
  int c = i - r * h;
  int right = r * h + (c + 1 == h ? 0 : c + 1);
  if (conn_h[i] && seed[right]) unite(parent, i, right);
  if (r + 1 < n && conn_v[i] && seed[i + h]) unite(parent, i, i + h);
}

__global__ void ccl_resolve(const uint8_t* seed, const int* parent,
                            int* labels, int* rmax_root, int n_cells, int h) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_cells) return;
  if (!seed[i]) {
    labels[i] = n_cells;
    return;
  }
  int root = find_root(parent, i);
  labels[i] = root;
  atomicMax(rmax_root + root, i / h);
}

__global__ void ccl_finalize(const int* labels, const int* rmax_root,
                             int* ring_min, int* ring_max, int n_cells,
                             int h) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_cells) return;
  int l = labels[i];
  ring_min[i] = l / h;
  ring_max[i] = l < n_cells ? rmax_root[l] : -1;
}

}  // namespace

extern "C" int ccl_launch(const void* seed, const void* conn_h,
                          const void* conn_v, void* parent, void* labels,
                          void* ring_min, void* ring_max, void* rmax_root,
                          int n, int h, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int n_cells = n * h;
  int blocks = (n_cells + kThreads - 1) / kThreads;
  int* par = static_cast<int*>(parent);
  int* rmx = static_cast<int*>(rmax_root);
  int* lab = static_cast<int*>(labels);
  ccl_init<<<blocks, kThreads, 0, s>>>(par, rmx, n_cells);
  ccl_merge<<<blocks, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(seed), static_cast<const uint8_t*>(conn_h),
      static_cast<const uint8_t*>(conn_v), par, n, h);
  ccl_resolve<<<blocks, kThreads, 0, s>>>(static_cast<const uint8_t*>(seed),
                                          par, lab, rmx, n_cells, h);
  ccl_finalize<<<blocks, kThreads, 0, s>>>(lab, rmx,
                                           static_cast<int*>(ring_min),
                                           static_cast<int*>(ring_max),
                                           n_cells, h);
  return static_cast<int>(cudaGetLastError());
}

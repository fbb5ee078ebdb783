// Kernel K5: the pose graph's link-axis prefix sum.
//
// Replaces no Pallas kernel.  The JAX package's link-space solver takes
// jnp.cumsum over the (M, 6) link array (legoloam_tpu/models/posegraph.py:
// 220, 230, 270), and the port carried that over as torch.cumsum(., dim=0)
// (models/posegraph.py): once a CG iteration (the loop terms' range sums)
// and once a GN step (links to nodes).  On the card that is PyTorch's
// outer-dimension scan, one thread a column walking all M rows with a
// dependent global load and store a row: ~0.5 ms at M = 4096, whatever the
// number of filled nodes.
//
// Contract (legoloam_tpu_torch/ops/link_scan_cuda.py): bitwise the plain
// lines on the card.  With n the node count read from device memory and
// clamped to [0, M], and Q[m, c] = ((0 + v[0, c]) + v[1, c]) + ... + v[m, c]
// summed in float32 in row order from 0.0f (CUDA torch.cumsum's order, so a
// leading -0.0 becomes +0.0):
//   link_scan_rows    out[m, c] = Q[m, c] for m < n, 0.0f for m >= n
//                     (where(ok, cumsum(where(ok, v, 0)), 0));
//   link_scan_ranges  S[l, c] = P[hi[l], c] - P[lo[l], c], where P is the
//                     plain scan of where(ok, v, 0) over all M rows: Q for
//                     rows below n, and for rows from n on Q[n-1, c] + 0.0f
//                     (0.0f when n = 0), since adding 0.0f again changes
//                     nothing.  An endpoint outside [0, n) reads that tail.
//                     The gathers and the subtraction are the plain lines'
//                     Qv[hi] - Qv[lo].
// The sums are plain adds (nothing for -fmad to contract).  A tree or
// look-back scan would be faster but regroups the adds, and so the
// roundings: the order is the contract.
//
// What bounds it on the H100: the serial chain of dependent adds, one a row
// in each column (~3.4 ns a row measured: 5.6 us at 800 rows, 15 us at
// 4096), not the bytes (n x 24 in, M x 24 or L x 40 out), well under a
// microsecond at 3.35 TB/s.
//
// Design.  One CTA of kThreads threads.  Rows below n stream through shared
// memory in tiles of kTile rows, each tile stored column by column (a pitch
// of kPitch floats, so the six columns fall in distinct banks), three
// buffers.  While lanes 0..kCols-1 of warp 0 each sum their column of tile
// k in row order, in place (float4 loads and stores, four rows a load, the
// next kGroup rows loaded while the current ones are added, so the add is
// the only dependency), the other warps write tile k - 1's running sums to
// global memory with coalesced stores and stage tile k + 1 with coalesced
// loads.  No row at or past n is read; the last tile is padded with zeros
// to a whole group, which leaves every running sum below n as it is and
// the final sum as the tail (adding 0.0f twice is adding it once).  The
// ranges entry then reads its endpoints' running sums back (after the
// block's barrier, which makes the stores visible to the block) and
// subtracts.  One algorithm for any M: the store size only sets the number
// of tiles.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 6;                  // a link's twist
constexpr int kThreads = 512;
constexpr int kTile = 512;                // rows a tile
constexpr int kPitch = kTile + 4;         // floats a column of a tile
constexpr int kGroup = 16;                // rows a scan lane loads ahead
constexpr int kBufs = 3;
constexpr int kStagers = kThreads - 32;   // warps 1.. copy out and stage
// Loads a staging thread issues before it stores any: all of a tile's
// floats, whether the whole block stages (the first tile) or warps 1.. do.
constexpr int kStageLoads = (kTile * kCols + kStagers - 1) / kStagers;

static_assert(kTile % kGroup == 0 && kGroup % 4 == 0 && kPitch % 4 == 0,
              "float4 groups inside a column");

struct __align__(16) Tile {
  float col[kCols][kPitch];
};

__device__ __forceinline__ int node_count(const int* n_ptr, int m_rows) {
  const int n = *n_ptr;
  return n < 0 ? 0 : (n > m_rows ? m_rows : n);
}

// Rows [r0, r0 + rows) of v into tile t, column by column, by the threads
// numbered `first` with `stride` between them, each thread's loads all in
// flight before its first store; the rows from `rows` up to a whole group
// set to 0.0f.
__device__ __forceinline__ void stage(const float* __restrict__ v, Tile& t,
                                      int r0, int rows, int first,
                                      int stride) {
  const float* src = v + static_cast<size_t>(r0) * kCols;
  const int total = rows * kCols;
  float x[kStageLoads];
#pragma unroll
  for (int j = 0; j < kStageLoads; ++j) {
    const int i = first + j * stride;
    x[j] = i < total ? src[i] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kStageLoads; ++j) {
    const int i = first + j * stride;
    if (i < total) t.col[i % kCols][i / kCols] = x[j];
  }
  const int pad = ((rows + kGroup - 1) / kGroup * kGroup - rows) * kCols;
  for (int i = first; i < pad; i += stride)
    t.col[i % kCols][rows + i / kCols] = 0.0f;
}

// Rows [0, rows) of tile t to q (row r0 on), row-major, coalesced.
__device__ __forceinline__ void copy_out(const Tile& t, float* q, int r0,
                                         int rows, int first, int stride) {
  float* dst = q + static_cast<size_t>(r0) * kCols;
  for (int i = first; i < rows * kCols; i += stride)
    dst[i] = t.col[i % kCols][i / kCols];
}

// One column of a tile (rows padded to whole groups) added to acc one row
// at a time, each running sum written back in place.
__device__ __forceinline__ float scan_column(float* col, int rows,
                                             float acc) {
  float4* p = reinterpret_cast<float4*>(col);
  constexpr int kVecs = kGroup / 4;
  constexpr int kLast = kTile / kGroup - 1;
  const int groups = (rows + kGroup - 1) / kGroup;
  float4 cur[kVecs], nxt[kVecs];
#pragma unroll
  for (int u = 0; u < kVecs; ++u) cur[u] = p[u];
  for (int g = 0; g < groups; ++g) {
    const int ahead = min(g + 1, kLast);
#pragma unroll
    for (int u = 0; u < kVecs; ++u) nxt[u] = p[ahead * kVecs + u];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      float4 s;
      s.x = acc = __fadd_rn(acc, cur[u].x);
      s.y = acc = __fadd_rn(acc, cur[u].y);
      s.z = acc = __fadd_rn(acc, cur[u].z);
      s.w = acc = __fadd_rn(acc, cur[u].w);
      p[g * kVecs + u] = s;
      cur[u] = nxt[u];
    }
  }
  return acc;
}

// The running column sums of rows [0, n) of v, in row order from 0.0f,
// into q (n x kCols, row-major).  Returns each scan lane's (thread
// c < kCols) final sum: the sum of all n rows, plus 0.0f where the last
// tile was padded; 0.0f in the other threads.  Ends on a block barrier.
__device__ float scan_rows(const float* __restrict__ v, float* q, int n,
                           Tile* bufs) {
  const int t = threadIdx.x;
  float acc = 0.0f;
  const int tiles = (n + kTile - 1) / kTile;
  if (tiles > 0) stage(v, bufs[0], 0, min(n, kTile), t, kThreads);
  __syncthreads();
  for (int k = 0; k < tiles; ++k) {
    if (t < kCols) {
      acc = scan_column(bufs[k % kBufs].col[t], min(n - k * kTile, kTile),
                        acc);
    } else if (t >= 32) {
      if (k >= 1)
        copy_out(bufs[(k - 1) % kBufs], q, (k - 1) * kTile, kTile, t - 32,
                 kStagers);
      if (k + 1 < tiles)
        stage(v, bufs[(k + 1) % kBufs], (k + 1) * kTile,
              min(n - (k + 1) * kTile, kTile), t - 32, kStagers);
    }
    __syncthreads();
  }
  if (tiles > 0)
    copy_out(bufs[(tiles - 1) % kBufs], q, (tiles - 1) * kTile,
             n - (tiles - 1) * kTile, t, kThreads);
  __syncthreads();
  return acc;
}

__global__ void __launch_bounds__(kThreads)
    link_scan_rows(const float* __restrict__ v, const int* __restrict__ n_ptr,
                   float* out, int m_rows) {
  __shared__ Tile bufs[kBufs];
  const int n = node_count(n_ptr, m_rows);
  for (int i = n * kCols + static_cast<int>(threadIdx.x); i < m_rows * kCols;
       i += kThreads)
    out[i] = 0.0f;
  scan_rows(v, out, n, bufs);
}

__global__ void __launch_bounds__(kThreads)
    link_scan_ranges(const float* __restrict__ v,
                     const int* __restrict__ n_ptr,
                     const int64_t* __restrict__ lo,
                     const int64_t* __restrict__ hi, float* q,
                     float* __restrict__ out, int m_rows, int l_n) {
  __shared__ Tile bufs[kBufs];
  __shared__ float tail[kCols];
  const int n = node_count(n_ptr, m_rows);
  const float acc = scan_rows(v, q, n, bufs);
  if (threadIdx.x < kCols) tail[threadIdx.x] = __fadd_rn(acc, 0.0f);
  __syncthreads();
  const uint64_t un = static_cast<uint64_t>(n);
#pragma unroll 4
  for (int i = threadIdx.x; i < l_n * kCols; i += kThreads) {
    const int l = i / kCols;
    const int c = i - l * kCols;
    const uint64_t a = static_cast<uint64_t>(hi[l]);
    const uint64_t b = static_cast<uint64_t>(lo[l]);
    const float qa = a < un ? q[a * kCols + c] : tail[c];
    const float qb = b < un ? q[b * kCols + c] : tail[c];
    out[i] = __fsub_rn(qa, qb);
  }
}

bool shape_ok(int m_rows, long long l_n) {
  return m_rows >= 1 && static_cast<long long>(m_rows) * kCols <= 0x7fffffffll &&
         l_n >= 1 && l_n * kCols <= 0x7fffffffll;
}

}  // namespace

extern "C" int link_scan_rows_launch(const void* v, const void* n, void* out,
                                     int m_rows, void* stream) {
  if (!shape_ok(m_rows, 1)) return static_cast<int>(cudaErrorInvalidValue);
  link_scan_rows<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const int*>(n),
      static_cast<float*>(out), m_rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int link_scan_ranges_launch(const void* v, const void* n,
                                       const void* lo, const void* hi,
                                       void* q, void* out, int m_rows,
                                       int l_n, void* stream) {
  if (!shape_ok(m_rows, l_n)) return static_cast<int>(cudaErrorInvalidValue);
  link_scan_ranges<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const int*>(n),
      static_cast<const int64_t*>(lo), static_cast<const int64_t*>(hi),
      static_cast<float*>(q), static_cast<float*>(out), m_rows, l_n);
  return static_cast<int>(cudaGetLastError());
}

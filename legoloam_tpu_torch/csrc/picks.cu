// Kernel K2: curvature, occlusion marks and sectioned greedy feature picks.
//
// Replaces: legoloam_tpu/ops/features_pallas.py::_pick_kernel (wrapper
// pick_labels_pallas), which runs the same trips over section-major
// (6*N, 1920) lane grids held in TPU VMEM.
//
// Input, per ring of the compacted layout (legoloam_tpu_torch/ops/
// features.py): ranges (0 beyond the ring's count), original columns,
// ground flags, the count (0 <= count <= H).  Output: int32 labels
// 2 sharp / 1 less-sharp / -1 flat / 0 (featureAssociation.cpp:621-784),
// equal bit for bit to features_cuda.pick_labels_plain.
//
// What bounds it on the H100: latency, not bytes.  A VLP-16 scan is 28.8K
// cells in and 28.8K labels out, ~0.4 MB (~0.1 us of HBM time); the work is
// 28 greedy trips in sequence (20 edge + 8 surf at DEFAULT), each a
// reduction per section and an exchange between sections, so the time is
// the chain of dependent steps in one block, trip after trip (chip_smoke's
// "[picks] ... by greedy trips" line splits the prologue from the trips).
//
// Design: one block per ring, max(sections, 16) warps; a batch of B scans
// (B x N rings, scan-major) is one launch on a grid of (N, B) blocks, each
// ring of each scan on its own, so a scan's labels are its labels alone.
// One VLP-16 scan gives 16 blocks for the H100's 132 SMs: the batch (the
// JAX package's vmap adds the same leading grid axis) is what fills it.
//   * Prologue, all warps.  The row goes to shared memory (16-byte vector
//     loads where the shapes allow; ranges padded with zeros, so no
//     neighbour read is bounds-checked).  Pass 2 computes curvature in the
//     plain version's order (acc = -2*halfwin*r; acc += r[i+k];
//     acc += r[i-k]) with round-to-nearest intrinsics (the library is built
//     with -fmad=false, so every float matches the plain version), each
//     cell's ordered key, and four bit masks by warp ballot: occlusion of
//     self and next, parallel beam, column gap.  Pass 3 kills the keys the
//     occlusion and parallel marks cover (windows of the masks by funnel
//     shifts) and stores each candidate's suppression reach: the steps
//     <= halfwin to the left and right before a column gap > col_gap (clz
//     and ffs of the gap mask), so the plain version's +-halfwin chain
//     becomes one interval [q - reachL, q + reachR].
//   * Ordered key: curvature = acc*acc is >= 0 and never -0, so its float
//     bits order like the floats.  An edge candidate's key is its bits, a
//     surf candidate's is ~bits (negative: the lowest curvature is the
//     largest key), every other cell's INT_MIN.  Both phases are then "take
//     the largest key, ties to the lowest index"; a cell is never eligible
//     for both phases (edge needs !ground, surf needs ground).
//   * Register slabs: warp j holds section j, lane l the keys of cells
//     sp + l + 32m (M keys a lane, a compile-time count chosen at launch).
//   * A trip: each lane's best key and slot by a max tree (ties to the lower
//     slot), __reduce_max_sync over the keys, __reduce_min_sync over the
//     indices of the lanes holding the best.  Lane 0 writes the label and
//     publishes the pick's interval in a slot double-buffered by trip
//     parity; the warp applies its own interval at once.  One named
//     barrier over the section warps; then lane j reads section j's slot
//     and the warp applies the other intervals that overlap its section
//     (only neighbours' can, unless a section is shorter than halfwin; any
//     that overlaps is applied).  All sections pick from the state before
//     the trip, as the plain version's dense trips do.  A warp whose slab
//     did not change keeps its best key and skips the reductions.
//   * Edge picks and their suppression gate the surf trips through the same
//     keys; at the phase switch the remaining edge keys are killed.
//   * Labels go out once, after the trips: one coalesced int32 row.
//   * A slab too large for registers at the launch's block shape (e.g.
//     sections = 1 at H = 1800, 1789 cells) runs the same trips on the keys
//     in shared memory (template M = 0), one section per warp.
//
// Shared memory: 16 bytes a cell plus the range padding (29 KB at
// H = 1800); above 48 KB (H > ~3000) the launch raises the limit.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace {

constexpr int kColFill = 1000000;  // column value beyond the ring (as JAX)
constexpr int kDead = INT_MIN;     // key of a cell that can no longer be picked
constexpr unsigned kFull = 0xffffffffu;
// A published interval with no pick: lo > hi, and far enough from every
// index that no arithmetic on it overflows.
constexpr int kFar = 1 << 28;

struct Params {
  int h, sections, halfwin, edge_trips, edge_sharp, surf_trips;
  float edge_thr, surf_thr;
  int col_gap;
  float range_jump, parallel_frac;
  int pad;   // zero ranges on each side of the row (>= halfwin, >= 1, % 4)
  int vec;   // rows are 16-byte aligned: vector loads and stores
};

__host__ __device__ inline int align16(int bytes) { return (bytes + 15) & ~15; }

// Byte offsets of the dynamic shared arrays.  Bit masks hold one padding
// word before and after the ring's ceil(h/32) words.
struct Layout {
  int rng, col, key, words, reach, ground, label, slots, total, nwords;
  __host__ __device__ Layout(int h, int pad) {
    nwords = (h + 31) / 32 + 2;
    rng = 0;
    col = rng + align16((h + 2 * pad) * 4);
    key = col + align16(h * 4);
    words = key + align16(h * 4);
    reach = words + align16(4 * nwords * 4);
    ground = reach + align16(h * 2);
    label = ground + align16(h);
    slots = label + align16(h);
    total = slots + 2 * 32 * 8;
  }
};

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// Bits [j, j + 32) of a ring bit mask, -32 <= j < h.
__device__ __forceinline__ uint32_t window32(const uint32_t* w, int j) {
  const int k = (j >> 5) + 1;
  return __funnelshift_r(w[k], w[k + 1], j & 31);
}

// Steps (<= lim) to the right of q before a gap: cell q + m is suppressed
// with q iff gap[q .. q+m-1] are all clear.  One window when lim <= 32.
__device__ __forceinline__ int reach_right(const uint32_t* gap, int q,
                                           int lim) {
  int m = 0;
  uint32_t w = window32(gap, q);
  while (!w && m + 32 < lim) {
    m += 32;
    w = window32(gap, q + m);
  }
  return min(w ? m + __ffs(w) - 1 : m + 32, lim);
}

// Steps (<= lim) to the left: cell q - m iff gap[q-m .. q-1] are clear.
__device__ __forceinline__ int reach_left(const uint32_t* gap, int q,
                                          int lim) {
  int m = 0;
  uint32_t w = window32(gap, q - 32);
  while (!w && m + 32 < lim) {
    m += 32;
    w = window32(gap, q - m - 32);
  }
  return min(w ? m + __clz(w) : m + 32, lim);
}

// A lane's cells first + 32m, by slot m.
//
// Register slab: M keys a lane; the best key and its slot by a pairwise
// tree (ties to the left, the lower index), depth log2(M) instead of M.
template <int M>
struct Slab {
  int v[M];
  __device__ __forceinline__ Slab(int*, int) {}
  __device__ __forceinline__ int n() const { return M; }
  __device__ __forceinline__ int key(int m) const { return v[m]; }
  __device__ __forceinline__ void kill(int m) { v[m] = kDead; }
  __device__ __forceinline__ void set(int m, int k) { v[m] = k; }
  __device__ __forceinline__ void best(int& bk, int& bm) const {
    int k[M], c[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      k[m] = v[m];
      c[m] = m;
    }
#pragma unroll
    for (int step = 1; step < M; step *= 2) {
#pragma unroll
      for (int m = 0; m + step < M; m += 2 * step) {
        if (k[m + step] > k[m]) {
          k[m] = k[m + step];
          c[m] = c[m + step];
        }
      }
    }
    bk = k[0];
    bm = c[0];
  }
};

// Shared-memory slab: the same cells in the ring's key array (each warp
// touches only its own section's cells); a linear scan.
template <>
struct Slab<0> {
  int* v;
  int cnt;
  __device__ __forceinline__ Slab(int* v_, int cnt_) : v(v_), cnt(cnt_) {}
  __device__ __forceinline__ int n() const { return cnt; }
  __device__ __forceinline__ int key(int m) const { return v[32 * m]; }
  __device__ __forceinline__ void kill(int m) { v[32 * m] = kDead; }
  __device__ __forceinline__ void best(int& bk, int& bm) const {
    bk = kDead;
    bm = 0;
    for (int m = 0; m < cnt; ++m) {
      const int x = v[32 * m];
      if (x > bk) {
        bk = x;
        bm = m;
      }
    }
  }
};

// Kill this lane's cells inside the interval [lo, hi].
template <int M>
__device__ __forceinline__ void suppress(Slab<M>& sl, int first, int lo,
                                         int hi) {
  const unsigned span = static_cast<unsigned>(hi - lo);
  const unsigned off = static_cast<unsigned>(first - lo);
#pragma unroll
  for (int m = 0; m < sl.n(); ++m)
    if (off + 32u * m <= span) sl.kill(m);
}

// Up to 8 cells a lane (and the shared slab) fit 32 warps of 64 registers;
// larger slabs are built for 16 warps (picks_launch reads the limit back).
template <int M>
__global__ void __launch_bounds__(M <= 8 ? 1024 : 512)
picks_kernel(const float* __restrict__ rng_in, const int* __restrict__ col_in,
             const uint8_t* __restrict__ ground_in,
             const int* __restrict__ count_in, int* __restrict__ label_out,
             Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = p.h;
  const Layout lay(h, p.pad);
  float* rngp = reinterpret_cast<float*>(smem + lay.rng);
  float* rng = rngp + p.pad;
  int* col = reinterpret_cast<int*>(smem + lay.col);
  int* key = reinterpret_cast<int*>(smem + lay.key);
  uint32_t* osw = reinterpret_cast<uint32_t*>(smem + lay.words);
  uint32_t* onw = osw + lay.nwords;
  uint32_t* parw = onw + lay.nwords;
  uint32_t* gapw = parw + lay.nwords;
  uint16_t* reach = reinterpret_cast<uint16_t*>(smem + lay.reach);
  uint8_t* ground = smem + lay.ground;
  int8_t* label = reinterpret_cast<int8_t*>(smem + lay.label);
  int2* slots = reinterpret_cast<int2*>(smem + lay.slots);  // [2][32]

  const int r = blockIdx.y * gridDim.x + blockIdx.x;  // row of the batch
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarps = nt >> 5;
  const int count = min(max(count_in[r], 0), h);
  const int hw = p.halfwin;
  const size_t base = static_cast<size_t>(r) * h;

  // 1. Load the row; zero the range padding and the labels.
  if (p.vec) {
    const int h4 = h >> 2;
    const float4* r4 = reinterpret_cast<const float4*>(rng_in + base);
    const int4* c4 = reinterpret_cast<const int4*>(col_in + base);
    const uint32_t* g4 = reinterpret_cast<const uint32_t*>(ground_in + base);
    for (int k = tid; k < h4; k += nt) {
      reinterpret_cast<float4*>(rng)[k] = r4[k];
      reinterpret_cast<int4*>(col)[k] = c4[k];
      reinterpret_cast<uint32_t*>(ground)[k] = g4[k];
      reinterpret_cast<uint32_t*>(label)[k] = 0u;
    }
  } else {
    for (int i = tid; i < h; i += nt) {
      rng[i] = rng_in[base + i];
      col[i] = col_in[base + i];
      ground[i] = ground_in[base + i];
      label[i] = 0;
    }
  }
  for (int k = tid; k < p.pad; k += nt) {
    rngp[k] = 0.0f;
    rng[h + k] = 0.0f;
  }
  if (tid == 0) {
    const int last = lay.nwords - 1;
    osw[0] = onw[0] = parw[0] = 0u;
    osw[last] = onw[last] = parw[last] = 0u;
    gapw[0] = gapw[last] = ~0u;
  }
  __syncthreads();

  // 2. calculateSmoothness + markOccludedPoints: keys and bit masks, one
  //    32-cell word per warp step.
  const int nchunk = (h + 31) / 32;
  for (int c = warp; c < nchunk; c += nwarps) {
    const int i = c * 32 + lane;
    bool os = false, on = false, par = false, gp = true;
    if (i < h) {
      const float r0 = rng[i];
      const float r1 = rng[i + 1];
      float acc = __fmul_rn(-2.0f * hw, r0);
#pragma unroll 5
      for (int k = 1; k <= hw; ++k) {
        acc = __fadd_rn(acc, rng[i + k]);
        acc = __fadd_rn(acc, rng[i - k]);
      }
      const float cv = __fmul_rn(acc, acc);
      const bool in0 = i < count;
      const bool cok = in0 && i >= hw && i < count - hw;
      const bool g = ground[i] != 0;
      int kk = kDead;
      if (cok && !g && cv > p.edge_thr) kk = __float_as_int(cv);
      if (cok && g && cv < p.surf_thr) kk = ~__float_as_int(cv);
      key[i] = kk;
      const int c1 = i + 1 < h ? col[i + 1] : kColFill;
      const int cdiff = abs(c1 - col[i]);
      const bool close = in0 && i + 1 < count && cdiff < p.col_gap;
      os = close && r0 > __fadd_rn(r1, p.range_jump);
      on = close && r1 > __fadd_rn(r0, p.range_jump);
      gp = cdiff > p.col_gap;
      const float lim = __fmul_rn(p.parallel_frac, r0);
      par = in0 && fabsf(__fsub_rn(rng[i - 1], r0)) > lim &&
            fabsf(__fsub_rn(r1, r0)) > lim;
    }
    const uint32_t bos = __ballot_sync(kFull, os);
    const uint32_t bon = __ballot_sync(kFull, on);
    const uint32_t bpar = __ballot_sync(kFull, par);
    const uint32_t bgap = __ballot_sync(kFull, gp);
    if (lane == 0) {
      osw[c + 1] = bos;
      onw[c + 1] = bon;
      parw[c + 1] = bpar;
      gapw[c + 1] = bgap;
    }
  }
  __syncthreads();

  // 3. Per candidate cell: kill the key where occlusion or a parallel beam
  //    marks it (occl_self at j marks j-5..j, occl_next at j marks
  //    j+1..j+6); the suppression reach from the gap mask.
  for (int i = tid; i < count; i += nt) {
    if (key[i] == kDead) continue;
    if (((parw[(i >> 5) + 1] >> (i & 31)) & 1u) ||
        (window32(osw, i) & 0x3fu) || (window32(onw, i - 6) & 0x3fu))
      key[i] = kDead;
    reach[i] = static_cast<uint16_t>(
        reach_left(gapw, i, min(hw, i)) |
        (reach_right(gapw, i, min(hw, h - 1 - i)) << 8));
  }
  __syncthreads();

  // 4. Section bounds with 5-point guards: s = halfwin, e = count - hw - 1;
  //    this lane's cells of its warp's section.
  const int S = p.sections;
  if (warp >= S) return;
  const int s = hw;
  const int e = count - hw - 1;
  const int sp = floordiv(s * (S - warp) + e * warp, S);
  int ep = (warp == S - 1) ? e - 1
                           : floordiv(s * (S - 1 - warp) + e * (warp + 1), S) - 1;
  if (!(sp <= ep && e > s)) ep = sp - 1;  // empty section
  const int len = ep - sp + 1;
  const int first = sp + lane;
  const int cells = len > lane ? (len - lane + 31) / 32 : 0;
  Slab<M> sl(key + first, cells);
  if constexpr (M > 0) {
#pragma unroll
    for (int m = 0; m < M; ++m)
      sl.set(m, 32 * m + lane < len ? key[first + 32 * m] : kDead);
  }

  // 5. The greedy trips.
  const int trips = p.edge_trips + p.surf_trips;
  int bk = kDead, bm = 0, best = kDead;
  bool dirty = true;  // the slab changed since its best key was taken
  for (int t = 0; t < trips; ++t) {
    const bool edge = t < p.edge_trips;
    if (t == p.edge_trips) {
#pragma unroll
      for (int m = 0; m < sl.n(); ++m)
        if (sl.key(m) >= 0) sl.kill(m);
      dirty = true;
    }
    if (dirty) {
      sl.best(bk, bm);
      best = __reduce_max_sync(kFull, bk);
      dirty = false;
    }
    int2* slot = slots + 32 * (t & 1);
    if (best >= (edge ? 0 : kDead + 1)) {
      // The pick, its interval published and applied to this section
      // before the barrier.
      const int q = __reduce_min_sync(
          kFull, bk == best ? first + 32 * bm : INT_MAX);
      const int rc = reach[q];
      const int lo = q - (rc & 0xff), hi = q + (rc >> 8);
      if (lane == 0) {
        slot[warp] = make_int2(lo, hi);
        label[q] = edge ? (t < p.edge_sharp ? 2 : 1) : -1;
      }
      suppress(sl, first, lo, hi);
      dirty = true;
    } else if (lane == 0) {
      slot[warp] = make_int2(kFar, -kFar);  // no pick
    }
    asm volatile("bar.sync 1, %0;" ::"r"(S * 32) : "memory");
    // Lane j reads section j's interval; the warp applies the other
    // sections' that overlap it (only the neighbours' can, unless a section
    // is shorter than halfwin), one by one.
    const int2 iv = lane < S && lane != warp ? slot[lane]
                                             : make_int2(kFar, -kFar);
    uint32_t hits = __ballot_sync(kFull, iv.x <= ep && iv.y >= sp);
    dirty |= hits != 0;
    while (hits) {
      const int j = __ffs(hits) - 1;
      hits &= hits - 1;
      const int2 w = slot[j];
      suppress(sl, first, w.x, w.y);
    }
  }

  // 6. Labels out, once.  (Every label write precedes the last trip's
  //    barrier; with no trips the zeros were written before step 2's.)
  const int ns = S * 32;
  if (p.vec) {
    const char4* l4 = reinterpret_cast<const char4*>(label);
    int4* o4 = reinterpret_cast<int4*>(label_out + base);
    for (int k = tid; k < (h >> 2); k += ns) {
      const char4 l = l4[k];
      o4[k] = make_int4(l.x, l.y, l.z, l.w);
    }
  } else {
    for (int i = tid; i < h; i += ns) label_out[base + i] = label[i];
  }
}

using KernelFn = void (*)(const float*, const int*, const uint8_t*,
                          const int*, int*, Params);

// Register slabs by cells per lane; 0 = the shared-memory slab.
constexpr int kLaneCells[] = {2, 4, 6, 8, 10, 12, 16, 24, 32};
const KernelFn kRegKernels[] = {picks_kernel<2>,  picks_kernel<4>,
                                picks_kernel<6>,  picks_kernel<8>,
                                picks_kernel<10>, picks_kernel<12>,
                                picks_kernel<16>, picks_kernel<24>,
                                picks_kernel<32>};

}  // namespace

extern "C" int picks_launch(const void* rng, const void* col,
                            const void* ground, const void* count,
                            void* label, int b, int n, int h, int sections,
                            int halfwin, int edge_trips, int edge_sharp,
                            int surf_trips, float edge_thr, float surf_thr,
                            int col_gap, float range_jump,
                            float parallel_frac, void* stream) {
  if (sections < 1 || sections > 32 || halfwin < 0 || halfwin > 255 ||
      h < 1 || b < 0 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || b == 0) return 0;
  const int pad = ((halfwin > 1 ? halfwin : 1) + 3) & ~3;
  const bool vec = h % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(rng) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(col) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ground) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(label) % 16 == 0;
  Params p{h,          sections,   halfwin,  edge_trips, edge_sharp,
           surf_trips, edge_thr,   surf_thr, col_gap,    range_jump,
           parallel_frac, pad, vec ? 1 : 0};
  const int smem = Layout(h, pad).total;
  const int threads = 32 * (sections > 16 ? sections : 16);

  // Longest section over every count <= h: ceil((h - 2*halfwin - 1) / S).
  const int span = h - 2 * halfwin - 1;
  const int longest = span > 0 ? (span + sections - 1) / sections : 0;
  const int need = (longest + 31) / 32;
  KernelFn fn = picks_kernel<0>;
  for (int k = 0; k < static_cast<int>(sizeof(kLaneCells) / sizeof(int));
       ++k) {
    if (kLaneCells[k] < need) continue;
    if (threads > 512) {      // every instantiation takes 512 threads
      cudaFuncAttributes attr;
      cudaError_t err = cudaFuncGetAttributes(&attr, kRegKernels[k]);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (threads > attr.maxThreadsPerBlock) break;
    }
    fn = kRegKernels[k];
    break;
  }
  if (smem > 48 * 1024) {
    cudaError_t err =
        raise_smem_limit(reinterpret_cast<const void*>(fn), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fn<<<dim3(n, b), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rng), static_cast<const int*>(col),
      static_cast<const uint8_t*>(ground), static_cast<const int*>(count),
      static_cast<int*>(label), p);
  return static_cast<int>(cudaGetLastError());
}

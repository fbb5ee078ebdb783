// Kernel K2: curvature, occlusion marks and sectioned greedy feature picks.
//
// Replaces: legoloam_tpu/ops/features_pallas.py::_pick_kernel (wrapper
// pick_labels_pallas), which runs the same trips over section-major
// (6*N, 1920) lane grids held in TPU VMEM.
//
// Input, per ring of the compacted layout (legoloam_tpu_torch/ops/
// features.py): ranges (0 beyond the ring's count), original columns,
// ground flags, the count.  Output: int32 labels 2 sharp / 1 less-sharp /
// -1 flat / 0 (featureAssociation.cpp:621-784).
//
// What bounds it on the H100: latency.  28.8K cells in, 28.8K labels out is
// ~0.4 MB of traffic (~0.1 us of HBM time); the work is 28 greedy trips in
// sequence, each a handful of reductions over ~300 cells and a barrier.
//
// Design: one block per ring (16 blocks), the ring's ranges, columns, flags
// and curvature in shared memory (19 bytes a cell, 34 KB at H = 1800).
// Per trip each of the first `sections` warps arg-reduces its own section
// (warp shuffles; ties to the lowest index, as jnp.argmax/argmin), then one
// thread per section writes the pick's label and walks its +-5 suppression
// chain, stopping at column gaps > 10.  All sections read the picked flags
// before any is written (a barrier between), exactly as the dense trips of
// the JAX path do.  Curvature is summed in the plain version's order
// (acc = -10 r; acc += r[i+k]; acc += r[i-k]) with round-to-nearest
// intrinsics and the library is built with -fmad=false, so every float
// matches the plain PyTorch version bit for bit — picks are decided by
// float compares, and perfectly flat ground ties at curvature 0.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kColFill = 1000000;  // column value beyond the ring (as JAX)

struct Params {
  int n, h, sections, halfwin, edge_trips, edge_sharp, surf_trips;
  float edge_thr, surf_thr;
  int col_gap;
  float range_jump, parallel_frac;
};

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// Is (v, i) a better pick than (bv, bi)?  Ties go to the lower index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi,
                                       bool largest) {
  if (v != bv) return largest ? v > bv : v < bv;
  return i < bi;
}

__global__ void picks_kernel(const float* __restrict__ rng_in,
                             const int* __restrict__ col_in,
                             const uint8_t* __restrict__ ground_in,
                             const int* __restrict__ count_in,
                             int* __restrict__ label_out, Params p) {
  extern __shared__ unsigned char smem[];
  const int h = p.h;
  float* rng = reinterpret_cast<float*>(smem);
  float* curv = rng + h;
  int* col = reinterpret_cast<int*>(curv + h);
  uint8_t* ground = reinterpret_cast<uint8_t*>(col + h);
  uint8_t* curv_ok = ground + h;
  uint8_t* picked = curv_ok + h;
  uint8_t* gap = picked + h;          // gap between i and i+1
  uint8_t* occl_self = gap + h;
  uint8_t* occl_next = occl_self + h;
  int8_t* label = reinterpret_cast<int8_t*>(occl_next + h);
  __shared__ int pick_pos[32];

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int count = count_in[r];
  const int base = r * h;

  for (int i = tid; i < h; i += nt) {
    rng[i] = rng_in[base + i];
    col[i] = col_in[base + i];
    ground[i] = ground_in[base + i];
    label[i] = 0;
  }
  __syncthreads();

  auto R = [&](int i) { return (i >= 0 && i < h) ? rng[i] : 0.0f; };
  auto C = [&](int i) { return (i >= 0 && i < h) ? col[i] : kColFill; };
  auto in_ring = [&](int i) { return i >= 0 && i < count; };

  // calculateSmoothness + markOccludedPoints, elementwise.
  for (int i = tid; i < h; i += nt) {
    float acc = __fmul_rn(-2.0f * p.halfwin, rng[i]);
    for (int k = 1; k <= p.halfwin; ++k) {
      acc = __fadd_rn(acc, R(i + k));
      acc = __fadd_rn(acc, R(i - k));
    }
    curv[i] = __fmul_rn(acc, acc);
    curv_ok[i] = in_ring(i) && i >= p.halfwin && i < count - p.halfwin;
    float rr = R(i + 1);
    int cdiff = abs(C(i + 1) - col[i]);
    bool close = in_ring(i) && in_ring(i + 1) && cdiff < p.col_gap;
    occl_self[i] = close && rng[i] > __fadd_rn(rr, p.range_jump);
    occl_next[i] = close && rr > __fadd_rn(rng[i], p.range_jump);
    gap[i] = cdiff > p.col_gap;
  }
  __syncthreads();
  for (int i = tid; i < h; i += nt) {
    bool pk = false;
    for (int k = 0; k < 6; ++k) {
      // occl_self at j marks j-5..j; occl_next at j marks j+1..j+6.
      if (i + k < h && occl_self[i + k]) pk = true;
      if (i - k - 1 >= 0 && occl_next[i - k - 1]) pk = true;
    }
    float lim = __fmul_rn(p.parallel_frac, rng[i]);
    bool parallel = in_ring(i) && fabsf(R(i - 1) - rng[i]) > lim &&
                    fabsf(R(i + 1) - rng[i]) > lim;
    picked[i] = (pk || parallel) && in_ring(i);
  }
  __syncthreads();

  // Section bounds with 5-point guards: s = halfwin, e = count - halfwin - 1.
  const int S = p.sections;
  const int s = p.halfwin;
  const int e = count - p.halfwin - 1;
  const int warp = tid / 32;
  const int lane = tid % 32;
  int sp = 0, ep = -1;
  if (warp < S) {
    sp = floordiv(s * (S - warp) + e * warp, S);
    ep = (warp == S - 1) ? e - 1
                         : floordiv(s * (S - 1 - warp) + e * (warp + 1), S) - 1;
    if (!(sp <= ep && e > s)) ep = sp - 1;  // empty section
  }

  const int trips = p.edge_trips + p.surf_trips;
  for (int t = 0; t < trips; ++t) {
    const bool edge = t < p.edge_trips;
    if (warp < S) {
      float bv = edge ? -CUDART_INF_F : CUDART_INF_F;
      int bi = 0x7FFFFFFF;
      for (int i = sp + lane; i <= ep; i += 32) {
        bool ok = curv_ok[i] && !picked[i] &&
                  (edge ? (!ground[i] && curv[i] > p.edge_thr)
                        : (ground[i] && curv[i] < p.surf_thr));
        if (ok && better(curv[i], i, bv, bi, edge)) {
          bv = curv[i];
          bi = i;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        float ov = __shfl_down_sync(0xffffffffu, bv, off);
        int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (oi != 0x7FFFFFFF && (bi == 0x7FFFFFFF ||
                                 better(ov, oi, bv, bi, edge))) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) pick_pos[warp] = bi;
    }
    __syncthreads();
    if (tid < S && pick_pos[tid] != 0x7FFFFFFF) {
      const int q = pick_pos[tid];
      label[q] = edge ? (t < p.edge_sharp ? 2 : 1) : -1;
      picked[q] = 1;
      for (int m = 1; m <= p.halfwin && q + m < h; ++m) {
        if (gap[q + m - 1]) break;
        picked[q + m] = 1;
      }
      for (int m = 1; m <= p.halfwin && q - m >= 0; ++m) {
        if (gap[q - m]) break;
        picked[q - m] = 1;
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < h; i += nt) label_out[base + i] = label[i];
}

}  // namespace

extern "C" int picks_launch(const void* rng, const void* col,
                            const void* ground, const void* count,
                            void* label, int n, int h, int sections,
                            int halfwin, int edge_trips, int edge_sharp,
                            int surf_trips, float edge_thr, float surf_thr,
                            int col_gap, float range_jump,
                            float parallel_frac, void* stream) {
  Params p{n, h, sections, halfwin, edge_trips, edge_sharp, surf_trips,
           edge_thr, surf_thr, col_gap, range_jump, parallel_frac};
  size_t smem = static_cast<size_t>(h) * (3 * sizeof(float) + 7);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        picks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int warps = sections > 8 ? sections : 8;
  picks_kernel<<<n, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rng), static_cast<const int*>(col),
      static_cast<const uint8_t*>(ground), static_cast<const int*>(count),
      static_cast<int*>(label), p);
  return static_cast<int>(cudaGetLastError());
}

// Kernel K3: brute-force k-NN with bounding-box chunk culling.
//
// Replaces: legoloam_tpu/ops/knn_pallas.py::_knn_kernel (wrapper
// knn_pallas), which computes (256 x 512) distance tiles on the TPU matrix
// unit in the ||q||^2 - 2 q.r + ||r||^2 form, packs distance and index into
// one int32 for k min-passes, and needs an exact re-sort afterwards.
//
// Contract (legoloam_tpu_torch/ops/knn_cuda.py): per valid query the k
// nearest VALID references by squared distance, ascending, ties to the
// lower index; slots beyond the number of valid references, and every slot
// of an invalid query, hold (1e30, 0).  With use_gate, a reference chunk
// whose box lies farther than sqrt(gate_sq) from the query tile's box is
// skipped: results are exact for every query whose k-th neighbour is within
// the gate.
//
// What bounds it on the H100: operations.  Every visited (query, reference)
// pair costs 8 float32 operations (3 sub, 3 mul, 2 add) on the CUDA cores:
// at the mapping shapes (8192 x 49152) an unculled search is 3.2 GFLOP,
// ~48 us at 67 TFLOP/s, against ~0.8 MB of inputs; culling removes most
// chunk pairs, so the visited pairs set the bound.
//
// Design: one thread per query, 64 queries per block; reference chunks of
// `rc` points are staged through shared memory (structure of arrays), and
// the whole block skips a chunk when its precomputed box (a plain reduction
// before the launch) is beyond the gate from the block's query box.
// Distances are in difference form, in float32, with round-to-nearest
// intrinsics (the library is built with -fmad=false): exact at any
// coordinate offset, and no tensor cores, whose TF32 inputs would corrupt
// near-neighbour ranks.  Each thread keeps a sorted top-k in registers
// (K is a template parameter); references arrive in index order and only a
// strictly smaller distance displaces an entry, so ties keep the lower
// index without any packed key — the JAX kernel's 2^16-reference limit and
// its re-sort pass are gone.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTQ = 64;
constexpr float kBig = 1e30f;

__device__ __forceinline__ float box_gap(float qlo, float qhi, float clo,
                                         float chi) {
  return fmaxf(fmaxf(qlo - chi, clo - qhi), 0.0f);
}

template <int K>
__global__ void knn_kernel(const float* __restrict__ q,
                           const uint8_t* __restrict__ qv,
                           const float* __restrict__ r,
                           const uint8_t* __restrict__ rv,
                           const float* __restrict__ chunk_lo,
                           const float* __restrict__ chunk_hi,
                           float* __restrict__ d_out, int* __restrict__ i_out,
                           unsigned long long* visited, int q_n, int r_n,
                           int rc, float gate_sq, int use_gate) {
  extern __shared__ float sref[];
  float* sx = sref;
  float* sy = sx + rc;
  float* sz = sy + rc;
  uint8_t* sv = reinterpret_cast<uint8_t*>(sz + rc);
  __shared__ float wlo[3][kTQ / 32], whi[3][kTQ / 32];
  __shared__ float tlo[3], thi[3];

  const int tid = threadIdx.x;
  const int qi = blockIdx.x * kTQ + tid;
  const bool active = qi < q_n && qv[qi];
  float p[3] = {0.f, 0.f, 0.f};
  if (active) {
    p[0] = q[3 * qi];
    p[1] = q[3 * qi + 1];
    p[2] = q[3 * qi + 2];
  }

  // Box of the block's valid queries.
  for (int a = 0; a < 3; ++a) {
    float lo = active ? p[a] : CUDART_INF_F;
    float hi = active ? p[a] : -CUDART_INF_F;
    for (int off = 16; off > 0; off >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (tid % 32 == 0) {
      wlo[a][tid / 32] = lo;
      whi[a][tid / 32] = hi;
    }
  }
  __syncthreads();
  if (tid < 3) {
    float lo = wlo[tid][0], hi = whi[tid][0];
    for (int w = 1; w < kTQ / 32; ++w) {
      lo = fminf(lo, wlo[tid][w]);
      hi = fmaxf(hi, whi[tid][w]);
    }
    tlo[tid] = lo;
    thi[tid] = hi;
  }
  __syncthreads();
  const bool any_active = tlo[0] <= thi[0];

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = kBig;
    bi[s] = 0;
  }

  const int n_chunks = (r_n + rc - 1) / rc;
  for (int c = 0; any_active && c < n_chunks; ++c) {
    if (use_gate) {
      float g0 = box_gap(tlo[0], thi[0], chunk_lo[3 * c], chunk_hi[3 * c]);
      float g1 = box_gap(tlo[1], thi[1], chunk_lo[3 * c + 1],
                         chunk_hi[3 * c + 1]);
      float g2 = box_gap(tlo[2], thi[2], chunk_lo[3 * c + 2],
                         chunk_hi[3 * c + 2]);
      float mind = __fadd_rn(__fadd_rn(__fmul_rn(g0, g0), __fmul_rn(g1, g1)),
                             __fmul_rn(g2, g2));
      if (!(mind <= gate_sq)) continue;  // uniform across the block
    }
    __syncthreads();  // the previous chunk is no longer read
    for (int j = tid; j < rc; j += kTQ) {
      int idx = c * rc + j;
      bool ok = idx < r_n && rv[idx];
      sv[j] = ok;
      if (ok) {
        sx[j] = r[3 * idx];
        sy[j] = r[3 * idx + 1];
        sz[j] = r[3 * idx + 2];
      }
    }
    __syncthreads();
    if (tid == 0 && visited != nullptr) atomicAdd(visited, 1ull);
    if (active) {
      for (int j = 0; j < rc; ++j) {
        if (!sv[j]) continue;
        float dx = __fsub_rn(p[0], sx[j]);
        float dy = __fsub_rn(p[1], sy[j]);
        float dz = __fsub_rn(p[2], sz[j]);
        float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                            __fmul_rn(dz, dz));
        if (d < bd[K - 1]) {
          bd[K - 1] = d;
          bi[K - 1] = c * rc + j;
#pragma unroll
          for (int s = K - 1; s > 0; --s) {
            if (bd[s] < bd[s - 1]) {
              float td = bd[s];
              bd[s] = bd[s - 1];
              bd[s - 1] = td;
              int ti = bi[s];
              bi[s] = bi[s - 1];
              bi[s - 1] = ti;
            }
          }
        }
      }
    }
  }

  if (qi < q_n) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      d_out[qi * K + s] = active ? bd[s] : kBig;
      i_out[qi * K + s] = active ? bi[s] : 0;
    }
  }
}

template <int K>
int launch(const float* q, const uint8_t* qv, const float* r,
           const uint8_t* rv, const float* lo, const float* hi, float* d,
           int* i, unsigned long long* visited, int q_n, int r_n, int rc,
           float gate_sq, int use_gate, cudaStream_t s) {
  size_t smem = static_cast<size_t>(rc) * (3 * sizeof(float) + 1);
  int blocks = (q_n + kTQ - 1) / kTQ;
  if (blocks > 0)
    knn_kernel<K><<<blocks, kTQ, smem, s>>>(q, qv, r, rv, lo, hi, d, i,
                                            visited, q_n, r_n, rc, gate_sq,
                                            use_gate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int knn_launch(const void* q, const void* qv, const void* r,
                          const void* rv, const void* chunk_lo,
                          const void* chunk_hi, void* d_out, void* i_out,
                          void* visited, int q_n, int r_n, int k, int rc,
                          float gate_sq, int use_gate, void* stream) {
  auto args = [&](auto kfn) {
    return kfn(static_cast<const float*>(q), static_cast<const uint8_t*>(qv),
               static_cast<const float*>(r), static_cast<const uint8_t*>(rv),
               static_cast<const float*>(chunk_lo),
               static_cast<const float*>(chunk_hi),
               static_cast<float*>(d_out), static_cast<int*>(i_out),
               static_cast<unsigned long long*>(visited), q_n, r_n, rc,
               gate_sq, use_gate, static_cast<cudaStream_t>(stream));
  };
  switch (k) {
    case 1: return args(launch<1>);
    case 2: return args(launch<2>);
    case 3: return args(launch<3>);
    case 4: return args(launch<4>);
    case 5: return args(launch<5>);
    case 6: return args(launch<6>);
    case 7: return args(launch<7>);
    case 8: return args(launch<8>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

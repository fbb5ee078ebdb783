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
// of an invalid query, hold (1e30, 0).  Both point sets are taken relative
// to the centre of the valid-reference box (as the plain version does).
// With use_gate, a query tile skips every reference chunk whose box lies
// farther than sqrt(gate_sq) from each of the tile's valid queries: results
// are exact for every query whose k-th neighbour is within the gate.
//
// What bounds it on the H100: operations.  Every visited (query, reference)
// pair costs 8 float32 operations (3 sub, 3 mul, 2 add) on the CUDA cores;
// culling removes most chunk pairs, so the visited pairs set the bound.
//
// Design.  Two launches:
//   knn_boxes   one block per reference chunk of kRC = 64 points: the
//               chunk's box of valid references (lo = +inf, hi = -inf when
//               empty);
//   knn_kernel  one block per tile of kTQ = 32 consecutive queries (the
//               mapping step's queries are Morton-ordered, valid first, so
//               most tiles are spatially tight and tiles without a valid
//               query exit at once), kWarps = 32 warps.  Each block
//     1. reduces the chunk boxes to the valid-reference box and its centre,
//     2. culls all chunk boxes in parallel, one chunk per thread: a chunk
//        survives when it holds a valid reference and, with the gate, lies
//        within the gate of the tile's box and of at least one of the
//        tile's valid queries (a tile that straddles a jump of the Morton
//        order has a large box but few chunks near any of its queries);
//        the survivors are compacted in index order with __ballot_sync,
//     3. hands the surviving chunks out round robin to the warps: warp w
//        takes survivors w, w + kWarps, ...; lane l holds query l of the
//        tile and a sorted top-k in registers,
//     4. stages each chunk through a two-slot cp.async ring per warp (the
//        next chunk loads while this one is searched), then converts it to
//        recentred float4 points whose invalid slots hold a far sentinel,
//        so the inner loop has no validity branch,
//     5. merges the kWarps partial lists of each query pairwise in shared
//        memory (five halvings) by the pair (distance, index) in
//        lexicographic order.
// Small chunks and many warps keep a tile's work spread over the whole SM:
// the main path has few active tiles (~86 of 256 at the surf shape), so the
// time is one tile's latency, not the card's throughput.
// Within a lane references arrive in increasing index order, so a strict
// "<" on the distance keeps the lower index on ties; the merge compares
// (distance, index) pairs, so the result equals the exact search's
// whatever the split.  Distances are in difference form, in float32, with
// round-to-nearest intrinsics (the library is built with -fmad=false): no
// tensor cores, whose TF32 inputs would corrupt near-neighbour ranks.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace {

constexpr int kTQ = 32;      // queries per block: one per lane
constexpr int kWarps = 32;   // warps per block, each on its own chunks
constexpr int kThreads = kTQ * kWarps;
constexpr int kRC = 64;      // references per chunk
constexpr float kBig = 1e30f;
constexpr float kFar = 1e18f;  // sentinel coordinate: d ~ 3e36 > kBig

// One staging slot: a chunk's raw (x, y, z) triples and validity bytes, as
// they lie in device memory (16-byte segments for cp.async).
struct Slot {
  float raw[3 * kRC];
  uint8_t valid[kRC];
};
// Per warp: two staging slots and the converted chunk.
struct WarpBuf {
  Slot slot[2];
  float4 pts[kRC];
};
constexpr size_t kSmem = kWarps * sizeof(WarpBuf);
static_assert(sizeof(Slot) % 16 == 0, "slots must keep 16-byte alignment");

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ int clamp16(long long n) {
  return n <= 0 ? 0 : (n >= 16 ? 16 : static_cast<int>(n));
}

// Start the copies of chunk `c` into `slot` (zero-filled past the end of
// the arrays, which reads as "invalid").  Both bases are 16-byte aligned
// (checked by the wrapper) and a chunk spans 768 + 64 bytes.
__device__ __forceinline__ void stage(Slot* slot, const float* r,
                                      const uint8_t* rv, int c, int r_n,
                                      int lane) {
  const char* rb = reinterpret_cast<const char*>(r);
  const long long r_bytes = 12ll * r_n;
  for (int s = lane; s < 3 * kRC * 4 / 16; s += 32) {
    long long off = 12ll * kRC * c + 16ll * s;
    int n = clamp16(r_bytes - off);
    cp_async16(reinterpret_cast<char*>(slot->raw) + 16 * s,
               n ? rb + off : rb, n);
  }
  if (lane < kRC / 16) {
    long long off = static_cast<long long>(kRC) * c + 16 * lane;
    int n = clamp16(r_n - off);
    cp_async16(slot->valid + 16 * lane, n ? rv + off : rv, n);
  }
}

__device__ __forceinline__ float box_gap(float qlo, float qhi, float clo,
                                         float chi) {
  return fmaxf(fmaxf(__fsub_rn(qlo, chi), __fsub_rn(clo, qhi)), 0.0f);
}

// Squared distance between two boxes (0 where they overlap).
__device__ __forceinline__ float box_dist_sq(const float* alo,
                                             const float* ahi,
                                             const float* blo,
                                             const float* bhi) {
  float g[3];
  for (int a = 0; a < 3; ++a) g[a] = box_gap(alo[a], ahi[a], blo[a], bhi[a]);
  return __fadd_rn(__fadd_rn(__fmul_rn(g[0], g[0]), __fmul_rn(g[1], g[1])),
                   __fmul_rn(g[2], g[2]));
}

__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Box of each chunk's valid references.
__global__ void knn_boxes(const float* __restrict__ r,
                          const uint8_t* __restrict__ rv,
                          float* __restrict__ lo, float* __restrict__ hi,
                          int r_n) {
  __shared__ float slo[3][kRC / 32], shi[3][kRC / 32];
  static_assert(kRC % 32 == 0, "one box per whole warps");
  const int tid = threadIdx.x;
  const int idx = blockIdx.x * kRC + tid;
  const bool ok = idx < r_n && rv[idx];
  for (int a = 0; a < 3; ++a) {
    float v = ok ? r[3 * idx + a] : 0.0f;
    float l = warp_min(ok ? v : CUDART_INF_F);
    float h = warp_max(ok ? v : -CUDART_INF_F);
    if (tid % 32 == 0) {
      slo[a][tid / 32] = l;
      shi[a][tid / 32] = h;
    }
  }
  __syncthreads();
  if (tid < 3) {
    float l = slo[tid][0], h = shi[tid][0];
    for (int w = 1; w < kRC / 32; ++w) {
      l = fminf(l, slo[tid][w]);
      h = fmaxf(h, shi[tid][w]);
    }
    lo[3 * blockIdx.x + tid] = l;
    hi[3 * blockIdx.x + tid] = h;
  }
}

// Lexicographic (distance, index) insert into a sorted list of K.
template <int K>
__device__ __forceinline__ bool insert_lex(float* bd, int* bi, float d,
                                           int i) {
  if (!(d < bd[K - 1] || (d == bd[K - 1] && i < bi[K - 1]))) return false;
  bd[K - 1] = d;
  bi[K - 1] = i;
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    if (bd[s] < bd[s - 1] || (bd[s] == bd[s - 1] && bi[s] < bi[s - 1])) {
      float td = bd[s];
      bd[s] = bd[s - 1];
      bd[s - 1] = td;
      int ti = bi[s];
      bi[s] = bi[s - 1];
      bi[s - 1] = ti;
    }
  }
  return true;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    knn_kernel(const float* __restrict__ q, const uint8_t* __restrict__ qv,
               const float* __restrict__ r, const uint8_t* __restrict__ rv,
               const float* __restrict__ chunk_lo,
               const float* __restrict__ chunk_hi, float* __restrict__ d_out,
               int64_t* __restrict__ i_out, unsigned long long* visited,
               int q_n, int r_n, float gate_sq, int use_gate) {
  extern __shared__ __align__(16) unsigned char smem[];
  WarpBuf* bufs = reinterpret_cast<WarpBuf*>(smem);
  __shared__ float red[2][3][kWarps];
  __shared__ float s_c[3], s_tlo[3], s_thi[3];
  __shared__ float s_q[3][kTQ];
  __shared__ bool s_act[kTQ];
  __shared__ int s_list[kThreads];
  __shared__ int s_wcount[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int tile = blockIdx.x;
  const int n_chunks = (r_n + kRC - 1) / kRC;

  // Tiles without a valid query write their rows and leave.
  const int qi = tile * kTQ + lane;
  const bool active = qi < q_n && qv[qi];
  if (!__syncthreads_or(active)) {
    if (warp == 0 && qi < q_n)
      for (int s = 0; s < K; ++s) {
        d_out[qi * K + s] = kBig;
        i_out[qi * K + s] = 0;
      }
    return;
  }

  // 1. Valid-reference box from the chunk boxes; its centre (0 if none).
  {
    float l[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
    float h[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
    for (int c = tid; c < n_chunks; c += kThreads)
      for (int a = 0; a < 3; ++a) {
        l[a] = fminf(l[a], chunk_lo[3 * c + a]);
        h[a] = fmaxf(h[a], chunk_hi[3 * c + a]);
      }
    for (int a = 0; a < 3; ++a) {
      float lw = warp_min(l[a]), hw = warp_max(h[a]);
      if (lane == 0) {
        red[0][a][warp] = lw;
        red[1][a][warp] = hw;
      }
    }
    __syncthreads();
    if (tid < 3) {
      float lo = red[0][tid][0], hi = red[1][tid][0];
      for (int w = 1; w < kWarps; ++w) {
        lo = fminf(lo, red[0][tid][w]);
        hi = fmaxf(hi, red[1][tid][w]);
      }
      s_c[tid] = lo <= hi ? __fmul_rn(0.5f, __fadd_rn(lo, hi)) : 0.0f;
    }
    __syncthreads();
  }
  const float c0 = s_c[0], c1 = s_c[1], c2 = s_c[2];

  // The tile's recentred queries and their box (warp 0).
  if (warp == 0) {
    float p[3] = {0.f, 0.f, 0.f};
    if (active) {
      p[0] = __fsub_rn(q[3 * qi], c0);
      p[1] = __fsub_rn(q[3 * qi + 1], c1);
      p[2] = __fsub_rn(q[3 * qi + 2], c2);
    }
    s_act[lane] = active;
    for (int a = 0; a < 3; ++a) {
      s_q[a][lane] = p[a];
      float lo = warp_min(active ? p[a] : CUDART_INF_F);
      float hi = warp_max(active ? p[a] : -CUDART_INF_F);
      if (lane == 0) {
        s_tlo[a] = lo;
        s_thi[a] = hi;
      }
    }
  }
  __syncthreads();
  const float px = s_q[0][lane], py = s_q[1][lane], pz = s_q[2][lane];

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = kBig;
    bi[s] = 0;
  }

  WarpBuf& wb = bufs[warp];
  for (int base = 0; base < n_chunks; base += kThreads) {
    // 2. Cull one chunk per thread; compact the survivors in index order.
    const int c = base + tid;
    bool keep = false;
    if (c < n_chunks) {
      float lo[3], hi[3];
      for (int a = 0; a < 3; ++a) {
        lo[a] = chunk_lo[3 * c + a];
        hi[a] = chunk_hi[3 * c + a];
      }
      keep = lo[0] <= hi[0];  // the chunk holds a valid reference
      if (keep && use_gate) {
        const float cc[3] = {c0, c1, c2};
        for (int a = 0; a < 3; ++a) {
          lo[a] = __fsub_rn(lo[a], cc[a]);
          hi[a] = __fsub_rn(hi[a], cc[a]);
        }
        keep = box_dist_sq(s_tlo, s_thi, lo, hi) <= gate_sq;
        bool near = false;
        for (int t = 0; keep && !near && t < kTQ; ++t) {
          const float pt[3] = {s_q[0][t], s_q[1][t], s_q[2][t]};
          near = s_act[t] && box_dist_sq(pt, pt, lo, hi) <= gate_sq;
        }
        keep = near;
      }
    }
    const unsigned bal = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_wcount[warp] = __popc(bal);
    __syncthreads();
    int off = 0, n_keep = 0;
    for (int w = 0; w < kWarps; ++w) {
      off += w < warp ? s_wcount[w] : 0;
      n_keep += s_wcount[w];
    }
    if (keep) s_list[off + __popc(bal & ((1u << lane) - 1u))] = c;
    __syncthreads();
    if (tid == 0 && visited != nullptr && n_keep > 0)
      atomicAdd(visited, static_cast<unsigned long long>(n_keep));

    // 3-4. This warp's survivors, two-slot cp.async ring.
    int it = 0;
    if (warp < n_keep) stage(&wb.slot[0], r, rv, s_list[warp], r_n, lane);
    cp_async_commit();
    for (int i = warp; i < n_keep; i += kWarps, ++it) {
      const int next = i + kWarps;
      if (next < n_keep)
        stage(&wb.slot[(it + 1) & 1], r, rv, s_list[next], r_n, lane);
      cp_async_commit();
      cp_async_wait1();
      __syncwarp();
      const Slot& sl = wb.slot[it & 1];
      for (int j = lane; j < kRC; j += 32) {
        bool ok = sl.valid[j] != 0;
        wb.pts[j] = ok ? make_float4(__fsub_rn(sl.raw[3 * j], c0),
                                     __fsub_rn(sl.raw[3 * j + 1], c1),
                                     __fsub_rn(sl.raw[3 * j + 2], c2), 0.f)
                       : make_float4(kFar, kFar, kFar, 0.f);
      }
      __syncwarp();
      if (active) {
        const int ibase = s_list[i] * kRC;
#pragma unroll 4
        for (int j = 0; j < kRC; ++j) {
          const float4 rp = wb.pts[j];
          float dx = __fsub_rn(px, rp.x);
          float dy = __fsub_rn(py, rp.y);
          float dz = __fsub_rn(pz, rp.z);
          float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                              __fmul_rn(dz, dz));
          if (d < bd[K - 1]) {
            // References reach this lane in index order: an equal distance
            // already held has the lower index and stays first.
            bd[K - 1] = d;
            bi[K - 1] = ibase + j;
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
      __syncwarp();
    }
    cp_async_wait0();
    __syncthreads();  // s_list and the rings are reused by the next round
  }

  // 5. Merge the partial lists pairwise through shared memory (the rings
  //    are free): warps [h, 2h) hand their lists to warps [0, h).
  float* md = reinterpret_cast<float*>(smem);
  int* mi = reinterpret_cast<int*>(md + (kWarps / 2) * K * kTQ);
  for (int half = kWarps / 2; half > 0; half /= 2) {
    if (warp >= half && warp < 2 * half) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        md[((warp - half) * K + s) * kTQ + lane] = bd[s];
        mi[((warp - half) * K + s) * kTQ + lane] = bi[s];
      }
    }
    __syncthreads();
    if (warp < half)
      for (int s = 0; s < K; ++s)
        if (!insert_lex<K>(bd, bi, md[(warp * K + s) * kTQ + lane],
                           mi[(warp * K + s) * kTQ + lane]))
          break;  // each partial list is sorted: the rest cannot enter
    __syncthreads();
  }
  if (warp != 0 || qi >= q_n) return;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    d_out[qi * K + s] = active ? bd[s] : kBig;
    i_out[qi * K + s] = active ? bi[s] : 0;
  }
}

template <int K>
int launch(const float* q, const uint8_t* qv, const float* r,
           const uint8_t* rv, float* lo, float* hi, float* d, int64_t* i,
           unsigned long long* visited, int q_n, int r_n, float gate_sq,
           int use_gate, cudaStream_t s) {
  cudaError_t e = raise_smem_limit(
      reinterpret_cast<const void*>(knn_kernel<K>), static_cast<int>(kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_chunks = (r_n + kRC - 1) / kRC;
  const int tiles = (q_n + kTQ - 1) / kTQ;
  if (n_chunks > 0) knn_boxes<<<n_chunks, kRC, 0, s>>>(r, rv, lo, hi, r_n);
  if (tiles > 0)
    knn_kernel<K><<<tiles, kThreads, kSmem, s>>>(q, qv, r, rv, lo, hi, d, i,
                                                 visited, q_n, r_n, gate_sq,
                                                 use_gate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int knn_launch(const void* q, const void* qv, const void* r,
                          const void* rv, void* chunk_lo, void* chunk_hi,
                          void* d_out, void* i_out, void* visited, int q_n,
                          int r_n, int k, float gate_sq, int use_gate,
                          void* stream) {
  auto args = [&](auto kfn) {
    return kfn(static_cast<const float*>(q), static_cast<const uint8_t*>(qv),
               static_cast<const float*>(r), static_cast<const uint8_t*>(rv),
               static_cast<float*>(chunk_lo), static_cast<float*>(chunk_hi),
               static_cast<float*>(d_out), static_cast<int64_t*>(i_out),
               static_cast<unsigned long long*>(visited), q_n, r_n, gate_sq,
               use_gate, static_cast<cudaStream_t>(stream));
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

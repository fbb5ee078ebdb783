// Kernel K4: the odometry's class-windowed nearest-neighbour search.
//
// Replaces no Pallas kernel.  The JAX package's class_nn
// (legoloam_tpu/ops/voxel.py:199) is jnp: per tile of 512 queries a
// (512 x R) distance matrix, then per class a penalty and an argmin over
// it.  The port carried that over as plain PyTorch (ops/voxel.py), about a
// dozen elementwise passes a class over tiles of up to 134 MB (VLS-128's
// surface search, 8192 x 65536), which took most of a VLS-128 scan.  This
// kernel keeps every (query, reference) value in registers: no Q x R
// tensor reaches device memory.
//
// Contract (legoloam_tpu_torch/ops/class_nn_cuda.py): bitwise the plain
// version's (d, i) on the card.  For class c and query q, the minimum over
// the references r of d + pen, ties to the lower index and NaN first, as
// torch.min takes them (LessOrNan), then clamped at 0, where
//   d   = (q_sq[q] - 2 * dot(q, ref_m[r])) + r_sq[r], the dot rounded as
//         cuBLAS's float32 product rounds it at K = 3 (bit for bit at every
//         main-path shape on the H100): fma(q2, r2, fma(q1, r1,
//         fma(q0, r0, 0)));
//   pen = 1e30 where ref_key[r] < lo[c, q], ref_key[r] > hi[c, q] or
//         d <= ex[c, q], else 0.
// ref_m (invalid references moved to 1e6), r_sq and q_sq are the plain
// version's own PyTorch ops, run by the wrapper.
//
// What bounds it on the H100: operations.  A pair whose distance the search
// needs (its key inside a class window of the query) costs 9 float32
// operations (the dot 2K = 6, as a matrix product counts it, then the
// doubling, the difference and the sum) and each such class 2 more (the
// exclusion and the running minimum); the bytes are O(Q + R).  An open
// class (lo = -inf, hi = +inf, ex = -inf: the odometry's 1-class calls)
// needs every pair; the 2-class calls' ring windows hold a few rings of the
// cloud.
//
// Design.  Three launches:
//   class_nn_chunks  per chunk of kRC = 64 references: the range of its
//     keys and whether all its references are fast (below).
//   class_nn_scan    one block per (tile of kTQ = 512 queries, split),
//     kThreads = 128 threads, each holding 4 consecutive queries with, per
//     class, their lo, hi, ex and running (value, index) in registers.  The
//     tile lists the chunks it needs (chunk 0, and the chunks whose keys
//     meet a class window of the tile: the feature clouds are ordered by
//     ring, so a 2-class call needs a few of them) and its splits share that
//     list evenly, so the blocks of a tile finish together.  A block walks
//     its chunks in index order, staged through shared memory as float4
//     (x, y, z, r_sq) and the key, the next chunk's loads in flight while
//     this one is searched; a warp whose 128 queries' windows miss the
//     chunk's keys does not search it, and a chunk of one key (most chunks
//     of a ring-ordered cloud) tests each (class, query) once, not each
//     pair.  All classes of a call share one
//     distance a pair.  The wrapper picks the number of splits from the
//     shapes (about four blocks an SM), so VLP-16's 512 x 2048 corner search
//     and VLS-128's 8192 x 65536 surface search both fill the card.  Each
//     block writes one partial (value, index) per (class, query).
//   class_nn_merge   kMergeLanes lanes per (class, query): the partials
//     merged by (value, index) as LessOrNan orders them, which no split can
//     change, then clamped at 0.
// Within a thread references arrive in index order, so a strict compare
// keeps the lower index on ties.
//
// Fast pairs.  Where q_sq and r_sq are both below kFastSq = 1e21, |d| is
// below 4e21: -2 * dot cannot overflow, and d + 1e30 rounds to exactly 1e30.
// For such pairs the kernel takes exact shortcuts:
//   * d = fma(-2, dot, q_sq) + r_sq, one rounding of the exact
//     q_sq - 2 * dot as the separate product and difference give;
//   * every penalised value is exactly 1e30, so once a class's running value
//     is at most 1e30 no penalised reference can replace it: a chunk caps the
//     running value at (1e30, its first index) and then takes in-class
//     references alone; a chunk that cannot hold one for the tile's (or a
//     warp's) queries is skipped, as chunk 0's result, (1e30, 0) or better,
//     beats every value it could give;
//   * an open class penalises nothing, so its running minimum is kept by
//     fminf over groups of kGroup references, and the index is found only
//     in a group that lowered it.
// Other pairs (coordinates that are non-finite or beyond ~3e10) take the
// literal rule, NaN included, and a tile with such a query or chunk skips
// nothing.  The library is built with -fmad=false and every rounding is
// written out.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kQT = 4;                  // queries a thread, consecutive
constexpr int kTQ = kThreads * kQT;     // queries a tile
constexpr int kRC = 64;                 // references a chunk
constexpr int kGroup = 8;               // open class: references a group
constexpr int kMergeLanes = 8;          // merge: lanes an output
constexpr float kBig = 1e30f;
constexpr float kFastSq = 1e21f;

struct Chunk {
  float4 p[kRC];  // x, y, z, r_sq
  float key[kRC];
};

__device__ __forceinline__ float dot3(float qx, float qy, float qz,
                                      float4 r) {
  return __fmaf_rn(qz, r.z,
                   __fmaf_rn(qy, r.y, __fmaf_rn(qx, r.x, 0.0f)));
}

// d of a fast pair.
__device__ __forceinline__ float d_fast(float qx, float qy, float qz,
                                        float qs, float4 r) {
  return __fadd_rn(__fmaf_rn(-2.0f, dot3(qx, qy, qz, r), qs), r.w);
}

// d of any pair, as the plain version rounds it.
__device__ __forceinline__ float d_literal(float qx, float qy, float qz,
                                           float qs, float4 r) {
  return __fadd_rn(__fsub_rn(qs, __fmul_rn(2.0f, dot3(qx, qy, qz, r))),
                   r.w);
}

// torch.min's LessOrNan on (value, index) pairs.
__device__ __forceinline__ bool less_or_nan(float v, int i, float bv,
                                            int bi) {
  return v != v ? (bv != bv ? i < bi : true) : (v == bv ? i < bi : v < bv);
}

// Per chunk of kRC references (one block of kRC threads a chunk): the
// range of its keys (a NaN key, which every class admits, widens it to all
// keys) and whether all its references are fast.
__global__ void class_nn_chunks(const float* __restrict__ r_sq,
                                const float* __restrict__ key,
                                float* __restrict__ c_lo,
                                float* __restrict__ c_hi,
                                int* __restrict__ c_fast, int r_n) {
  __shared__ float s_lo[kRC / 32], s_hi[kRC / 32];
  __shared__ int s_fast[kRC / 32];
  const int t = threadIdx.x;
  const int r = blockIdx.x * kRC + t;
  const bool in = r < r_n;
  const float k = in ? key[r] : 0.0f;
  float lo = !in ? CUDART_INF_F : (k != k ? -CUDART_INF_F : k);
  float hi = !in ? -CUDART_INF_F : (k != k ? CUDART_INF_F : k);
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  const int fast = __all_sync(0xffffffffu, !in || r_sq[r] < kFastSq);
  if (t % 32 == 0) {
    s_lo[t / 32] = lo;
    s_hi[t / 32] = hi;
    s_fast[t / 32] = fast;
  }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < kRC / 32; ++w) {
      lo = fminf(lo, s_lo[w]);
      hi = fmaxf(hi, s_hi[w]);
    }
    int f = s_fast[0];
    for (int w = 1; w < kRC / 32; ++w) f = f && s_fast[w];
    c_lo[blockIdx.x] = lo;
    c_hi[blockIdx.x] = hi;
    c_fast[blockIdx.x] = f;
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 4)
    class_nn_scan(const float* __restrict__ q, const float* __restrict__ q_sq,
                  const float* __restrict__ ref_m,
                  const float* __restrict__ r_sq,
                  const float* __restrict__ key, const float* __restrict__ lo,
                  const float* __restrict__ hi, const float* __restrict__ ex,
                  const float* __restrict__ c_lo,
                  const float* __restrict__ c_hi,
                  const int* __restrict__ c_fast, float* __restrict__ part_d,
                  int* __restrict__ part_i, int q_n, int r_n, int splits) {
  __shared__ Chunk buf[2];
  __shared__ float s_win[2][C][kWarps];
  __shared__ int s_count[kWarps];
  __shared__ int s_list[kThreads];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int split = blockIdx.x;
  const int tile = blockIdx.y;
  const int n_chunks = (r_n + kRC - 1) / kRC;

  // This thread's queries, and the class windows [w_lo, w_hi] of its warp
  // (128 consecutive queries) and of the tile (a NaN bound is no bound, as
  // the compares read it).
  float qx[kQT], qy[kQT], qz[kQT], qs[kQT];
  float wlo[C][kQT], whi[C][kQT], wex[C][kQT], best[C][kQT];
  int idx[C][kQT];
  float w_lo[C], w_hi[C], t_lo[C], t_hi[C];
  bool my_fast = true, my_open = true;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    w_lo[c] = CUDART_INF_F;
    w_hi[c] = -CUDART_INF_F;
  }
#pragma unroll
  for (int a = 0; a < kQT; ++a) {
    const int qi = tile * kTQ + kQT * tid + a;
    const bool in = qi < q_n;
    qx[a] = in ? q[3 * qi] : 0.0f;
    qy[a] = in ? q[3 * qi + 1] : 0.0f;
    qz[a] = in ? q[3 * qi + 2] : 0.0f;
    qs[a] = in ? q_sq[qi] : 0.0f;
    my_fast = my_fast && qs[a] < kFastSq;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float l = in ? lo[c * q_n + qi] : -CUDART_INF_F;
      const float h = in ? hi[c * q_n + qi] : CUDART_INF_F;
      const float e = in ? ex[c * q_n + qi] : -CUDART_INF_F;
      wlo[c][a] = l;
      whi[c][a] = h;
      wex[c][a] = e;
      best[c][a] = CUDART_INF_F;  // torch.min's identity
      idx[c][a] = 0;
      my_open = my_open && l == -CUDART_INF_F && h == CUDART_INF_F &&
                e == -CUDART_INF_F;
      if (in) {
        w_lo[c] = fminf(w_lo[c], l != l ? -CUDART_INF_F : l);
        w_hi[c] = fmaxf(w_hi[c], h != h ? CUDART_INF_F : h);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    for (int off = 16; off > 0; off >>= 1) {
      w_lo[c] = fminf(w_lo[c], __shfl_xor_sync(0xffffffffu, w_lo[c], off));
      w_hi[c] = fmaxf(w_hi[c], __shfl_xor_sync(0xffffffffu, w_hi[c], off));
    }
    if (lane == 0) {
      s_win[0][c][warp] = w_lo[c];
      s_win[1][c][warp] = w_hi[c];
    }
  }
  const bool open = __syncthreads_and(my_open) && C == 1;
  const bool tile_fast = __syncthreads_and(my_fast);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    t_lo[c] = s_win[0][c][0];
    t_hi[c] = s_win[1][c][0];
    for (int w = 1; w < kWarps; ++w) {
      t_lo[c] = fminf(t_lo[c], s_win[0][c][w]);
      t_hi[c] = fmaxf(t_hi[c], s_win[1][c][w]);
    }
  }

  // Whether a chunk's keys meet a class window [wl, wh].
  auto meets = [&](int ch, const float* wl, const float* wh) {
    const float a = c_lo[ch], b = c_hi[ch];
    bool m = false;
#pragma unroll
    for (int c = 0; c < C; ++c) m = m || (b >= wl[c] && a <= wh[c]);
    return m;
  };
  // The chunks the tile searches: chunk 0, every chunk that is not fast,
  // every chunk where the tile has a slow query or chunk 0 is not fast, and
  // fast chunks whose keys meet a class window of the tile.  Skipping the
  // others is exact: for a fast query their every value is 1e30 at an index
  // above chunk 0's, whose own result is (1e30, 0) or better.
  const bool skip_ok = tile_fast && c_fast[0];
  auto needed = [&](int ch) {
    return ch < n_chunks && (ch == 0 || !skip_ok || !c_fast[ch] ||
                             meets(ch, t_lo, t_hi));
  };

  // Staging: chunk ch's reference tid (threads tid < kRC) into registers.
  float4 np = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float nk = 0.0f;
  auto fetch = [&](int ch) {
    const int r = ch * kRC + tid;
    if (tid < kRC && r < r_n) {
      np = make_float4(ref_m[3 * r], ref_m[3 * r + 1], ref_m[3 * r + 2],
                       r_sq[r]);
      nk = key[r];
    }
  };
  auto store = [&](Chunk& b) {
    if (tid < kRC) {
      b.p[tid] = np;
      b.key[tid] = nk;
    }
  };

  // Search the chunks s_list[0, n), in index order, through a two-slot
  // ring: the next chunk's loads are in flight while this one is searched.
  auto search = [&](int n) {
    fetch(s_list[0]);
    store(buf[0]);
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const int ch = s_list[k];
      const int base = ch * kRC;
      const int cnt = min(kRC, r_n - base);
      if (k + 1 < n) fetch(s_list[k + 1]);
      const Chunk& cb = buf[k & 1];
      // A chunk of one key (most chunks of a ring-ordered cloud): the class
      // test is one predicate a (class, query), and a warp none of whose
      // predicates holds skips the chunk.  Every lane votes.
      const float k0 = c_lo[ch];
      const bool one_key = k0 == c_hi[ch];
      bool in[C][kQT], any = false;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int a = 0; a < kQT; ++a) {
          in[c][a] = !(k0 < wlo[c][a]) & !(k0 > whi[c][a]);
          any = any || in[c][a];
        }
      const bool warp_in = __any_sync(0xffffffffu, any);
      if (!(my_fast && c_fast[ch])) {
        for (int j = 0; j < cnt; ++j) {
          const float4 p = cb.p[j];
          const float kj = cb.key[j];
#pragma unroll
          for (int a = 0; a < kQT; ++a) {
            const float d = d_literal(qx[a], qy[a], qz[a], qs[a], p);
#pragma unroll
            for (int c = 0; c < C; ++c) {
              const bool pen = (kj < wlo[c][a]) | (kj > whi[c][a]) |
                               (d <= wex[c][a]);
              const float v = __fadd_rn(d, pen ? kBig : 0.0f);
              if (less_or_nan(v, base + j, best[c][a], idx[c][a])) {
                best[c][a] = v;
                idx[c][a] = base + j;
              }
            }
          }
        }
      } else if (C == 1 && open) {
        int j = 0;
        for (; j + kGroup <= cnt; j += kGroup) {
          float d[kGroup][kQT], nb[kQT];
#pragma unroll
          for (int a = 0; a < kQT; ++a) nb[a] = best[0][a];
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            const float4 p = cb.p[j + g];
#pragma unroll
            for (int a = 0; a < kQT; ++a) {
              d[g][a] = d_fast(qx[a], qy[a], qz[a], qs[a], p);
              nb[a] = fminf(nb[a], d[g][a]);
            }
          }
#pragma unroll
          for (int a = 0; a < kQT; ++a) {
            if (nb[a] < best[0][a]) {
              int g0 = kGroup - 1;
#pragma unroll
              for (int g = kGroup - 2; g >= 0; --g)
                g0 = d[g][a] == nb[a] ? g : g0;
              best[0][a] = nb[a];
              idx[0][a] = base + j + g0;
            }
          }
        }
        for (; j < cnt; ++j) {
          const float4 p = cb.p[j];
#pragma unroll
          for (int a = 0; a < kQT; ++a) {
            const float d = d_fast(qx[a], qy[a], qz[a], qs[a], p);
            if (d < best[0][a]) {
              best[0][a] = d;
              idx[0][a] = base + j;
            }
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int a = 0; a < kQT; ++a)
            if (best[c][a] > kBig) {
              best[c][a] = kBig;
              idx[c][a] = base;
            }
        if (one_key) {
          if (warp_in) {
            for (int j = 0; j < cnt; ++j) {
              const float4 p = cb.p[j];
#pragma unroll
              for (int a = 0; a < kQT; ++a) {
                const float d = d_fast(qx[a], qy[a], qz[a], qs[a], p);
#pragma unroll
                for (int c = 0; c < C; ++c) {
                  const bool take = in[c][a] & !(d <= wex[c][a]) &
                                    (d < best[c][a]);
                  if (take) {
                    best[c][a] = d;
                    idx[c][a] = base + j;
                  }
                }
              }
            }
          }
        } else if (meets(ch, w_lo, w_hi)) {
          for (int j = 0; j < cnt; ++j) {
            const float4 p = cb.p[j];
            const float kj = cb.key[j];
#pragma unroll
            for (int a = 0; a < kQT; ++a) {
              const float d = d_fast(qx[a], qy[a], qz[a], qs[a], p);
#pragma unroll
              for (int c = 0; c < C; ++c) {
                const bool take = !(kj < wlo[c][a]) & !(kj > whi[c][a]) &
                                  !(d <= wex[c][a]) & (d < best[c][a]);
                if (take) {
                  best[c][a] = d;
                  idx[c][a] = base + j;
                }
              }
            }
          }
        }
      }
      if (k + 1 < n) store(buf[(k + 1) & 1]);
      __syncthreads();
    }
  };

  // This split's share of the tile's chunks: the needed ones with ordinal
  // in [first, last), found kThreads chunks a round.
  int total = 0;
  for (int c0 = 0; c0 < n_chunks; c0 += kThreads)
    total += __syncthreads_count(needed(c0 + tid));
  const int first = static_cast<int>(static_cast<long long>(total) * split /
                                     splits);
  const int last = static_cast<int>(static_cast<long long>(total) *
                                    (split + 1) / splits);
  int seen = 0;
  for (int c0 = 0; c0 < n_chunks && seen < last; c0 += kThreads) {
    const int ch = c0 + tid;
    const bool nd = needed(ch);
    const unsigned bal = __ballot_sync(0xffffffffu, nd);
    if (lane == 0) s_count[warp] = __popc(bal);
    __syncthreads();
    int ord = seen, round_n = 0;
    for (int w = 0; w < kWarps; ++w) {
      ord += w < warp ? s_count[w] : 0;
      round_n += s_count[w];
    }
    ord += __popc(bal & ((1u << lane) - 1u));
    const int lo_ord = max(first, seen);
    const int n = min(last, seen + round_n) - lo_ord;
    if (nd && ord >= lo_ord && ord < lo_ord + n) s_list[ord - lo_ord] = ch;
    __syncthreads();
    if (n > 0) search(n);
    seen += round_n;
    __syncthreads();  // s_count and s_list are rewritten next round
  }

#pragma unroll
  for (int a = 0; a < kQT; ++a) {
    const int qi = tile * kTQ + kQT * tid + a;
    if (qi >= q_n) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const size_t at = (static_cast<size_t>(split) * C + c) * q_n + qi;
      part_d[at] = best[c][a];
      part_i[at] = idx[c][a];
    }
  }
}

// kMergeLanes lanes per (class, query) of n = C * q_n: each takes every
// kMergeLanes-th split's partial, then the lanes combine by shuffles, all by
// LessOrNan on (value, index); then torch.clamp(min=0).
__global__ void class_nn_merge(const float* __restrict__ part_d,
                               const int* __restrict__ part_i,
                               float* __restrict__ d_out,
                               int64_t* __restrict__ i_out, int n,
                               int splits) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = g / kMergeLanes;
  const int l = g % kMergeLanes;
  float bv = CUDART_INF_F;  // torch.min's identity
  int bi = 0;
  if (t < n)
    for (int s = l; s < splits; s += kMergeLanes) {
      const float v = part_d[static_cast<size_t>(s) * n + t];
      const int i = part_i[static_cast<size_t>(s) * n + t];
      if (less_or_nan(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
  for (int off = kMergeLanes / 2; off > 0; off >>= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, bv, off);
    const int i = __shfl_xor_sync(0xffffffffu, bi, off);
    if (less_or_nan(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
  if (t < n && l == 0) {
    d_out[t] = bv != bv ? bv : fmaxf(bv, 0.0f);
    i_out[t] = bi;
  }
}

template <int C>
int launch(const float* q, const float* q_sq, const float* ref_m,
           const float* r_sq, const float* key, const float* lo,
           const float* hi, const float* ex, float* chunks, float* part_d,
           int* part_i, float* d_out, int64_t* i_out, int q_n, int r_n,
           int splits, cudaStream_t s) {
  const int tiles = (q_n + kTQ - 1) / kTQ;
  const int n_chunks = (r_n + kRC - 1) / kRC;
  float* c_lo = chunks;
  float* c_hi = chunks + n_chunks;
  int* c_fast = reinterpret_cast<int*>(chunks + 2 * n_chunks);
  class_nn_chunks<<<n_chunks, kRC, 0, s>>>(r_sq, key, c_lo, c_hi, c_fast,
                                            r_n);
  class_nn_scan<C><<<dim3(splits, tiles), kThreads, 0, s>>>(
      q, q_sq, ref_m, r_sq, key, lo, hi, ex, c_lo, c_hi, c_fast, part_d,
      part_i, q_n, r_n, splits);
  const int n = C * q_n;
  class_nn_merge<<<(n * kMergeLanes + 255) / 256, 256, 0, s>>>(
      part_d, part_i, d_out, i_out, n, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int class_nn_launch(const void* q, const void* q_sq,
                               const void* ref_m, const void* r_sq,
                               const void* key, const void* lo,
                               const void* hi, const void* ex, void* chunks,
                               void* part_d, void* part_i, void* d_out,
                               void* i_out, int q_n, int r_n, int n_classes,
                               int splits, void* stream) {
  if (q_n < 1 || r_n < 1 || splits < 1 ||
      splits > (r_n + kRC - 1) / kRC || (q_n + kTQ - 1) / kTQ > 65535 ||
      static_cast<long long>(n_classes) * q_n * kMergeLanes > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidValue);
  auto args = [&](auto kfn) {
    return kfn(static_cast<const float*>(q), static_cast<const float*>(q_sq),
               static_cast<const float*>(ref_m),
               static_cast<const float*>(r_sq),
               static_cast<const float*>(key), static_cast<const float*>(lo),
               static_cast<const float*>(hi), static_cast<const float*>(ex),
               static_cast<float*>(chunks), static_cast<float*>(part_d),
               static_cast<int*>(part_i), static_cast<float*>(d_out),
               static_cast<int64_t*>(i_out), q_n, r_n, splits,
               static_cast<cudaStream_t>(stream));
  };
  switch (n_classes) {
    case 1: return args(launch<1>);
    case 2: return args(launch<2>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Variants of the edge_combine kernel for one measurement: which element of
// its design pays on the card. Each variant computes div_deg/sum (PageRank's
// messages) for one ring round of all shards, as
// src/repro_torch/kernels/csrc/edge_combine.cu does; tools/ec_ablation.py
// builds this file, runs each variant at the main path's shapes and checks it
// against the plain version. Nothing in the package uses it.
//
// Template knobs:
//   PERSIST  persistent grid over a (shard, kept block) work list, else one
//            CTA per (kept-block slot, shard) as in the first port
//   EPT      edges a thread takes at once: 1, 2 or 4
//   STAGE    stage the block's source range in shared memory when it fits
//   ATOM     0: atomics on A_s and cnt; 1: one float2 atomic (A_s, cnt);
//            2: A_s atomic only (no count); 3: plain stores, no atomics
//   WAGG     warp-aggregate equal destinations before the global combine
//   T        threads per CTA
//   STRIDED  a thread's EPT edges lie T apart (coalesced scalar loads),
//            else they are consecutive (one int4 load for EPT 4)
//   LDCS     streaming loads (evict-first) of sp and dp
//   DMASK    if not 0, destinations are masked to d & DMASK: a smaller
//            target row, for timing only (the result is wrong)

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WIN = 2048;  // staged sources per CTA

__device__ __forceinline__ void combine(int atom, float* out, int* cnt,
                                        float2* out2, int64_t d, float m,
                                        float c) {
  if (atom == 0) {
    atomicAdd(&out[d], m);
    atomicAdd(&cnt[d], (int)c);
  } else if (atom == 1) {
    atomicAdd(&out2[d], make_float2(m, c));
  } else if (atom == 2) {
    atomicAdd(&out[d], m);
  } else {
    out[d] = m;
    cnt[d] = (int)c;
  }
}

template <typename P>
__device__ __forceinline__ int ld(const int* p) {
  return P::value ? __ldcs(p) : *p;
}

template <bool PERSIST, int EPT, bool STAGE, int ATOM, bool WAGG, int T,
          bool STRIDED, bool LDCS, int DMASK>
__global__ void __launch_bounds__(T) variant(
    const float* __restrict__ values, const int* __restrict__ degree,
    const uint8_t* __restrict__ active, const int* __restrict__ sp,
    const int* __restrict__ dp, const int* __restrict__ dest,
    const int* __restrict__ blk_ids, const int* __restrict__ n_keep,
    float* __restrict__ out, int* __restrict__ cnt, float2* __restrict__ out2,
    int* __restrict__ staged_blocks, int n, int P, int NB, int BLK) {
  __shared__ float s_msg[STAGE ? WIN : 1];
  __shared__ uint8_t s_act[STAGE ? WIN : 1];
  __shared__ int s_red[2][32];
  __shared__ int s_start[65];
  __shared__ float s_wm[WAGG ? T : 1];
  using CS = std::integral_constant<bool, LDCS>;
  int total;
  if (PERSIST) {
    if (threadIdx.x == 0) {
      int acc = 0;
      for (int i = 0; i < n; ++i) {
        s_start[i] = acc;
        acc += n_keep[i];
      }
      s_start[n] = acc;
    }
    __syncthreads();
    total = s_start[n];
  } else {
    total = 1;
  }
  for (int t = PERSIST ? blockIdx.x : 0; t < total;
       t += PERSIST ? gridDim.x : 1) {
    int i, j;
    if (PERSIST) {
      i = 0;
      while (s_start[i + 1] <= t) ++i;
      j = t - s_start[i];
    } else {
      i = blockIdx.y;
      j = blockIdx.x;
      if (j >= n_keep[i]) return;
    }
    const int64_t b = blk_ids[(int64_t)i * NB + j];
    const int64_t base = (((int64_t)i * n + dest[i]) * NB + b) * BLK;
    const int64_t row = (int64_t)i * P;
    // edges of this thread: EPT consecutive slots per step
    int lo = P, hi = -1;
    if (STAGE) {
      for (int e = threadIdx.x * EPT; e < BLK; e += T * EPT) {
#pragma unroll
        for (int k = 0; k < EPT; ++k) {
          const int s = sp[base + e + k];
          if (s >= 0) {
            lo = min(lo, s);
            hi = max(hi, s);
          }
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
      }
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      if (lane == 0) {
        s_red[0][warp] = lo;
        s_red[1][warp] = hi;
      }
      __syncthreads();
      lo = P;
      hi = -1;
      for (int w = 0; w < T / 32; ++w) {
        lo = min(lo, s_red[0][w]);
        hi = max(hi, s_red[1][w]);
      }
    }
    const bool staged = STAGE && hi >= lo && hi - lo < WIN;
    if (STAGE && staged) {
      for (int s = lo + threadIdx.x; s <= hi; s += T) {
        const uint8_t a = active[row + s];
        s_act[s - lo] = a;
        if (a) s_msg[s - lo] = values[row + s] / (float)max(degree[row + s], 1);
      }
      if (threadIdx.x == 0) atomicAdd(staged_blocks, 1);
    }
    if (STAGE) __syncthreads();
    for (int e = STRIDED ? threadIdx.x : threadIdx.x * EPT; e < BLK;
         e += T * EPT) {
      int s[EPT], d[EPT];
      bool a[EPT];
      float m[EPT];
      if constexpr (EPT == 4 && !STRIDED) {
        const int4 q = LDCS ? __ldcs(reinterpret_cast<const int4*>(sp + base + e))
                            : *reinterpret_cast<const int4*>(sp + base + e);
        s[0] = q.x; s[1] = q.y; s[2] = q.z; s[3] = q.w;
      } else {
#pragma unroll
        for (int k = 0; k < EPT; ++k) {
          const int x = STRIDED ? e + k * T : e + k;
          s[k] = x < BLK ? ld<CS>(sp + base + x) : -1;
        }
      }
#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        if (staged) {
          a[k] = s[k] >= 0 && s_act[s[k] - lo];
          if (a[k]) m[k] = s_msg[s[k] - lo];
        } else {
          a[k] = s[k] >= 0 && active[row + s[k]];
          if (a[k])
            m[k] = values[row + s[k]] / (float)max(degree[row + s[k]], 1);
        }
      }
      bool any = false;
#pragma unroll
      for (int k = 0; k < EPT; ++k) any |= a[k];
      if constexpr (EPT == 4 && !STRIDED) {
        if (any) {
          const int4 q =
              LDCS ? __ldcs(reinterpret_cast<const int4*>(dp + base + e))
                   : *reinterpret_cast<const int4*>(dp + base + e);
          d[0] = q.x; d[1] = q.y; d[2] = q.z; d[3] = q.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < EPT; ++k) {
          const int x = STRIDED ? e + k * T : e + k;
          if (a[k]) d[k] = ld<CS>(dp + base + x);
        }
      }
      if constexpr (DMASK != 0) {
#pragma unroll
        for (int k = 0; k < EPT; ++k) d[k] &= DMASK;
      }
#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        if (WAGG) {
          const int key = a[k] ? d[k] : -1;
          const unsigned peers = __match_any_sync(__activemask(), key);
          const int lane = threadIdx.x & 31;
          s_wm[threadIdx.x] = a[k] ? m[k] : 0.f;
          __syncwarp(__activemask());
          const int leader = __ffs(peers) - 1;
          if (a[k] && lane == leader) {
            float sum = 0.f;
            for (unsigned p = peers; p; p &= p - 1)
              sum += s_wm[(threadIdx.x & ~31) + __ffs(p) - 1];
            combine(ATOM, out, cnt, out2, row + d[k], sum,
                    (float)__popc(peers));
          }
          __syncwarp(__activemask());
        } else if (a[k]) {
          combine(ATOM, out, cnt, out2, row + d[k], m[k], 1.f);
        }
      }
    }
    if (STAGE) __syncthreads();  // s_msg is rewritten by the next item
  }
}

template <bool PERSIST, int EPT, bool STAGE, int ATOM, bool WAGG, int T,
          bool STRIDED, bool LDCS, int DMASK>
int run(const void* values, const void* degree, const void* active,
        const void* sp, const void* dp, const void* dest, const void* blk_ids,
        const void* n_keep, void* out, void* cnt, void* out2, void* staged,
        int n, int P, int NB, int BLK, int ctas, cudaStream_t stream) {
  dim3 grid = PERSIST ? dim3(ctas) : dim3(NB, n);
  variant<PERSIST, EPT, STAGE, ATOM, WAGG, T, STRIDED, LDCS, DMASK>
      <<<grid, T, 0, stream>>>(
      (const float*)values, (const int*)degree, (const uint8_t*)active,
      (const int*)sp, (const int*)dp, (const int*)dest, (const int*)blk_ids,
      (const int*)n_keep, (float*)out, (int*)cnt, (float2*)out2,
      (int*)staged, n, P, NB, BLK);
  return (int)cudaGetLastError();
}

template <bool PERSIST, int EPT, bool STAGE, int ATOM, bool WAGG, int T,
          bool STRIDED, bool LDCS, int DMASK>
int occupancy() {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks,
      variant<PERSIST, EPT, STAGE, ATOM, WAGG, T, STRIDED, LDCS, DMASK>, T,
      0);
  return blocks;
}

__global__ void split_k(const float2* __restrict__ pairs,
                        float* __restrict__ out, int* __restrict__ cnt,
                        int64_t N) {
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < N;
       e += (int64_t)gridDim.x * blockDim.x) {
    const float2 p = __ldcs(pairs + e);
    __stcs(out + e, p.x);
    __stcs(cnt + e, (int)p.y);
  }
}

// the ring's digest reading the pairs directly: out = a + pairs.x,
// ocnt = c + pairs.y
__global__ void digest_pairs_k(const float* __restrict__ a,
                               const int* __restrict__ c,
                               const float2* __restrict__ pairs,
                               float* __restrict__ out, int* __restrict__ ocnt,
                               int64_t N) {
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < N;
       e += (int64_t)gridDim.x * blockDim.x) {
    const float2 p = __ldcs(pairs + e);
    __stcs(out + e, __ldcs(a + e) + p.x);
    __stcs(ocnt + e, __ldcs(c + e) + (int)p.y);
  }
}

}  // namespace

// v: PERSIST, EPT, STAGE, ATOM, WAGG, T, STRIDED, LDCS, DMASK
#define VARIANTS(X)                                             \
  X(0, false, 1, false, 0, false, 512, false, false, 0)        \
  X(1, false, 1, false, 2, false, 512, false, false, 0)        \
  X(2, false, 1, false, 3, false, 512, false, false, 0)        \
  X(3, false, 1, false, 1, false, 512, false, false, 0)        \
  X(4, false, 4, false, 0, false, 128, false, false, 0)        \
  X(5, true, 4, false, 0, false, 128, false, false, 0)         \
  X(6, true, 4, true, 0, false, 128, false, false, 0)          \
  X(7, true, 4, false, 1, false, 128, false, false, 0)         \
  X(8, true, 4, true, 1, false, 128, false, false, 0)          \
  X(9, true, 4, false, 1, true, 128, false, false, 0)          \
  X(10, true, 4, false, 3, false, 128, false, false, 0)        \
  X(11, true, 1, false, 0, false, 512, false, false, 0)        \
  X(12, true, 1, false, 1, false, 512, false, false, 0)        \
  X(13, true, 4, false, 0, false, 128, true, false, 0)         \
  X(14, true, 4, false, 1, false, 128, true, false, 0)         \
  X(15, true, 1, false, 1, false, 256, false, false, 0)        \
  X(16, true, 1, false, 1, false, 512, false, true, 0)         \
  X(17, true, 2, false, 1, false, 256, true, true, 0)          \
  X(18, true, 1, false, 1, false, 512, false, true, 0xFFFF)    \
  X(19, true, 1, false, 1, false, 512, false, true, 0x7FFFF)   \
  X(20, true, 1, false, 0, false, 512, false, true, 0)

extern "C" {

// Variant v (see VARIANTS) on one ring round; ctas = persistent grid
// size. Returns cudaGetLastError() after the launch, -1 for an unknown v.
int ec_variant(int v, const void* values, const void* degree,
               const void* active, const void* sp, const void* dp,
               const void* dest, const void* blk_ids, const void* n_keep,
               void* out, void* cnt, void* out2, void* staged, int n, int P,
               int NB, int BLK, int ctas, void* stream) {
#define CASE(V, A, B, C, D, E, F, G, H, I)                               \
  case V:                                                                \
    return run<A, B, C, D, E, F, G, H, I>(                               \
        values, degree, active, sp, dp, dest, blk_ids, n_keep, out, cnt, \
        out2, staged, n, P, NB, BLK, ctas, (cudaStream_t)stream);
  switch (v) { VARIANTS(CASE) }
#undef CASE
  return -1;
}

// (A_s, cnt) from the pairs, one slot a thread; grid of ctas x 256.
int ec_split(const void* pairs, void* out, void* cnt, long long N, int ctas,
             void* stream) {
  split_k<<<ctas, 256, 0, (cudaStream_t)stream>>>(
      (const float2*)pairs, (float*)out, (int*)cnt, N);
  return (int)cudaGetLastError();
}

// The ring digest reading the pairs in place of (A_s, cnt).
int ec_digest_pairs(const void* a, const void* c, const void* pairs,
                    void* out, void* ocnt, long long N, int ctas,
                    void* stream) {
  digest_pairs_k<<<ctas, 256, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const int*)c, (const float2*)pairs, (float*)out,
      (int*)ocnt, N);
  return (int)cudaGetLastError();
}

// Resident CTAs per SM of variant v.
int ec_variant_occupancy(int v) {
#define CASE(V, A, B, C, D, E, F, G, H, I) \
  case V:                                  \
    return occupancy<A, B, C, D, E, F, G, H, I>();
  switch (v) { VARIANTS(CASE) }
#undef CASE
  return -1;
}

}  // extern "C"

// edge_combine: the fused U_c step of the IO-Recoded superstep (paper §5),
// for all n shards of one ring round at once. Contract, bounds and design:
// see repro_torch/kernels/edge_combine.py, which binds this file through
// ctypes (plain C entry points, no PyTorch headers).
//
// One C call enqueues the whole step on the caller's stream: the pre-fill
// of the outputs, the combine kernel and, on the paired path, the split.
//
// The combine kernel runs a persistent grid (resident CTAs per SM x SMs).
// Its work list is every shard's kept blocks in a row, shard 0's first:
// item t is block slot t - start[i] of shard i, where start is the prefix
// of n_keep, which each CTA sums itself, so nothing syncs with the host
// and a grid of returning CTAs costs nothing when few blocks are kept.
// CTA c takes items c, c + grid, ...: at any time the grid works on about
// one shard's row of A_s. A thread takes one slot of a block (a block of
// more than THREADS slots, the next one THREADS on): it loads sp, gathers
// the source's active flag and state, and for an active source loads dp
// (and w) and combines. Four slots a thread (CTAs of 128) were faster with
// few active sources but slower on the dense two-atomic path, and no
// faster end to end; staging a block's source range in shared memory and
// aggregating a warp's equal destinations were no faster (PERF.md). Padding
// slots (sp = -1) and inactive sources do nothing. Edge slots are read with
// streaming loads (evict-first): nothing reads them twice.
//
// Combines are global atomics, and their number, not bytes, is what bounds
// the kernel: the L2 takes each scattered update as its own transaction
// (plain stores in their place measured slower still, tools/ec_ablation.py).
// Float min/max use the ordered-int trick: for a value with the sign bit
// clear, int order is float order (atomicMin/Max on the int bits); for one
// with it set, unsigned order is reversed float order (atomicMax/Min on the
// unsigned bits). Elsewhere the message and its count take one atomic each,
// except on the paired path.
//
// The paired path (float sum with E_cap below 2^24, chosen on the card for
// a launch with many messages) carries the message and its count as one
// float2 atomicAdd into an interleaved (n, P, 2) buffer: half the atomics.
// The count is a float that stays exact, since no destination of a group
// receives more than E_cap messages. A split pass then writes A_s and the
// int32 counts, which costs 16 B per vertex slot whatever the messages, so
// the path pays only for a launch with many messages. Which launch that is,
// the card decides without a host sync: count_active sums the active flags
// (A), and a launch takes the pairs when its messages, about A / P x E_cap
// per row at most, would be at least half the row's slots (see uses_pairs).
//
// Float sums land in the order the atomics reach L2, which changes from run
// to run, so they are not bit-reproducible; min, max, int32 and the counts
// are exact.

#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

namespace {

enum Kind { K_DIV_DEG = 0, K_ADD_W = 1, K_ADD_1 = 2, K_COPY = 3, K_DEG = 4 };
enum Comb { C_SUM = 0, C_MIN = 1, C_MAX = 2 };
constexpr int THREADS = 512;

__device__ __forceinline__ void atomic_min_f32(float* a, float v) {
  if (__float_as_int(v) >= 0) {  // sign bit clear
    atomicMin(reinterpret_cast<int*>(a), __float_as_int(v));
  } else {
    atomicMax(reinterpret_cast<unsigned int*>(a), __float_as_uint(v));
  }
}

__device__ __forceinline__ void atomic_max_f32(float* a, float v) {
  if (__float_as_int(v) >= 0) {  // sign bit clear
    atomicMax(reinterpret_cast<int*>(a), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(a), __float_as_uint(v));
  }
}

template <int C>
__device__ __forceinline__ void combine(float* a, float v) {
  if constexpr (C == C_SUM) {
    atomicAdd(a, v);
  } else if constexpr (C == C_MIN) {
    atomic_min_f32(a, v);
  } else {
    atomic_max_f32(a, v);
  }
}

template <int C>
__device__ __forceinline__ void combine(int* a, int v) {
  if constexpr (C == C_SUM) {
    atomicAdd(a, v);
  } else if constexpr (C == C_MIN) {
    atomicMin(a, v);
  } else {
    atomicMax(a, v);
  }
}

// The paired path pays when a launch's messages would be at least half of
// its n * P vertex slots: the split's 16 B a slot cost about half of what a
// saved atomic does (tools/ec_ablation.py). A shard row of a launch holds
// at most E_cap edges, and with A of the n * P sources active about
// A / (n * P) of them carry a message: n * E_cap * A / (n * P) >= n * P / 2.
__device__ __forceinline__ bool uses_pairs(const unsigned* active_count,
                                           int n, int P, int64_t E_cap) {
  return 2 * (int64_t)*active_count * E_cap >= (int64_t)n * P * P;
}

// sum of the bool bytes active[0, N) into *count (zeroed by the caller)
__global__ void count_active(const uint8_t* __restrict__ active, int64_t N,
                             unsigned* __restrict__ count) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned c = 0;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(active);
  const int64_t n4 = (uintptr_t)active % 4 ? 0 : N / 4;  // aligned words
  for (int64_t q = tid; q < n4; q += stride)
    c += (__ldcs(words + q) * 0x01010101u) >> 24;  // bytes are 0 or 1
  for (int64_t e = n4 * 4 + tid; e < N; e += stride) c += active[e];
  c = __reduce_add_sync(0xffffffffu, c);
  if ((threadIdx.x & 31) == 0 && c) atomicAdd(count, c);
}

// zero the pairs (paired path) or A_s and cnt (float sum's identity is 0)
__global__ void zero_outputs(float* __restrict__ out, int* __restrict__ cnt,
                             float2* __restrict__ pairs, int64_t N,
                             const unsigned* __restrict__ active_count, int n,
                             int P, int64_t E_cap) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (uses_pairs(active_count, n, P, E_cap)) {
    for (int64_t e = tid; e < N; e += stride)
      __stcs(pairs + e, make_float2(0.f, 0.f));
  } else {
    for (int64_t e = tid; e < N; e += stride) {
      __stcs(out + e, 0.f);
      __stcs(cnt + e, 0);
    }
  }
}

// the combiner identity's bits, for the pre-fill of A_s
template <typename V, int C>
__host__ uint32_t identity_bits() {
  if constexpr (C == C_SUM) return 0u;
  if constexpr (std::is_same<V, int>::value)
    return C == C_MIN ? 0x7fffffffu : 0x80000000u;
  return C == C_MIN ? 0x7f800000u : 0xff800000u;  // +inf, -inf
}

__global__ void fill_u32(uint32_t* __restrict__ p, uint32_t v, int64_t N) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < N;
       e += stride)
    __stcs(p + e, v);
}

// A_s and the int32 counts from the pairs, on the paired path
__global__ void split_pairs(const float2* __restrict__ pairs,
                            float* __restrict__ out, int* __restrict__ cnt,
                            int64_t N,
                            const unsigned* __restrict__ active_count, int n,
                            int P, int64_t E_cap) {
  if (!uses_pairs(active_count, n, P, E_cap)) return;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < N;
       e += stride) {
    const float2 p = __ldcs(pairs + e);
    __stcs(out + e, p.x);
    __stcs(cnt + e, (int)p.y);
  }
}

// PAIRS: float sum that may take the paired path (active_count decides)
template <typename V, int K, int C, bool PAIRS>
__global__ void __launch_bounds__(THREADS) edge_combine_kernel(
    const V* __restrict__ values,         // (n, P)
    const int* __restrict__ degree,       // (n, P)
    const uint8_t* __restrict__ active,   // (n, P) bool
    const int* __restrict__ sp,           // (n, n, NB, BLK)
    const int* __restrict__ dp,           // (n, n, NB, BLK)
    const float* __restrict__ w,          // (n, n, NB, BLK)
    const int* __restrict__ dest,         // (n,)
    const int* __restrict__ blk_ids,      // (n, NB)
    const int* __restrict__ n_keep,       // (n,)
    V* __restrict__ out,                  // (n, P), pre-filled with e0
    int* __restrict__ cnt,                // (n, P), pre-filled with 0
    float2* __restrict__ pairs,           // (n, P), zeroed on the paired path
    const unsigned* __restrict__ active_count,  // PAIRS only
    int n, int P, int NB, int BLK) {
  extern __shared__ int start[];  // (n + 1,) prefix of n_keep
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int i = 0; i < n; ++i) {
      start[i] = acc;
      acc += n_keep[i];
    }
    start[n] = acc;
  }
  __syncthreads();
  const bool paired =
      PAIRS && uses_pairs(active_count, n, P, (int64_t)NB * BLK);
  const int total = start[n];
  int i = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    while (start[i + 1] <= t) ++i;  // t only grows: i moves forward
    const int64_t b = blk_ids[(int64_t)i * NB + (t - start[i])];
    const int64_t base = (((int64_t)i * n + dest[i]) * NB + b) * BLK;
    const int64_t row = (int64_t)i * P;
    for (int e = threadIdx.x; e < BLK; e += THREADS) {
      const int s = __ldcs(sp + base + e);
      if (s < 0 || !active[row + s]) continue;
      const int64_t v = row + s;
      V m;
      if constexpr (std::is_same<V, int>::value) {
        m = values[v];  // int32 takes K_COPY only
      } else if constexpr (K == K_DIV_DEG) {
        m = values[v] / (float)max(degree[v], 1);
      } else if constexpr (K == K_ADD_W) {
        m = values[v] + __ldcs(w + base + e);
      } else if constexpr (K == K_ADD_1) {
        m = values[v] + 1.0f;
      } else if constexpr (K == K_COPY) {
        m = values[v];
      } else {
        m = (float)degree[v];
      }
      const int64_t d = row + __ldcs(dp + base + e);
      if constexpr (PAIRS) {
        if (paired) {
          atomicAdd(&pairs[d], make_float2(m, 1.0f));
          continue;
        }
      }
      combine<C>(&out[d], m);
      atomicAdd(&cnt[d], 1);
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <typename V, int K, int C, bool PAIRS>
int launch(const void* values, const void* degree, const void* active,
           const void* sp, const void* dp, const void* w, const void* dest,
           const void* blk_ids, const void* n_keep, void* out, void* cnt,
           void* pairs, void* active_count, int n, int P, int NB, int BLK,
           cudaStream_t stream) {
  const size_t smem = sizeof(int) * (n + 1);
  static int per_sm = 0;
  if (per_sm == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, edge_combine_kernel<V, K, C, PAIRS>, THREADS, smem);
  const int64_t N = (int64_t)n * P;
  const int64_t E_cap = (int64_t)NB * BLK;
  const int pass_ctas = sm_count() * 4;
  auto* count = static_cast<unsigned*>(active_count);
  if constexpr (PAIRS) {
    cudaMemsetAsync(count, 0, sizeof(unsigned), stream);
    count_active<<<pass_ctas, 256, 0, stream>>>(
        static_cast<const uint8_t*>(active), N, count);
    zero_outputs<<<pass_ctas, 256, 0, stream>>>(
        static_cast<float*>(out), static_cast<int*>(cnt),
        static_cast<float2*>(pairs), N, count, n, P, E_cap);
  } else {
    fill_u32<<<pass_ctas, 256, 0, stream>>>(static_cast<uint32_t*>(out),
                                            identity_bits<V, C>(), N);
    cudaMemsetAsync(cnt, 0, sizeof(int) * N, stream);
  }
  const int ctas = sm_count() * (per_sm > 0 ? per_sm : 1);
  edge_combine_kernel<V, K, C, PAIRS><<<ctas, THREADS, smem, stream>>>(
      static_cast<const V*>(values), static_cast<const int*>(degree),
      static_cast<const uint8_t*>(active), static_cast<const int*>(sp),
      static_cast<const int*>(dp), static_cast<const float*>(w),
      static_cast<const int*>(dest), static_cast<const int*>(blk_ids),
      static_cast<const int*>(n_keep), static_cast<V*>(out),
      static_cast<int*>(cnt), static_cast<float2*>(pairs), count, n, P, NB,
      BLK);
  if constexpr (PAIRS)
    split_pairs<<<pass_ctas, 256, 0, stream>>>(
        static_cast<const float2*>(pairs), static_cast<float*>(out),
        static_cast<int*>(cnt), N, count, n, P, E_cap);
  return (int)cudaGetLastError();
}

}  // namespace

#define EC_ARGS values, degree, active, sp, dp, w, dest, blk_ids, n_keep, \
                out, cnt, pairs, active_count, n, P, NB, BLK,             \
                (cudaStream_t)stream
#define EC_PARAMS const void *values, const void *degree, const void *active, \
                  const void *sp, const void *dp, const void *w,             \
                  const void *dest, const void *blk_ids, const void *n_keep, \
                  void *out, void *cnt, void *pairs, void *active_count,     \
                  int n, int P, int NB, int BLK

extern "C" {

// kind: 0 div_deg, 1 add_w, 2 add_1, 3 copy, 4 deg; comb: 0 sum, 1 min,
// 2 max. pairs_ok != 0 (float sum only) lets the card take the paired path:
// pairs is then a (n, P, 2) float32 scratch buffer and active_count one
// uint32 of scratch; otherwise both are unused. Returns cudaGetLastError()
// after the launches (0 = cudaSuccess); -1 for an unknown kind/comb, or
// pairs_ok with another combiner.
int edge_combine_f32(EC_PARAMS, int kind, int comb, int pairs_ok,
                     void* stream) {
  if (n == 0) return 0;
  if (pairs_ok) {
    if (comb != C_SUM) return -1;
    switch (kind) {
      case 0: return launch<float, 0, C_SUM, true>(EC_ARGS);
      case 1: return launch<float, 1, C_SUM, true>(EC_ARGS);
      case 2: return launch<float, 2, C_SUM, true>(EC_ARGS);
      case 3: return launch<float, 3, C_SUM, true>(EC_ARGS);
      case 4: return launch<float, 4, C_SUM, true>(EC_ARGS);
    }
    return -1;
  }
#define EC_CASE(K, C) \
  case K * 3 + C:     \
    return launch<float, K, C, false>(EC_ARGS);
  switch (kind * 3 + comb) {
    EC_CASE(0, 0) EC_CASE(0, 1) EC_CASE(0, 2)
    EC_CASE(1, 0) EC_CASE(1, 1) EC_CASE(1, 2)
    EC_CASE(2, 0) EC_CASE(2, 1) EC_CASE(2, 2)
    EC_CASE(3, 0) EC_CASE(3, 1) EC_CASE(3, 2)
    EC_CASE(4, 0) EC_CASE(4, 1) EC_CASE(4, 2)
  }
#undef EC_CASE
  return -1;
}

// int32 values: message kind copy only.
int edge_combine_i32(EC_PARAMS, int comb, void* stream) {
  if (n == 0) return 0;
  switch (comb) {
    case 0: return launch<int, K_COPY, 0, false>(EC_ARGS);
    case 1: return launch<int, K_COPY, 1, false>(EC_ARGS);
    case 2: return launch<int, K_COPY, 2, false>(EC_ARGS);
  }
  return -1;
}

const char* edge_combine_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

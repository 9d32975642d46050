// edge_combine: the fused U_c step of the IO-Recoded superstep (paper §5),
// for all n shards of one ring round at once. Contract, bounds and design:
// see repro_torch/kernels/edge_combine.py, which binds this file through
// ctypes (plain C entry points, no PyTorch headers).
//
// Grid (NB, n): CTA (j, i) takes shard i's kept-block slot j of group
// (i, dest[i]); a slot j >= n_keep[i] returns at once. Each thread walks the
// block's edges with stride blockDim.x: it gathers the source's active flag
// (and value, degree or weight as the message kind needs), forms the message
// and combines it into out[i, dst] with a global atomic, counting it in
// cnt[i, dst]. The caller pre-fills out with the combiner's identity and
// cnt with 0. Padding slots (sp = -1) and inactive sources do nothing.
//
// Float min/max use the ordered-int trick: for a value with the sign bit
// clear, int order is float order (atomicMin/Max on the int bits); for one
// with it set, unsigned order is reversed float order (atomicMax/Min on the
// unsigned bits). Float sum uses atomicAdd, whose order changes from run to
// run, so float sums are not bit-reproducible; min, max, int32 and the
// counts are exact.

#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

namespace {

enum Kind { K_DIV_DEG = 0, K_ADD_W = 1, K_ADD_1 = 2, K_COPY = 3, K_DEG = 4 };
enum Comb { C_SUM = 0, C_MIN = 1, C_MAX = 2 };

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

template <typename V, int K, int C>
__global__ void edge_combine_kernel(
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
    int n, int P, int NB, int BLK) {
  const int i = blockIdx.y;
  const int j = blockIdx.x;
  if (j >= n_keep[i]) return;
  const int64_t b = blk_ids[(int64_t)i * NB + j];
  const int64_t base = (((int64_t)i * n + dest[i]) * NB + b) * BLK;
  const int64_t row = (int64_t)i * P;
  for (int e = threadIdx.x; e < BLK; e += blockDim.x) {
    const int s = sp[base + e];
    if (s < 0 || !active[row + s]) continue;
    V m;
    if constexpr (std::is_same<V, int>::value) {
      m = values[row + s];  // int32 takes K_COPY only
    } else if constexpr (K == K_DIV_DEG) {
      m = values[row + s] / (float)max(degree[row + s], 1);
    } else if constexpr (K == K_ADD_W) {
      m = values[row + s] + w[base + e];
    } else if constexpr (K == K_ADD_1) {
      m = values[row + s] + 1.0f;
    } else if constexpr (K == K_COPY) {
      m = values[row + s];
    } else {
      m = (float)degree[row + s];
    }
    const int64_t d = row + dp[base + e];
    combine<C>(&out[d], m);
    atomicAdd(&cnt[d], 1);
  }
}

template <typename V, int K, int C>
int launch(const void* values, const void* degree, const void* active,
           const void* sp, const void* dp, const void* w, const void* dest,
           const void* blk_ids, const void* n_keep, void* out, void* cnt,
           int n, int P, int NB, int BLK, cudaStream_t stream) {
  const dim3 grid(NB, n);
  const int threads = BLK < 512 ? BLK : 512;
  edge_combine_kernel<V, K, C><<<grid, threads, 0, stream>>>(
      static_cast<const V*>(values), static_cast<const int*>(degree),
      static_cast<const uint8_t*>(active), static_cast<const int*>(sp),
      static_cast<const int*>(dp), static_cast<const float*>(w),
      static_cast<const int*>(dest), static_cast<const int*>(blk_ids),
      static_cast<const int*>(n_keep), static_cast<V*>(out),
      static_cast<int*>(cnt), n, P, NB, BLK);
  return (int)cudaGetLastError();
}

}  // namespace

#define EC_ARGS values, degree, active, sp, dp, w, dest, blk_ids, n_keep, \
                out, cnt, n, P, NB, BLK, (cudaStream_t)stream
#define EC_PARAMS const void *values, const void *degree, const void *active, \
                  const void *sp, const void *dp, const void *w,             \
                  const void *dest, const void *blk_ids, const void *n_keep, \
                  void *out, void *cnt, int n, int P, int NB, int BLK

extern "C" {

// kind: 0 div_deg, 1 add_w, 2 add_1, 3 copy, 4 deg; comb: 0 sum, 1 min, 2 max.
// Returns cudaGetLastError() after the launch (0 = cudaSuccess); -1 for an
// unknown kind/comb.
int edge_combine_f32(EC_PARAMS, int kind, int comb, void* stream) {
  if (NB == 0 || n == 0) return 0;
#define EC_CASE(K, C) \
  case K * 3 + C:     \
    return launch<float, K, C>(EC_ARGS);
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
  if (NB == 0 || n == 0) return 0;
  switch (comb) {
    case 0: return launch<int, K_COPY, 0>(EC_ARGS);
    case 1: return launch<int, K_COPY, 1>(EC_ARGS);
    case 2: return launch<int, K_COPY, 2>(EC_ARGS);
  }
  return -1;
}

const char* edge_combine_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

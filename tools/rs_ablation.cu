// The earlier designs of run_sum, for one measurement: what each element of
// the kernel in src/repro_torch/kernels/csrc/run_sum.cu buys on the card.
// tools/rs_ablation.py builds this file beside that one and
// tools/rs_warp_list.cu, runs each at the main path's shapes and checks it
// against the plain version. Nothing in the package uses it.
//
// * rs_gather_walk: the first design. A gather kernel copies each
//   position's flat int64 key and value into scratch in position order;
//   then one thread a position, and the thread at a run's first position
//   adds the run from scratch, 16 positions a step.
// * rs_walk_perm: the same walk reading through the permutation, with no
//   gather and no scratch: the random reads sit on each run's chain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int STEP = 16;

template <typename Perm>
__global__ void __launch_bounds__(THREADS)
gather_kernel(long long* __restrict__ skey, float* __restrict__ sval,
              const long long* __restrict__ key,
              const float* __restrict__ val, const Perm* __restrict__ perm,
              long long E) {
  const long long x = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (x >= E) return;
  const long long row = static_cast<long long>(blockIdx.y) * E;
  const long long p = row + static_cast<long long>(perm[row + x]);
  skey[row + x] = key[p];
  sval[row + x] = val[p];
}

__global__ void __launch_bounds__(THREADS)
walk_kernel(float* __restrict__ out, const long long* __restrict__ key,
            const float* __restrict__ val, long long M, bool accumulate) {
  const long long j = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (j >= M) return;
  const long long k = key[j];
  if (k < 0 || (j > 0 && key[j - 1] == k)) return;
  float acc = accumulate ? out[k] : 0.f;
  for (long long i = j; i < M; i += STEP) {
    long long ks[STEP];
    float vs[STEP];
#pragma unroll
    for (int t = 0; t < STEP; ++t) {
      const bool in = i + t < M;
      ks[t] = in ? key[i + t] : -2;
      vs[t] = in ? val[i + t] : 0.f;
    }
#pragma unroll
    for (int t = 0; t < STEP; ++t) {
      if (ks[t] != k) {
        out[k] = acc;
        return;
      }
      acc = __fadd_rn(acc, vs[t]);
    }
  }
  out[k] = acc;
}

template <typename Perm>
__device__ __forceinline__ long long at(const Perm* perm, long long j,
                                        long long E) {
  return j / E * E + static_cast<long long>(perm[j]);
}

template <typename Perm>
__global__ void __launch_bounds__(THREADS)
walk_perm_kernel(float* __restrict__ out, const long long* __restrict__ key,
                 const float* __restrict__ val, const Perm* __restrict__ perm,
                 long long E, long long M, bool accumulate) {
  const long long j = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (j >= M) return;
  const long long k = key[at(perm, j, E)];
  if (k < 0 || (j > 0 && key[at(perm, j - 1, E)] == k)) return;
  float acc = accumulate ? out[k] : 0.f;
  for (long long i = j; i < M; i += STEP) {
    long long ks[STEP];
    float vs[STEP];
#pragma unroll
    for (int t = 0; t < STEP; ++t) {
      const bool in = i + t < M;
      const long long s = in ? at(perm, i + t, E) : 0;
      ks[t] = in ? key[s] : -2;
      vs[t] = in ? val[s] : 0.f;
    }
#pragma unroll
    for (int t = 0; t < STEP; ++t) {
      if (ks[t] != k) {
        out[k] = acc;
        return;
      }
      acc = __fadd_rn(acc, vs[t]);
    }
  }
  out[k] = acc;
}

}  // namespace

extern "C" {

// perm: int32 row-relative slots; skey/sval: M int64 and M float32.
int rs_gather_walk(void* out, const void* key, const void* val,
                   const void* perm, long long E, long long M, void* skey,
                   void* sval, int accumulate, void* stream) {
  if (M <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto sk = static_cast<long long*>(skey);
  auto sv = static_cast<float*>(sval);
  dim3 grid(static_cast<unsigned>((E + THREADS - 1) / THREADS),
            static_cast<unsigned>(M / E));
  gather_kernel<int32_t><<<grid, THREADS, 0, s>>>(
      sk, sv, static_cast<const long long*>(key),
      static_cast<const float*>(val), static_cast<const int32_t*>(perm), E);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  walk_kernel<<<static_cast<unsigned>((M + THREADS - 1) / THREADS), THREADS,
                0, s>>>(static_cast<float*>(out), sk, sv, M, accumulate != 0);
  return static_cast<int>(cudaGetLastError());
}

int rs_walk_perm(void* out, const void* key, const void* val,
                 const void* perm, long long E, long long M, int accumulate,
                 void* stream) {
  if (M <= 0) return 0;
  walk_perm_kernel<int32_t>
      <<<static_cast<unsigned>((M + THREADS - 1) / THREADS), THREADS, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<float*>(out), static_cast<const long long*>(key),
          static_cast<const float*>(val), static_cast<const int32_t*>(perm),
          E, M, accumulate != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

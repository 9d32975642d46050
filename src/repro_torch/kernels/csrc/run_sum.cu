// run_sum: float32 sums of keyed values in one stated order, the same order
// on the card as PyTorch's index_add_ takes on the CPU. Contract, bounds and
// design: see repro_torch/kernels/run_sum.py, which binds this file through
// ctypes (plain C entry points, no PyTorch headers).
//
// Input: M positions of a (rows, E) layout, in destination order. Position
// j reads its value and its key directly, or through a row-relative
// permutation (row r = j / E, slot perm[j] of that row); keys >= 0 stand in
// runs, one run a key, and a key of -1 is skipped. Output: out[k] =
// ((0 + v_1) + v_2) + ... over the run of key k, left to right; the wrapper
// zero-fills out first.
//
// One C call enqueues up to two kernels on the caller's stream:
//
// * gather (with a permutation only): one thread a position copies its key
//   and value into scratch in position order. The random reads all happen
//   here, every one independent, so the card has them all in flight at
//   once; the sums that follow read memory in order.
// * walk: one thread a position. The thread at a run's first position adds
//   the run left to right in one register, 16 positions a step (their keys
//   and values loaded together, then added one by one up to the run's end),
//   and writes the sum; every other thread exits at once. A run's additions
//   are one chain whatever its length, so a hub's run of tens of thousands
//   of values is one thread's walk over contiguous memory, never split,
//   since any split would add in another order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int STEP = 16;  // positions a walking thread loads at once

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
            const float* __restrict__ val, long long M) {
  const long long j = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (j >= M) return;
  const long long k = key[j];
  if (k < 0 || (j > 0 && key[j - 1] == k)) return;  // not a run's start
  float acc = 0.f;
  for (long long i = j; i < M; i += STEP) {
    long long ks[STEP];
    float vs[STEP];
#pragma unroll
    for (int t = 0; t < STEP; ++t) {
      const bool in = i + t < M;
      ks[t] = in ? key[i + t] : -2;  // -2: past the end, ends the run
      vs[t] = in ? val[i + t] : 0.f;
    }
#pragma unroll
    for (int t = 0; t < STEP; ++t) {
      if (ks[t] != k) {
        out[k] = acc;
        return;
      }
      acc += vs[t];
    }
  }
  out[k] = acc;
}

template <typename Perm>
cudaError_t gather(long long* skey, float* sval, const long long* key,
                   const float* val, const Perm* perm, long long E,
                   long long rows, cudaStream_t stream) {
  const long long blocks = (E + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL || rows > 65535) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(rows));
  gather_kernel<Perm><<<grid, THREADS, 0, stream>>>(skey, sval, key, val,
                                                     perm, E);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// perm_bits: 0 (no permutation: positions are slots), 32 or 64 (int32 or
// int64 row-relative slots, gathered through skey/sval, M int64 and M
// float32 of scratch). Returns a cudaError_t (0 on success).
int run_sum_f32(void* out, const void* key, const void* val, const void* perm,
                int perm_bits, long long E, long long M, void* skey,
                void* sval, void* stream) {
  if (M <= 0) return 0;
  if (E <= 0 || M % E != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto k = static_cast<const long long*>(key);
  auto v = static_cast<const float*>(val);
  auto s = static_cast<cudaStream_t>(stream);
  if (perm_bits != 0) {
    auto sk = static_cast<long long*>(skey);
    auto sv = static_cast<float*>(sval);
    cudaError_t rc;
    if (perm_bits == 32) {
      rc = gather(sk, sv, k, v, static_cast<const int32_t*>(perm), E, M / E,
                  s);
    } else if (perm_bits == 64) {
      rc = gather(sk, sv, k, v, static_cast<const int64_t*>(perm), E, M / E,
                  s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (rc != cudaSuccess) return static_cast<int>(rc);
    k = sk;
    v = sv;
  }
  const long long blocks = (M + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  walk_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
      static_cast<float*>(out), k, v, M);
  return static_cast<int>(cudaGetLastError());
}

const char* run_sum_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

}  // extern "C"

// A variant of src/repro_torch/kernels/csrc/run_sum.cu for one measurement
// (tools/rs_ablation.py): runs split by length. A tile kernel adds every run
// of at most LONG values from shared memory (a halo of LONG positions past
// the tile) and puts each longer run, with its first LONG values added, on
// a list in device memory; a second kernel gives each listed run to a warp,
// whose lanes load its next WARP_TILE positions through the permutation
// while lane 0 adds the last ones from shared memory. The same C entry
// points as the shipped file. Nothing in the package uses it.
//
// Knobs (-D): RUN_SUM_LONG, the longest run a thread adds (128);
// RUN_SUM_KEYS_IN_ORDER 1: keys read by position, not through the
// permutation (the caller hands them over sorted).

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef RUN_SUM_LONG
#define RUN_SUM_LONG 128
#endif
#ifndef RUN_SUM_KEYS_IN_ORDER  // 1: keys read by position, not through perm
#define RUN_SUM_KEYS_IN_ORDER 0
#endif

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;                         // tile positions a thread
constexpr int TILE = THREADS * ITEMS;            // positions a block
constexpr int LONG = RUN_SUM_LONG;               // longest run a thread adds
constexpr int SPAN = TILE + LONG + 1;            // before, tile, halo
constexpr int LOADS = (SPAN + THREADS - 1) / THREADS;
constexpr int WORDS = (SPAN + 31) / 32;          // boundary bits
constexpr int WARP_ITEMS = 8;                    // long runs: positions a lane
constexpr int WARP_TILE = 32 * WARP_ITEMS;
constexpr int LONG_THREADS = 128;                // long runs: a block
constexpr unsigned FULL = 0xffffffffu;

// Values sit in shared memory one word apart every 32 positions, so that
// threads walking their own ITEMS positions hit 32 different banks.
__device__ __forceinline__ int skew(int q) { return q + (q >> 5); }

// Position p = row * E + x: the slot it reads, its flat key (-1 skipped)
// and its value.
template <typename Key, typename Perm>
struct Reader {
  const Key* __restrict__ key;
  const float* __restrict__ val;
  const Perm* __restrict__ perm;  // nullptr: positions are slots
  long long E, M, stride;

  __device__ __forceinline__ long long slot(long long p, long long row,
                                            long long x) const {
    return row * E + (perm != nullptr ? static_cast<long long>(perm[p]) : x);
  }
  __device__ __forceinline__ long long flat(long long p, long long s,
                                           long long row) const {
    const long long k =
        static_cast<long long>(key[RUN_SUM_KEYS_IN_ORDER ? p : s]);
    return k >= 0 ? k + row * stride : -1;
  }
};

// Runs longer than LONG, handed from the tile kernel to the long kernel:
// the key, the position to go on from, and the chain so far.
struct LongRun {
  long long key, pos;
  float acc;
};
struct LongList {
  int count, next;  // zeroed before the tile kernel
};

// The tile kernel: load the tile, the position before it and the halo
// through the permutation into shared memory, mark the boundaries, add the
// short runs.
template <typename Key, typename Perm>
__global__ void __launch_bounds__(THREADS)
tile_kernel(float* __restrict__ out, Reader<Key, Perm> rd, bool accumulate,
            LongList* __restrict__ list, LongRun* __restrict__ runs) {
  __shared__ long long sk[SPAN];
  __shared__ float sv[SPAN + SPAN / 32 + 1];
  __shared__ unsigned bound[WORDS];  // bit q: position q's key is not q-1's
  const long long base =
      static_cast<long long>(blockIdx.x) * TILE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // load: positions base - 1 .. base + TILE + LONG - 1, shared index q at
  // position base - 1 + q; outside [0, M) the key -2 ends any run
  {
    const long long p0 = base - 1 + threadIdx.x;
    long long row = p0 / rd.E, x = p0 - row * rd.E;  // p0 = -1: row 0, x -1
    long long slots[LOADS], rows[LOADS];
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int q = threadIdx.x + i * THREADS;
      const long long p = p0 + i * THREADS;
      rows[i] = row;
      slots[i] = (q < SPAN && p >= 0 && p < rd.M) ? rd.slot(p, row, x) : -1;
      x += THREADS;
      while (x >= rd.E) {
        x -= rd.E;
        ++row;
      }
    }
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int q = threadIdx.x + i * THREADS;
      if (q < SPAN) {
        sk[q] = slots[i] >= 0 ? rd.flat(p0 + i * THREADS, slots[i], rows[i])
                              : -2;
        sv[skew(q)] = slots[i] >= 0 ? rd.val[slots[i]] : 0.f;
      }
    }
  }
  __syncthreads();
  // boundaries, a word of 32 positions a ballot; past the halo, all set
  for (int w = warp; w < WORDS; w += THREADS / 32) {
    const int q = w * 32 + lane;
    const bool b = q >= SPAN || (q > 0 && sk[q] != sk[q - 1]);
    const unsigned m = __ballot_sync(FULL, b);
    if (lane == 0) bound[w] = m;
  }
  __syncthreads();

  // short runs: each run that starts among this thread's ITEMS positions,
  // added left to right; a run with no boundary within LONG positions adds
  // its first LONG values and goes on the list
  const int first = 1 + threadIdx.x * ITEMS;
  for (int q = first; q < first + ITEMS; ++q) {
    if (!((bound[q >> 5] >> (q & 31)) & 1u)) continue;
    const long long k = sk[q];
    if (k < 0) continue;
    // the next boundary after q, looked for up to q + LONG
    const int limit = q + LONG + 1;  // <= SPAN
    int w = (q + 1) >> 5;
    unsigned m = bound[w] & (FULL << ((q + 1) & 31));
    while (m == 0 && (w + 1) * 32 < limit) m = bound[++w];
    const int next = m == 0 ? limit : min(w * 32 + __ffs(m) - 1, limit);
    const int n = min(next - q, LONG);
    float acc = accumulate ? out[k] : 0.f;
#pragma unroll 4
    for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, sv[skew(q + i)]);
    if (next - q > LONG) {
      const int at = atomicAdd(&list->count, 1);
      runs[at] = LongRun{k, base - 1 + q + LONG, acc};
    } else {
      out[k] = acc;
    }
  }
}

// The run of key k from position p on (its chain so far in acc, on lane 0),
// by one warp, WARP_TILE positions a step. While lane 0 adds step t from
// shared memory, the keys and values of step t + 1 and the permutation of
// step t + 2 are in flight: each load lands in a register that is first
// read a step later. buf: WARP_TILE floats of shared memory.
template <typename Key, typename Perm>
__device__ void long_run(float* __restrict__ out, const Reader<Key, Perm>& rd,
                         long long k, long long p, float acc, float* buf) {
  const int lane = threadIdx.x & 31;
  // three steps' places: a (its keys and values loaded), b (its
  // permutation loaded), c (nothing yet)
  long long pa = p, ra = p / rd.E, xa = p - ra * rd.E;
  auto next = [&](long long& q, long long& r, long long& x) {
    q += WARP_TILE;
    x += WARP_TILE;
    while (x >= rd.E) {
      x -= rd.E;
      ++r;
    }
  };
  // position i * 32 + lane of the step at (q, r, x): its row and column
  auto place = [&](long long r, long long x, int i, long long& ri,
                   long long& xi) {
    ri = r;
    xi = x + i * 32 + lane;
    while (xi >= rd.E) {
      xi -= rd.E;
      ++ri;
    }
  };
  long long pb = pa, rb = ra, xb = xa;
  next(pb, rb, xb);
  Perm pv[WARP_ITEMS];  // b's permutation (or nothing without one)
  Key kv[WARP_ITEMS];   // a's raw keys
  float vs[WARP_ITEMS];  // a's values
  auto load_perm = [&](long long q) {
#pragma unroll
    for (int i = 0; i < WARP_ITEMS; ++i) {
      const long long pi = q + i * 32 + lane;
      pv[i] = (rd.perm != nullptr && pi < rd.M) ? rd.perm[pi] : Perm(0);
    }
  };
  // a's keys and values, from its slots (the permutation in pv, or none)
  auto load_values = [&](long long q, long long r, long long x,
                         bool from_pv) {
#pragma unroll
    for (int i = 0; i < WARP_ITEMS; ++i) {
      long long ri, xi;
      place(r, x, i, ri, xi);
      const bool in = q + i * 32 + lane < rd.M;
      const long long s =
          ri * rd.E + (rd.perm == nullptr ? xi
                       : from_pv ? static_cast<long long>(pv[i])
                                 : static_cast<long long>(rd.perm[q + i * 32 + lane]));
      kv[i] = in ? rd.key[RUN_SUM_KEYS_IN_ORDER ? q + i * 32 + lane : s]
                 : Key(-2);
      vs[i] = in ? rd.val[s] : 0.f;
    }
  };
  load_values(pa, ra, xa, false);
  load_perm(pb);
  for (;;) {
    int end = WARP_TILE;  // the first position of step a off the run
#pragma unroll
    for (int i = WARP_ITEMS - 1; i >= 0; --i) {
      long long ri, xi;
      place(ra, xa, i, ri, xi);
      const long long flat = kv[i] >= 0 ? static_cast<long long>(kv[i]) +
                                              ri * rd.stride
                                        : -1;
      const bool in = pa + i * 32 + lane < rd.M;
      const unsigned off = __ballot_sync(FULL, !in || flat != k);
      if (off != 0) end = i * 32 + __ffs(off) - 1;
    }
#pragma unroll
    for (int i = 0; i < WARP_ITEMS; ++i) buf[i * 32 + lane] = vs[i];
    __syncwarp();
    const bool more = end == WARP_TILE;
    if (more) {  // b becomes a, c becomes b: in flight during the adds
      pa = pb, ra = rb, xa = xb;
      load_values(pa, ra, xa, true);
      next(pb, rb, xb);
      load_perm(pb);
    }
    if (lane == 0) {
      const float4* b4 = reinterpret_cast<const float4*>(buf);
      int o = 0;
#pragma unroll 4
      for (; o + 4 <= end; o += 4) {
        const float4 f = b4[o / 4];
        acc = __fadd_rn(acc, f.x);
        acc = __fadd_rn(acc, f.y);
        acc = __fadd_rn(acc, f.z);
        acc = __fadd_rn(acc, f.w);
      }
      for (; o < end; ++o) acc = __fadd_rn(acc, buf[o]);
    }
    __syncwarp();
    if (!more) break;
  }
  if (lane == 0) out[k] = acc;
}

// The long kernel: each warp takes the next run off the list until none is
// left.
template <typename Key, typename Perm>
__global__ void __launch_bounds__(LONG_THREADS)
long_kernel(float* __restrict__ out, Reader<Key, Perm> rd,
            LongList* __restrict__ list, const LongRun* __restrict__ runs) {
  __shared__ __align__(16) float buf[LONG_THREADS / 32][WARP_TILE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int count = list->count;
  for (;;) {
    int j = 0;
    if (lane == 0) j = atomicAdd(&list->next, 1);
    j = __shfl_sync(FULL, j, 0);
    if (j >= count) break;
    const LongRun r = runs[j];
    long_run(out, rd, r.key, r.pos, r.acc, buf[warp]);
  }
}

int long_blocks() {  // enough warps for every SM, the same every call
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    blocks = 8 * sms;
  }
  return blocks;
}

template <typename Key, typename Perm>
cudaError_t launch(float* out, const void* key, const float* val,
                   const void* perm, long long E, long long M,
                   long long stride, bool accumulate, void* work,
                   cudaStream_t stream) {
  const long long blocks = (M + TILE - 1) / TILE;
  const int lblocks = long_blocks();
  if (blocks > 0x7fffffffLL || lblocks == 0) return cudaErrorInvalidValue;
  Reader<Key, Perm> rd{static_cast<const Key*>(key), val,
                       static_cast<const Perm*>(perm), E, M, stride};
  auto list = static_cast<LongList*>(work);
  auto runs = reinterpret_cast<LongRun*>(static_cast<char*>(work) + 16);
  cudaError_t rc = cudaMemsetAsync(list, 0, sizeof(LongList), stream);
  if (rc != cudaSuccess) return rc;
  tile_kernel<Key, Perm><<<static_cast<unsigned>(blocks), THREADS, 0,
                           stream>>>(out, rd, accumulate, list, runs);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  long_kernel<Key, Perm><<<lblocks, LONG_THREADS, 0, stream>>>(out, rd, list,
                                                               runs);
  return cudaGetLastError();
}

template <typename Key>
cudaError_t dispatch_perm(float* out, const void* key, const float* val,
                          const void* perm, int perm_bits, long long E,
                          long long M, long long stride, bool accumulate,
                          void* work, cudaStream_t stream) {
  switch (perm_bits) {
    case 0:  // no permutation: any Perm type, never read
      return launch<Key, int32_t>(out, key, val, nullptr, E, M, stride,
                                  accumulate, work, stream);
    case 32:
      return launch<Key, int32_t>(out, key, val, perm, E, M, stride,
                                  accumulate, work, stream);
    case 64:
      return launch<Key, int64_t>(out, key, val, perm, E, M, stride,
                                  accumulate, work, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Bytes of device memory run_sum_f32 needs as its work area for M
// positions: the long runs' list.
long long run_sum_work_bytes(long long M) {
  return 16 + static_cast<long long>(sizeof(LongRun)) * (M / (LONG + 1) + 1);
}

// key_bits: 32 or 64 (int32 or int64 keys); stride: 0 (flat keys) or the
// row stride of row-local ones. perm_bits: 0 (no permutation: positions are
// slots), 32 or 64 (int32 or int64 row-relative slots). accumulate: 0 (each
// run's sum from 0) or 1 (from out[k]). work: run_sum_work_bytes(M) bytes,
// 16-byte aligned. Returns a cudaError_t (0 on success).
int run_sum_f32(void* out, const void* key, int key_bits, const void* val,
                const void* perm, int perm_bits, long long E, long long M,
                long long stride, int accumulate, void* work, void* stream) {
  if (M <= 0) return 0;
  if (E <= 0 || M % E != 0 || stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto o = static_cast<float*>(out);
  auto v = static_cast<const float*>(val);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (key_bits == 32) {
    rc = dispatch_perm<int32_t>(o, key, v, perm, perm_bits, E, M, stride,
                                accumulate != 0, work, s);
  } else if (key_bits == 64) {
    rc = dispatch_perm<int64_t>(o, key, v, perm, perm_bits, E, M, stride,
                                accumulate != 0, work, s);
  } else {
    rc = cudaErrorInvalidValue;
  }
  return static_cast<int>(rc);
}

const char* run_sum_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

}  // extern "C"

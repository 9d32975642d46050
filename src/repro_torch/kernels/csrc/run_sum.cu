// run_sum: float32 sums of keyed values in one stated order, the same order
// on the card as PyTorch's index_add_ takes on the CPU. Contract, bounds and
// measured times: see repro_torch/kernels/run_sum.py, which binds this file
// through ctypes (plain C entry points, no PyTorch headers).
//
// Input: M positions of a (rows, E) layout, in destination order. Position
// j reads its value and its key directly, or through a row-relative
// permutation (row r = j / E, slot perm[j] of that row). A key is flat
// (int64, stride 0) or row-local (int32 or int64, plus the row stride: the
// flat key is r * stride + key); keys >= 0 stand in runs, one run a flat
// key, and a negative key is skipped. Output: out[k] = ((0 + v_1) + v_2) +
// ... over the run of key k, left to right; the wrapper zero-fills out
// first. Accumulating, each run's chain starts from out[k] instead: out[k]
// = ((out[k] + v_1) + v_2) + ..., and a key with no run keeps its value
// (the order of out.index_add_ on the CPU).
//
// One kernel, after a memset of its work area. Each block claims the next
// tile of TILE positions from a counter in device memory, so tiles start
// in position order, row by row (the random reads of a row's keys and
// values then fall in L2 while its tiles run), and every tile before a
// claimed one has been claimed by a block that is running or done.
//
// * load: the block reads its tile, the position before it and the one
//   after it, each through the permutation, into shared memory (the flat
//   key, and the value). Every random read is independent of every other,
//   so all of them are in flight at once; nothing goes to scratch and
//   nothing is read twice.
// * boundaries: one ballot a warp marks, 32 positions a word, where a key
//   differs from the one before.
// * runs: the thread that owns a run's first position (each owns ITEMS
//   positions in a row) adds the run left to right from shared memory up
//   to its end or the tile's.
// * carries: a run that goes on past the tile's end hands its chain to the
//   next tile: the sum so far in device memory, then a flag. The next
//   tile's thread 0 waits for the flag and adds the run's part in its own
//   tile onto that sum (and hands it on again if the run covers the whole
//   tile). A hub's chain so passes from tile to tile, each part added from
//   shared memory, while every other block works on.
//
// A run's additions are one chain whatever its length (any split would add
// in another order): round-to-nearest adds, subnormals kept (no fast math,
// no flush to zero), no atomics on out (each key is written once, by the
// thread that ends its chain).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;                    // positions a thread owns
constexpr int TILE = THREADS * ITEMS;       // positions a block
constexpr int SPAN = TILE + 2;              // before, the tile, after
constexpr int LOADS = (SPAN + THREADS - 1) / THREADS;
constexpr int WORDS = (SPAN + 31) / 32;     // boundary bits
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
    return row * E +
           (perm != nullptr ? static_cast<long long>(perm[p]) : x);
  }
  __device__ __forceinline__ long long flat(long long s, long long row) const {
    const long long k = static_cast<long long>(key[s]);
    return k >= 0 ? k + row * stride : -1;
  }
};

// A marked permutation's slot: its value without the sign bit.
template <typename T>
__device__ __forceinline__ T unmark(T v) {
  return v & static_cast<T>(~(1ull << (sizeof(T) * 8 - 1)));
}

// The work area: the tile counter, then a flag a tile, then a carried sum
// a tile.
struct Work {
  int next_tile, pad[3];
};
__host__ __device__ __forceinline__ int* flags(Work* w) {
  return reinterpret_cast<int*>(w + 1);
}

// The first boundary after position q, looked for up to limit (<= SPAN);
// limit where there is none. Bits from SPAN on are all set.
__device__ __forceinline__ int next_bound(const unsigned* bound, int q,
                                         int limit) {
  int w = (q + 1) >> 5;
  unsigned m = bound[w] & (FULL << ((q + 1) & 31));
  while (m == 0 && (w + 1) * 32 < limit) m = bound[++w];
  return m == 0 ? limit : min(w * 32 + __ffs(m) - 1, limit);
}

template <typename Key, typename Perm, bool MARKED>
__global__ void __launch_bounds__(THREADS)
run_sum_kernel(float* __restrict__ out, Reader<Key, Perm> rd, bool accumulate,
               Work* __restrict__ work, float* __restrict__ carry) {
  // the flat key at each position, or (MARKED) the slot it reads
  __shared__ long long sk[SPAN];
  __shared__ float sv[SPAN + SPAN / 32 + 1];
  __shared__ unsigned bound[WORDS];  // bit q: position q's key is not q-1's
  __shared__ int tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) tile = atomicAdd(&work->next_tile, 1);
  __syncthreads();
  const int t = tile;
  const long long base = static_cast<long long>(t) * TILE;

  // load: positions base - 1 .. base + TILE, shared index q at position
  // base - 1 + q; outside [0, M) the key -2 ends any run
  {
    const long long p0 = base - 1 + threadIdx.x;
    long long row = p0 / rd.E, x = p0 - row * rd.E;  // p0 = -1: row 0, x -1
    long long slots[LOADS], rows[LOADS];
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int q = threadIdx.x + i * THREADS;
      const long long p = p0 + i * THREADS;
      const bool in = q < SPAN && p >= 0 && p < rd.M;
      rows[i] = row;
      if constexpr (MARKED) {  // the mark is the permutation's sign bit
        const Perm v = in ? rd.perm[p] : Perm(-1);
        slots[i] = in ? row * rd.E + static_cast<long long>(unmark(v)) : -1;
        // word warp + 8 i holds positions q = 32 (warp + 8 i) + lane
        const unsigned m = __ballot_sync(FULL, v < 0 || q >= SPAN);
        if (lane == 0 && q - lane < SPAN) bound[warp + 8 * i] = m;
      } else {
        slots[i] = in ? rd.slot(p, row, x) : -1;
      }
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
        if constexpr (MARKED)
          sk[q] = slots[i];
        else
          sk[q] = slots[i] >= 0 ? rd.flat(slots[i], rows[i]) : -2;
        // only the tile's own values are added here
        if (q >= 1 && q <= TILE)
          sv[skew(q)] = slots[i] >= 0 ? rd.val[slots[i]] : 0.f;
      }
    }
  }
  __syncthreads();
  if constexpr (!MARKED) {
    // boundaries, a word of 32 positions a ballot; from SPAN on, all set
    for (int w = warp; w < WORDS; w += THREADS / 32) {
      const int q = w * 32 + lane;
      const bool b = q >= SPAN || (q > 0 && sk[q] != sk[q - 1]);
      const unsigned m = __ballot_sync(FULL, b);
      if (lane == 0) bound[w] = m;
    }
  }
  __syncthreads();

  // a run from position q on: adds its values up to its end or the tile's
  // onto acc, then writes the sum, or hands it to the next tile where the
  // run goes on (no boundary in (q, TILE + 1])
  auto finish = [&](int q, long long k, float acc) {
    const int next = next_bound(bound, q, SPAN);
    const int n = min(next, TILE + 1) - q;
#pragma unroll 4
    for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, sv[skew(q + i)]);
    if (next == SPAN) {
      carry[t] = acc;
      __threadfence();
      atomicExch(&flags(work)[t], 1);
    } else {
      out[k] = acc;
    }
  };
  // the flat key of the run at position q (MARKED: read here, at a run's
  // first position only)
  auto key_at = [&](int q) {
    return MARKED ? (sk[q] >= 0 ? rd.flat(sk[q], sk[q] / rd.E) : -2)
                  : sk[q];
  };
  // runs that start among this thread's positions
  const int first = 1 + threadIdx.x * ITEMS;
  for (int q = first; q < first + ITEMS; ++q) {
    if (!((bound[q >> 5] >> (q & 31)) & 1u)) continue;
    const long long k = key_at(q);
    if (k >= 0) finish(q, k, accumulate ? out[k] : 0.f);
  }
  // the run that comes in from the tile before: its chain so far is that
  // tile's carry (the tile was claimed before this one, by a block that
  // runs or is done, so the wait ends)
  if (threadIdx.x == 0 && !(bound[0] & 2u)) {
    const long long k = key_at(1);
    if (k >= 0) {
      const volatile int* flag = &flags(work)[t - 1];
      while (*flag == 0) __nanosleep(64);
      __threadfence();
      finish(1, k, __ldcg(&carry[t - 1]));
    }
  }
}

template <typename Key, typename Perm>
cudaError_t launch(float* out, const void* key, const float* val,
                   const void* perm, bool marked, long long E, long long M,
                   long long stride, bool accumulate, void* work,
                   cudaStream_t stream) {
  const long long tiles = (M + TILE - 1) / TILE;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  Reader<Key, Perm> rd{static_cast<const Key*>(key), val,
                       static_cast<const Perm*>(perm), E, M, stride};
  auto w = static_cast<Work*>(work);
  cudaError_t rc = cudaMemsetAsync(w, 0, sizeof(Work) + 4 * tiles, stream);
  if (rc != cudaSuccess) return rc;
  float* carry = reinterpret_cast<float*>(flags(w) + tiles);
  if (marked)
    run_sum_kernel<Key, Perm, true><<<static_cast<unsigned>(tiles), THREADS,
                                      0, stream>>>(out, rd, accumulate, w,
                                                   carry);
  else
    run_sum_kernel<Key, Perm, false><<<static_cast<unsigned>(tiles),
                                       THREADS, 0, stream>>>(
        out, rd, accumulate, w, carry);
  return cudaGetLastError();
}

template <typename Key>
cudaError_t dispatch_perm(float* out, const void* key, const float* val,
                          const void* perm, int perm_bits, bool marked,
                          long long E, long long M, long long stride,
                          bool accumulate, void* work, cudaStream_t stream) {
  if (marked && perm_bits == 0) return cudaErrorInvalidValue;
  switch (perm_bits) {
    case 0:  // no permutation: any Perm type, never read
      return launch<Key, int32_t>(out, key, val, nullptr, false, E, M,
                                  stride, accumulate, work, stream);
    case 32:
      return launch<Key, int32_t>(out, key, val, perm, marked, E, M, stride,
                                  accumulate, work, stream);
    case 64:
      return launch<Key, int64_t>(out, key, val, perm, marked, E, M, stride,
                                  accumulate, work, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Positions a block adds (TILE): a run past the end of its tile is carried
// on to the next.
int run_sum_tile() { return TILE; }

// Bytes of device memory run_sum_f32 needs as its work area for M
// positions: the tile counter, and a flag and a carried sum a tile.
long long run_sum_work_bytes(long long M) {
  return static_cast<long long>(sizeof(Work)) + 8 * ((M + TILE - 1) / TILE);
}

// key_bits: 32 or 64 (int32 or int64 keys); stride: 0 (flat keys) or the
// row stride of row-local ones. perm_bits: 0 (no permutation: positions are
// slots), 32 or 64 (int32 or int64 row-relative slots). marked: 1 where
// the permutation's sign bit marks each position whose flat key is not the
// one before's (and the first position): keys are then read only there.
// accumulate: 0 (each run's sum from 0) or 1 (from out[k]). work:
// run_sum_work_bytes(M) bytes, 16-byte aligned. Returns a cudaError_t (0
// on success).
int run_sum_f32(void* out, const void* key, int key_bits, const void* val,
                const void* perm, int perm_bits, int marked, long long E,
                long long M, long long stride, int accumulate, void* work,
                void* stream) {
  if (M <= 0) return 0;
  if (E <= 0 || M % E != 0 || stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto o = static_cast<float*>(out);
  auto v = static_cast<const float*>(val);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (key_bits == 32) {
    rc = dispatch_perm<int32_t>(o, key, v, perm, perm_bits, marked != 0, E,
                                M, stride, accumulate != 0, work, s);
  } else if (key_bits == 64) {
    rc = dispatch_perm<int64_t>(o, key, v, perm, perm_bits, marked != 0, E,
                                M, stride, accumulate != 0, work, s);
  } else {
    rc = cudaErrorInvalidValue;
  }
  return static_cast<int>(rc);
}

const char* run_sum_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

}  // extern "C"

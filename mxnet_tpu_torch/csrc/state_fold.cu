// The integrity fold (algorithm xsf32-v1) for Hopper (sm_90a): one 32-bit
// fingerprint of a named state, computed on the card with no host sync.
//
// Replaces mxnet_tpu/resilience/integrity.py:fold_tree, an XLA reduction
// that compiles into the training step (no Pallas kernel: plain torch has
// no wrapping uint32 sum, so its plain version widens every word to int64,
// which is several passes and int64 temporaries the size of the largest
// leaf). For each leaf, in sorted-name order, its elements' raw bits
// zero-extended to uint32 words w (4-byte elements as they are, 2-byte and
// 1-byte ones widened, bool as 0/1):
//   s1 = sum(w), s2 = sum(w * w)             (mod 2^32)
//   digest = s1 ^ (s2 * 2654435761)          (mod 2^32)
//   acc = acc * 1000003 + digest + crc32(name)   (acc starts at 2166136261)
// The sums are exact and commutative, so the value is the host fold's
// (integrity.py:fold_host) bit for bit, whatever the block order.
//
// Bound on the H100 SXM: bytes. Each word is read once and the arithmetic
// is two integer ops per word, far below the card's integer rate, so the
// least time is the state's bytes over 3.35 TB/s (the LM's fp32 masters and
// gradients, 1.3 GB: ~0.39 ms). The design: one launch over a device table
// of (pointer, elements, element size, crc32) rows, in the combine's
// order. Every leaf gets its own run of blocks (a prefix of block counts in
// the table), each block walking its slice of the leaf with 16-byte loads
// where the address allows, s1 and s2 kept in registers and reduced by warp
// shuffles and shared memory into one (s1, s2) partial per block. A second
// launch of one block reduces each leaf's partials (one warp per leaf) and
// its thread 0 runs the ordered combine.
//
// Over several ranks (a sharded state) the chain has to wait for the
// ranks' sums: state_fold_sums runs fold_partials, then reduces each
// leaf's partials (a warp a leaf) into sums[leaf] = (s1, s2) as int64
// pairs, ready for the all-reduce (wrapping uint32 sums add over shards);
// a rank leaves out a leaf it does not count by a row of 0 elements.
// state_fold_chain then takes the all-reduced sums (their low 32 bits)
// and runs the digests and the ordered chain in one block. Bound: the
// sums are state_fold's bytes; the chain reads 16 bytes a leaf.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t SEED = 2166136261u;
constexpr uint32_t FOLD_MUL = 1000003u;
constexpr uint32_t DIGEST_MUL = 2654435761u;

// One row of the table: 4 int64 (pointer, elements, element size, crc32),
// then the leaf's first block in the flat grid and its block count.
struct Row {
  long long ptr, n, esize, crc, first, blocks;
};

__device__ __forceinline__ void add_word(uint32_t w, uint32_t& s1,
                                         uint32_t& s2) {
  s1 += w;
  s2 += w * w;
}

__device__ __forceinline__ void add_vec(uint4 v, int esize, uint32_t& s1,
                                        uint32_t& s2) {
  const uint32_t q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (esize == 4) {
      add_word(q[i], s1, s2);
    } else if (esize == 2) {
      add_word(q[i] & 0xffffu, s1, s2);
      add_word(q[i] >> 16, s1, s2);
    } else {
      add_word(q[i] & 0xffu, s1, s2);
      add_word((q[i] >> 8) & 0xffu, s1, s2);
      add_word((q[i] >> 16) & 0xffu, s1, s2);
      add_word(q[i] >> 24, s1, s2);
    }
  }
}

__device__ __forceinline__ uint32_t load_elem(const unsigned char* base,
                                              long long i, int esize) {
  if (esize == 4) return reinterpret_cast<const uint32_t*>(base)[i];
  if (esize == 2) return reinterpret_cast<const uint16_t*>(base)[i];
  return base[i];
}

// The leaf whose run of blocks holds block b: binary search of `first`.
__device__ __forceinline__ int leaf_of(const Row* rows, int n_leaves,
                                       long long b) {
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (rows[mid].first <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
fold_partials(const Row* __restrict__ rows, int n_leaves,
              uint2* __restrict__ partials) {
  const long long b = blockIdx.x;
  const Row r = rows[leaf_of(rows, n_leaves, b)];
  const int esize = int(r.esize);
  const unsigned char* base = reinterpret_cast<const unsigned char*>(r.ptr);
  const long long local = b - r.first;
  // this block's slice of the leaf's elements, in whole 16-byte vectors
  const long long per_vec = 16 / esize;
  const long long vecs = r.n / per_vec;
  const long long chunk = (vecs + r.blocks - 1) / r.blocks;
  const long long v0 = local * chunk < vecs ? local * chunk : vecs;
  const long long v1 = v0 + chunk < vecs ? v0 + chunk : vecs;
  uint32_t s1 = 0, s2 = 0;
  if ((r.ptr & 15) == 0) {
    const uint4* vp = reinterpret_cast<const uint4*>(base);
    for (long long v = v0 + threadIdx.x; v < v1; v += THREADS)
      add_vec(__ldg(vp + v), esize, s1, s2);
    // the tail that fills no whole vector: the leaf's last block takes it
    if (local == r.blocks - 1)
      for (long long i = vecs * per_vec + threadIdx.x; i < r.n; i += THREADS)
        add_word(load_elem(base, i, esize), s1, s2);
  } else {
    // unaligned base: element loads over the same slice
    const long long e0 = v0 * per_vec;
    const long long e1 = local == r.blocks - 1 ? r.n : v1 * per_vec;
    for (long long i = e0 + threadIdx.x; i < e1; i += THREADS)
      add_word(load_elem(base, i, esize), s1, s2);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_xor_sync(FULL, s1, off);
    s2 += __shfl_xor_sync(FULL, s2, off);
  }
  __shared__ uint2 warp_sums[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = make_uint2(s1, s2);
  __syncthreads();
  if (warp == 0) {
    uint2 v = lane < THREADS / 32 ? warp_sums[lane] : make_uint2(0u, 0u);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v.x += __shfl_xor_sync(FULL, v.x, off);
      v.y += __shfl_xor_sync(FULL, v.y, off);
    }
    if (lane == 0) partials[b] = v;
  }
}

constexpr int COMBINE_THREADS = 1024;

__global__ void __launch_bounds__(COMBINE_THREADS)
fold_combine(const Row* __restrict__ rows, int n_leaves,
             const uint2* __restrict__ partials,
             uint32_t* __restrict__ digests, uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int leaf = warp; leaf < n_leaves; leaf += COMBINE_THREADS / 32) {
    const Row r = rows[leaf];
    uint32_t s1 = 0, s2 = 0;
    for (long long k = lane; k < r.blocks; k += 32) {
      const uint2 p = partials[r.first + k];
      s1 += p.x;
      s2 += p.y;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(FULL, s1, off);
      s2 += __shfl_xor_sync(FULL, s2, off);
    }
    if (lane == 0) digests[leaf] = s1 ^ (s2 * DIGEST_MUL);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t acc = SEED;
    for (int leaf = 0; leaf < n_leaves; ++leaf)
      acc = acc * FOLD_MUL + digests[leaf] + uint32_t(rows[leaf].crc);
    *out = acc;
  }
}

constexpr int SUMS_WARPS = 8;

__global__ void __launch_bounds__(SUMS_WARPS * 32)
fold_sums(const Row* __restrict__ rows, int n_leaves,
          const uint2* __restrict__ partials, long long* __restrict__ sums) {
  const int lane = threadIdx.x & 31;
  const int leaf = blockIdx.x * SUMS_WARPS + (threadIdx.x >> 5);
  if (leaf >= n_leaves) return;
  const Row r = rows[leaf];
  uint32_t s1 = 0, s2 = 0;
  for (long long k = lane; k < r.blocks; k += 32) {
    const uint2 p = partials[r.first + k];
    s1 += p.x;
    s2 += p.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_xor_sync(FULL, s1, off);
    s2 += __shfl_xor_sync(FULL, s2, off);
  }
  if (lane == 0) {
    sums[2 * leaf] = (long long)s1;
    sums[2 * leaf + 1] = (long long)s2;
  }
}

constexpr int CHAIN_THREADS = 256;

// One block: the digests of CHAIN_THREADS leaves at a time into shared
// memory, then thread 0 chains them in order.
__global__ void __launch_bounds__(CHAIN_THREADS)
fold_chain(const long long* __restrict__ sums,
           const long long* __restrict__ crcs, int n_leaves,
           uint32_t* __restrict__ out) {
  __shared__ uint32_t digests[CHAIN_THREADS];
  uint32_t acc = SEED;
  for (int base = 0; base < n_leaves; base += CHAIN_THREADS) {
    const int leaf = base + threadIdx.x;
    if (leaf < n_leaves) {
      const uint32_t s1 = uint32_t(sums[2 * leaf]);
      const uint32_t s2 = uint32_t(sums[2 * leaf + 1]);
      digests[threadIdx.x] = (s1 ^ (s2 * DIGEST_MUL)) + uint32_t(crcs[leaf]);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const int n = n_leaves - base < CHAIN_THREADS ? n_leaves - base
                                                    : CHAIN_THREADS;
      for (int i = 0; i < n; ++i) acc = acc * FOLD_MUL + digests[i];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = acc;
}

}  // namespace

// table: n_leaves rows of 6 int64 (pointer, elements, element size 1/2/4,
// crc32 of the name, first block, block count), in the combine's order,
// the runs of blocks contiguous and covering [0, total_blocks);
// partials: total_blocks uint2; digests: n_leaves uint32; out: one uint32.
// Returns a cudaError_t code.
extern "C" int state_fold(const void* table, int n_leaves,
                          long long total_blocks, void* partials,
                          void* digests, void* out, void* stream) {
  if (n_leaves < 1 || total_blocks < n_leaves ||
      total_blocks > 2147483647LL)
    return int(cudaErrorInvalidValue);
  const Row* rows = static_cast<const Row*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fold_partials<<<unsigned(total_blocks), THREADS, 0, s>>>(
      rows, n_leaves, static_cast<uint2*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  fold_combine<<<1, COMBINE_THREADS, 0, s>>>(
      rows, n_leaves, static_cast<const uint2*>(partials),
      static_cast<uint32_t*>(digests), static_cast<uint32_t*>(out));
  return int(cudaGetLastError());
}

// The table as state_fold's (a leaf a rank does not count: a row of 0
// elements and one block); partials: total_blocks uint2; sums: n_leaves
// pairs of int64 (s1, s2), each in [0, 2^32). Returns a cudaError_t code.
extern "C" int state_fold_sums(const void* table, int n_leaves,
                               long long total_blocks, void* partials,
                               void* sums, void* stream) {
  if (n_leaves < 1 || total_blocks < n_leaves ||
      total_blocks > 2147483647LL)
    return int(cudaErrorInvalidValue);
  const Row* rows = static_cast<const Row*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fold_partials<<<unsigned(total_blocks), THREADS, 0, s>>>(
      rows, n_leaves, static_cast<uint2*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  fold_sums<<<(n_leaves + SUMS_WARPS - 1) / SUMS_WARPS, SUMS_WARPS * 32, 0,
              s>>>(rows, n_leaves, static_cast<const uint2*>(partials),
                   static_cast<long long*>(sums));
  return int(cudaGetLastError());
}

// sums: n_leaves pairs of int64 (all-reduced; their low 32 bits are the
// wrapping sums); crcs: n_leaves int64 (crc32 of each name, in the
// combine's order); out: one uint32. Returns a cudaError_t code.
extern "C" int state_fold_chain(const void* sums, const void* crcs,
                                int n_leaves, void* out, void* stream) {
  if (n_leaves < 1) return int(cudaErrorInvalidValue);
  fold_chain<<<1, CHAIN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(sums),
      static_cast<const long long*>(crcs), n_leaves,
      static_cast<uint32_t*>(out));
  return int(cudaGetLastError());
}

extern "C" const char* state_fold_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

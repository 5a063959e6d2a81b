// Flash-attention forward in fp32 on Hopper's tensor cores (sm_90a) as
// 3xTF32: kernel K1, route "tf32x3".
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_kernels.py:_mha_kernel
// (:47), built by _build_flash (:119, the pl.pallas_call at :149) and
// entered through flash_attention (:173), for fp32 callers: fp32 is
// mxnet_tpu's default dtype. It computes what flash_attn_fwd.cu (the
// CUDA-core route, which stays for fp32 inputs this kernel does not take)
// and flash_attn_fwd_tc.cu (16-bit) compute: for q, k, v (B, H, T, D) f32,
//   s   = scale * (q k^T)              (scaled in f32, after the product)
//   s   = -inf where causal and q_offset + i < k_offset + j, or j >= T
//   O   = softmax(s) v
//   lse = m + log(max(l, 1e-20))       (m = row max, l = row sum)
// A row with no visible key gives O = 0 and lse = -1e30 + log(1e-20).
//
// Takes: f32; D in {64, 128}; q, k, v whose last dimension has stride 1,
// whose other strides are multiples of 4 elements (16 bytes) and whose
// base addresses are 16-byte aligned (ops/kernels.py:_flash_route); so the
// LM's q/k/v are read in place as strided views of the qkv projection's
// output. O is written into (B, T, H, D) memory, lse into contiguous
// (B, H, T).
//
// Accuracy: every product is 3xTF32 (hopper.cuh): each f32 operand is
// split into a TF32 hi part (cvt.rna) and a TF32 lo part (the rounded
// rest), and a b is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b in f32 on
// wgmma. Dropping lo_a lo_b leaves ~2^-22 of |a b|, the accuracy of
// PyTorch's own fp32 attention (its memory-efficient kernel is CUTLASS's
// 3xTF32 on mma.sync, OpMultiplyAddFastF32); one TF32 pass would keep
// ~2^-11.
//
// Bound on the H100 SXM at the LM's shape (8, 12, 1024, 64) fp32 causal:
// 1.29e10 FLOP of needed products, three TF32 passes at 495 TFLOP/s are
// 0.078 ms (at the 67 TFLOP/s of f32 FMA on the CUDA cores 0.192 ms); q,
// k, v read once, O and lse written once are 101 MB, 0.030 ms at
// 3.35 TB/s. So operations bound it.
//
// Design.
// - One CTA owns BQ = 64 WGS query rows of one (batch, head): WGS consumer
//   warpgroups of 64 rows and one producer warp. Grid (B * H, ceil(T /
//   BQ)); the heaviest causal tiles are dispatched first.
// - The producer TMA-loads raw f32 Q once and K, V tiles of BK keys into a
//   ring of STAGES stages guarded by full/empty mbarriers, 128-byte
//   swizzled, 32 columns a panel. Causal K/V tiles wholly in the future of
//   the CTA's rows are never loaded.
// - TF32 wgmma has no transpose flags: both shared-memory operands must be
//   K-major. Q (A of S = Q K^T) and K (its B) are K-major as loaded; the
//   consumers split them in place into hi, with lo in a second buffer (Q
//   once, K each tile). V is the B operand of O += P V, reduced over keys:
//   the consumers write its hi and lo transposed ([d][key]) into one
//   swizzled tile, each key at the column where P's accumulator fragment
//   puts it in the A fragment (hopper.cuh: frag_col), so P goes from the S
//   accumulator to the A registers of P V with no shuffle. All consumer
//   threads split each tile once (shared by the warpgroups), fence the
//   stores to the async proxy and meet on a named barrier; a second
//   barrier at the next tile keeps the split buffers until every
//   warpgroup's products have read them.
// - S = Q K^T: three SS wgmma m64nBKk8 per k8 step. The online softmax runs
//   on the f32 fragment in log2 units as in flash_attn_fwd_tc.cu; l is
//   summed from the unsplit p. O += P V: P split into hi and lo in
//   registers, three RS wgmma m64nDk8 per k8 step.
// - Epilogue: O = acc / max(l, 1e-20) from registers with a bounds check
//   on the row; lse by one thread of each quad.
//
// Tiles (Cfg): D = 64: two warpgroups (BQ = 128), BK = 64; D = 128: one
// warpgroup (BQ = 64), BK = 32; two stages. Shared memory: Q hi and lo
// 2 x BQ x D x 4, the K/V stages 2 x 2 x BK x D x 4, K lo BK x D x 4 and V^T
// hi | lo 2 x BK x D x 4: 176 KB for either D, one CTA per SM.
//
// What holds it back: the split pass (each K/V element read once and
// written twice by the CUDA cores, V transposed) and two barriers a tile
// sit between the products; one CTA per SM (its shared memory), whose
// warpgroups run Q K^T, softmax and P V in turn, with nothing to overlap
// them but the other warpgroup.
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr float NEG = -1e30f;           // the TPU kernel's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int MAX_Q_TILES = 65535;      // gridDim.y

template <int D> struct Cfg;
// WGS: consumer warpgroups of 64 query rows; BK: keys a K/V tile; STAGES:
// ring depth.
template <> struct Cfg<64> {
  static constexpr int WGS = 2, BK = 64, STAGES = 2;
};
template <> struct Cfg<128> {
  static constexpr int WGS = 1, BK = 32, STAGES = 2;
};
template <int D>
__host__ __device__ constexpr int block_q() { return 64 * Cfg<D>::WGS; }
template <int D>
__host__ __device__ constexpr int threads() {
  return Cfg<D>::WGS * 128 + 32;   // + one producer warp
}

template <int D>
constexpr int smem_bytes() {
  constexpr int BQ = block_q<D>(), BK = Cfg<D>::BK, S = Cfg<D>::STAGES;
  // Q hi (split in place) and lo; the K and V stages; K lo; V^T hi | lo;
  // 2 S + 1 mbarriers; 1 KB to align the tiles to the swizzle atom
  return 2 * BQ * D * 4 + 2 * S * BK * D * 4 + BK * D * 4 + 2 * BK * D * 4 +
         (2 * S + 1) * 8 + 1024;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

template <int D>
__global__ void __launch_bounds__(threads<D>(), 1)
flash_fwd_tf32x3_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        float* __restrict__ o, float* __restrict__ lse,
                        int n_heads, int t_len, float scale_log2, int causal,
                        int q_offset, int k_offset, int qpos, int kpos,
                        int vpos) {
  constexpr int WGS = Cfg<D>::WGS, BK = Cfg<D>::BK, STAGES = Cfg<D>::STAGES;
  constexpr int BQ = block_q<D>(), NC = WGS * 128;   // consumer threads
  constexpr int NP = D / PANEL32;                    // 32-column panels
  constexpr int Q_PANEL = BQ * ROW_BYTES;
  constexpr int Q_BYTES = NP * Q_PANEL;
  constexpr int KV_PANEL = BK * ROW_BYTES;
  constexpr int KV_BYTES = NP * KV_PANEL;
  constexpr int VT_BYTES = 2 * BK * D * 4;           // V^T hi | lo
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align1024(smem_raw);                 // Q, then its hi part
  uint8_t* sql = sq + Q_BYTES;                       // Q lo
  uint8_t* sk = sql + Q_BYTES;                       // STAGES K tiles
  uint8_t* sv = sk + STAGES * KV_BYTES;              // STAGES V tiles
  uint8_t* skl = sv + STAGES * KV_BYTES;             // K lo
  uint8_t* svt = skl + KV_BYTES;                     // V^T hi | lo
  uint64_t* full = reinterpret_cast<uint64_t*>(svt + VT_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh % n_heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first

  // Key j is visible to query row i when i + shift >= j; clamping the
  // offsets' difference to +-2^25 changes no comparison (rows < 2^23).
  const int shift = int(max(-(1LL << 25), min(1LL << 25, (long long)q_offset -
                                                             k_offset)));
  int n_kb = (t_len + BK - 1) / BK;
  if (causal) {
    const int last_key = q0 + min(BQ, t_len - q0) - 1 + shift;
    if (last_key < 0)
      n_kb = 0;
    else if (last_key / BK + 1 < n_kb)
      n_kb = last_key / BK + 1;
  }

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WGS * 4);   // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == WGS * 4) {
    // ---- producer: one thread keeps the TMA loads in flight
    if (lane != 0 || n_kb == 0) return;
    int c1, c2, c3;
    mbar_expect_tx(qbar, Q_BYTES);
    coords(qpos, q0, h, b, c1, c2, c3);
#pragma unroll
    for (int p = 0; p < NP; ++p)
      tma_load(sq + p * Q_PANEL, &tq, qbar, p * PANEL32, c1, c2, c3);
    for (int i = 0; i < n_kb; ++i) {
      const int s = i % STAGES, use = i / STAGES;
      if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
      mbar_expect_tx(&full[s], 2 * KV_BYTES);
      int k1, k2, k3, v1, v2, v3;
      coords(kpos, i * BK, h, b, k1, k2, k3);
      coords(vpos, i * BK, h, b, v1, v2, v3);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        tma_load(sk + s * KV_BYTES + p * KV_PANEL, &tk, &full[s],
                 p * PANEL32, k1, k2, k3);
        tma_load(sv + s * KV_BYTES + p * KV_PANEL, &tv, &full[s],
                 p * PANEL32, v1, v2, v3);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows q0 + 64 wg .. q0 + 64 wg + 63
  const int tid = threadIdx.x;                      // < NC
  const int wg = warp / 4, w = warp % 4;
  const int g = lane / 4, c = lane % 4;
  const int row0 = q0 + 64 * wg + 16 * w + g;       // and row0 + 8
  const int last_seen = q0 + 64 * wg + shift;   // last key of its row 0
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};   // m in log2 units

  if (n_kb > 0) {
    mbar_wait(qbar, 0);
    split_tile(sq, sql, Q_BYTES, tid, NC);
    fence_async_smem();
  }
  const int qw = 64 * wg * ROW_BYTES;           // this warpgroup's rows
  for (int i = 0; i < n_kb; ++i) {
    const int s = i % STAGES;
    const int k0 = i * BK;
    uint8_t* kt = sk + s * KV_BYTES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    consumers_sync(NC);   // every warpgroup is done with K lo and V^T
    split_tile(kt, skl, KV_BYTES, tid, NC);
    split_tile_t<BK, D, false>(sv + s * KV_BYTES, nullptr, svt, tid, NC);
    fence_async_smem();
    consumers_sync(NC);
    // a tile wholly in the causal future of this warpgroup's rows
    const bool skip = causal && k0 > last_seen + 63;
    if (!skip) {
      float sc[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const int qo = (kk / 4) * Q_PANEL + qw + (kk % 4) * 32;
        const int ko = (kk / 4) * KV_PANEL + (kk % 4) * 32;
        const uint64_t qh = sw128_desc(sq + qo, 16, 1024);
        const uint64_t kh = sw128_desc(kt + ko, 16, 1024);
        wgmma_ss_tf32<BK>(sc, sw128_desc(sql + qo, 16, 1024), kh, kk > 0);
        wgmma_ss_tf32<BK>(sc, qh, sw128_desc(skl + ko, 16, 1024), 1);
        wgmma_ss_tf32<BK>(sc, qh, kh, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin<BK / 2>(sc);

      const bool unmasked =
          k0 + BK <= t_len && (!causal || k0 + BK - 1 <= last_seen);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * scale_log2;
          if (!unmasked) {
            const int col = k0 + 8 * j + 2 * c + (e & 1);
            const bool ok = col < t_len &&
                            (!causal || row0 + 8 * (e >> 1) + shift >= col);
            x = ok ? x : -INFINITY;
          }
          sc[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);   // finite: m starts at NEG
        corr[r] = fast_exp2(m[r] - m_new);
        m[r] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fast_exp2(sc[4 * j + e] - m[e >> 1]);  // masked: 0
          rs[e >> 1] += p;
          sc[4 * j + e] = p;
        }
      uint32_t phi[BK / 8][4], plo[BK / 8][4];
      tf32_a_fragment<BK>(sc, phi, plo);
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * j + e] *= corr[e >> 1];

      pin<D / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const uint64_t vh = t_desc<BK, D>(svt, kk, false);
        wgmma_rs_tf32<D>(acc, plo[kk], vh);
        wgmma_rs_tf32<D>(acc, phi[kk], t_desc<BK, D>(svt, kk, true));
        wgmma_rs_tf32<D>(acc, phi[kk], vh);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin<D / 2>(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // ---- epilogue: each row's sum over its quad, then O and lse
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= t_len) continue;
    const float lc = fmaxf(l[r], 1e-20f);
    const float inv = 1.f / lc;
    float* orow = o + ((size_t(b) * t_len + row) * n_heads + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j + 2 * c) = make_float2(
          acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    if (c == 0)
      lse[size_t(bh) * t_len + row] =
          (m[r] == NEG ? NEG : m[r] * LN2) + logf(lc);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int h, int t, const long long* st, float scale, int causal,
           int q_offset, int k_offset, cudaStream_t stream) {
  constexpr int BQ = block_q<D>(), BK = Cfg<D>::BK;
  if ((t + BQ - 1) / BQ > MAX_Q_TILES) return ERR_SHAPE;
  CUtensorMap tq, tk, tv;
  int qpos, kpos, vpos, err;
  if ((err = make_map_f32(&tq, q, D, t, h, b, st[2], st[1], st[0], BQ,
                          &qpos)) ||
      (err = make_map_f32(&tk, k, D, t, h, b, st[5], st[4], st[3], BK,
                          &kpos)) ||
      (err = make_map_f32(&tv, v, D, t, h, b, st[8], st[7], st[6], BK,
                          &vpos)))
    return err;
  constexpr int smem = smem_bytes<D>();
  auto kernel = flash_fwd_tf32x3_kernel<D>;
  static unsigned long long attr_set = 0;   // one bit per device
  if ((err = allow_smem(kernel, smem, attr_set))) return err;
  dim3 grid(b * h, (t + BQ - 1) / BQ);
  kernel<<<grid, threads<D>(), smem, stream>>>(
      tq, tk, tv, static_cast<float*>(o), static_cast<float*>(lse), h, t,
      scale * LOG2E, causal, q_offset, k_offset, qpos, kpos, vpos);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32 (flash_attn_fwd_tc's signature); d: 64 or 128. q, k, v
// are f32 (b, h, t, d) with unit stride in d; strides holds their element
// strides over (b, h, t): q's three, then k's, then v's, each a multiple
// of 4, every base 16-byte aligned. o is contiguous f32 (b, t, h, d); lse
// contiguous f32 (b, h, t). Launches on `stream`, never synchronises, and
// returns 0, a cudaError_t, or one of hopper.cuh's ERR_* codes.
extern "C" int flash_attn_fwd_tf32x3(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int b, int h, int t, int d,
                                     const long long* strides, int dtype,
                                     float scale, int causal, int q_offset,
                                     int k_offset, void* stream) {
  if (dtype != 0 || b <= 0 || h <= 0 || t <= 0 ||
      (long long)b * h > 0x7fffffffLL)
    return ERR_SHAPE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch<64>(q, k, v, o, lse, b, h, t, strides, scale, causal,
                      q_offset, k_offset, s);
  if (d == 128)
    return launch<128>(q, k, v, o, lse, b, h, t, strides, scale, causal,
                       q_offset, k_offset, s);
  return ERR_SHAPE;
}

// The tiles of head dimension d: query rows a CTA, keys a K/V tile; 0 if
// d is not taken.
extern "C" int flash_attn_fwd_tf32x3_tiles(int d, int* rows, int* keys) {
  if (d == 64) {
    *rows = block_q<64>();
    *keys = Cfg<64>::BK;
    return 0;
  }
  if (d == 128) {
    *rows = block_q<128>();
    *keys = Cfg<128>::BK;
    return 0;
  }
  return ERR_SHAPE;
}

extern "C" const char* flash_attn_fwd_tf32x3_error_string(int err) {
  switch (err) {
    case ERR_NO_ENCODER:
      return "cuTensorMapEncodeTiled is not available from the driver";
    case ERR_ENCODE:
      return "cuTensorMapEncodeTiled refused a tensor map (strides or "
             "base address not 16-byte aligned?)";
    case ERR_SHAPE:
      return "shape, dtype or head dimension the 3xTF32 kernel does not "
             "take";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}

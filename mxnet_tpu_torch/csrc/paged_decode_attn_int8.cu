// Paged decode attention over an int8 pool for Hopper (sm_90a): K4's route
// "int8_bulk".
//
// Replaces mxnet_tpu/ops/decode_attention.py:paged_decode_attention (a
// fori_loop over page blocks there, not a pallas_call) on an int8 pool:
// k/v pages (P, page_size, H, D) int8 with f32 scales (P, page_size, H),
// written by kv_quantize (csrc/kv_quantize_write.cu), q (B, H, D) in
// f32/bf16/f16, an int32 page table (B, max_pages) and int32 lengths (B,),
// both read here on the device:
//   s_t = scale * k_scale_t * (q . k_t)     for the slot's tokens t < length
//   O   = sum_t softmax(s)_t v_scale_t v_t  (f32 sums, O in q's dtype)
// It keeps the contract of csrc/paged_decode_attn.cu: a row of length 0
// gives 0, a table entry outside [0, P) is clamped into it, only the
// ceil(length / page_size) live pages are read, the split count comes from
// the shapes and the SM count (never from the lengths, so a captured launch
// serves every later length), and no float atomics (a second launch is
// bitwise equal).
//
// Bound on the H100 SXM: bytes. At B=32, H=12, D=64, 1024 tokens a row it
// reads 50 MB of K and V and 3 MB of scales, 16 us at 3.35 TB/s, for 0.1
// GFLOP. The per-lane one-byte loads of the other kernel keep too few bytes
// in flight for that, so this one moves whole pages with the copy engine
// and spends its instructions on the arithmetic alone.
//
// Design. Grid (splits, B): split s of a slot takes the row's table
// entries s, s + splits, s + 2 splits, ... below ceil(length / page_size),
// so a short row still spreads over every split (the split count, from the
// shapes, sizes the grid for the longest row the table holds). A page of
// one layer's pool is contiguous over all heads
// (page_size * H * D bytes, 12 KB at the shape above; its scales 768 B),
// so warp 0's lane 0 (the producer) issues one cp.async.bulk (1-D TMA, the
// address from the page table, no tensor map) for K, V and each scale
// block of a page into a ring of STAGES stages in shared memory, each
// completing on its own mbarrier; consumer warps free a stage on a second
// mbarrier. A consumer lane owns 16 dims (16 bytes) of one head's token
// row: LPR = D / 16 lanes (rounded up to a power of two) hold a row, a
// warp covers 8 / LPR heads x 4 tokens a pass, and neighbouring heads'
// rows are neighbouring bytes, so each quarter-warp reads 128 contiguous
// bytes. A lane keeps its 16 dims of q as f32, dequantizes by byte permute
// and one add (no conversion instructions), takes a 16-term dot product,
// and reduces it over log2(LPR) xor shuffles. Each lane group keeps its
// own online softmax (m, l, 16 accumulators) over the tokens it takes; the
// groups of one head are merged once per split, within the warp by xor
// shuffles and across the warps that split a page's tokens through shared
// memory, in a fixed order. The partials go to a workspace that the
// combine kernel of csrc/decode_combine.cuh folds.
// (Folding them inside a thread block cluster of a slot's splits
// instead, through distributed shared memory, measured slower: the 8-CTA
// clusters of ~85 KB CTAs schedule worse than the second kernel costs.)
#include <stdint.h>

#include "decode_combine.cuh"
#include "hopper.cuh"

namespace {

// MAX_CONSUMERS and STAGES measured best of 6, 12 and of 2, 3, 4, 6 at
// B=32, H=12, D=64, pages of 16 (tools/torch_k4_variants.py)
constexpr int MAX_CONSUMERS = 12;                  // consumer warps a CTA
constexpr int THREADS = (1 + MAX_CONSUMERS) * 32;  // and the producer warp
constexpr int STAGES = 3;                          // pages in flight a CTA
constexpr int RING = 128;     // shared memory bytes before the ring (bars)
static_assert(STAGES >= 2 && 16 * STAGES <= RING,
              "a full and an empty barrier a stage before the ring");
constexpr int MAX_SMEM = 232448;        // the most a CTA can ask for

// The signed byte b of w, where w holds four int8 values xor 0x80 (biased
// to 0..255): 0x4B0000uu is the float 2^23 + uu, exactly.
__device__ __forceinline__ float s8(uint32_t w, int b) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7650u | b)) -
         8388736.f;
}

__device__ __forceinline__ uint4 lds16(const uint8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ float dot16(const float* q, uint4 k) {
  const uint32_t w[4] = {k.x ^ 0x80808080u, k.y ^ 0x80808080u,
                         k.z ^ 0x80808080u, k.w ^ 0x80808080u};
  float a = 0.f, c = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a = fmaf(q[4 * j], s8(w[j], 0), a);
    c = fmaf(q[4 * j + 1], s8(w[j], 1), c);
    a = fmaf(q[4 * j + 2], s8(w[j], 2), a);
    c = fmaf(q[4 * j + 3], s8(w[j], 3), c);
  }
  return a + c;
}

struct Geometry {            // one CTA's share of the work and its smem
  int H, D, ps, tws, hws;
  int page_bytes, scale_bytes, stage_bytes;
  uint8_t* ring;              // stages x (K page, V page, K, V scales)
  float* merge;               // tws x H x (2 + D): the token warps' partials
};

// The producer: lane 0 of warp 0 issues each page's four bulk copies into
// the ring, the CTA's pages being the row's table entries split, split +
// splits, ...
__device__ __forceinline__ void produce(
    const Geometry& g, uint64_t* full, uint64_t* empty, const int8_t* kp,
    const int8_t* vp, const float* ks, const float* vs, const int* entries,
    int n_my, int splits, int P) {
  for (int i = 0; i < n_my; ++i) {
    const int s = i % STAGES;
    if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
    const long long page = min(max(entries[i * splits], 0), P - 1);
    uint8_t* st = g.ring + s * g.stage_bytes;
    mbar_expect_tx(&full[s], g.stage_bytes);
    bulk_load(st, kp + page * g.page_bytes, g.page_bytes, &full[s]);
    bulk_load(st + g.page_bytes, vp + page * g.page_bytes, g.page_bytes,
              &full[s]);
    bulk_load(st + 2 * g.page_bytes, ks + page * g.ps * g.H, g.scale_bytes,
              &full[s]);
    bulk_load(st + 2 * g.page_bytes + g.scale_bytes, vs + page * g.ps * g.H,
              g.scale_bytes, &full[s]);
  }
}

// Consumer warp c: heads (c % hws) * HPW + [0, HPW), token groups (c / hws)
// * 4 + [0, 4) of every page (the i-th the CTA takes is the row's page
// first_page + i * splits). Leaves the CTA's partial (m, l, acc) of each
// head at `part` (H x (2 + D) floats: the workspace's row of this split).
template <typename QT, int LPR>
__device__ __forceinline__ void consume(
    const Geometry& g, uint64_t* full, uint64_t* empty, const QT* qrow0,
    long long q_sh, float* part, int len, int first_page, int n_my,
    int splits, float scale, int c, int lane) {
  constexpr int HPW = 8 / LPR;                 // heads a warp covers
  const int H = g.H, D = g.D, ps = g.ps;
  const int hw = c % g.hws, tw = c / g.hws;
  const int sub = lane & (LPR - 1), hh = (lane & 7) / LPR, tt = lane >> 3;
  const int h = hw * HPW + hh;
  const int hc = min(h, H - 1);
  const bool live = h < H && sub * 16 < D;     // the lane owns 16 dims
  const int tg = tw * 4 + tt, groups = g.tws * 4;
  const int row = hc * D + sub * 16;           // the lane's bytes in a token

  float qv[16], acc[16];
  const QT* qrow = qrow0 + hc * q_sh + sub * 16;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    qv[i] = live ? to_f32(qrow[i]) : 0.f;
    acc[i] = 0.f;
  }
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);   // sixteen int8 zeros
  float m = NEG, l = 0.f;
  for (int i = 0; i < n_my; ++i) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const uint8_t* kb = g.ring + s * g.stage_bytes;
    const uint8_t* vb = kb + g.page_bytes;
    const float* ksb = reinterpret_cast<const float*>(vb + g.page_bytes);
    const float* vsb = ksb + ps * H;
    const int n_tok = min(ps, len - (first_page + i * splits) * ps);
    // two tokens a group a pass, one rescale for both; the trip count is
    // the warp's, so every lane meets every shuffle
    for (int t = 0; t < n_tok; t += 2 * groups) {
      const int t0 = t + tg, t1 = t0 + groups;
      const bool ok0 = t0 < n_tok, ok1 = t1 < n_tok;
      const long long r0 = (long long)t0 * H * D + row;
      const long long r1 = (long long)t1 * H * D + row;
      float s0 = dot16(qv, ok0 && live ? lds16(kb + r0) : zero);
      float s1 = dot16(qv, ok1 && live ? lds16(kb + r1) : zero);
#pragma unroll
      for (int o = 1; o < LPR; o <<= 1) {
        s0 += __shfl_xor_sync(FULL, s0, o);
        s1 += __shfl_xor_sync(FULL, s1, o);
      }
      s0 = ok0 ? s0 * (scale * ksb[t0 * H + hc]) : NEG;
      s1 = ok1 ? s1 * (scale * ksb[t1 * H + hc]) : NEG;
      const float m_new = fmaxf(m, fmaxf(s0, s1));
      const float corr = expf(m - m_new);
      const float e0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float e1 = ok1 ? expf(s1 - m_new) : 0.f;
      l = fmaf(l, corr, e0 + e1);
      const float pv0 = ok0 ? e0 * vsb[t0 * H + hc] : 0.f;
      const float pv1 = ok1 ? e1 * vsb[t1 * H + hc] : 0.f;
      const uint4 v0 = ok0 && live ? lds16(vb + r0) : zero;
      const uint4 v1 = ok1 && live ? lds16(vb + r1) : zero;
      const uint32_t w0[4] = {v0.x ^ 0x80808080u, v0.y ^ 0x80808080u,
                              v0.z ^ 0x80808080u, v0.w ^ 0x80808080u};
      const uint32_t w1[4] = {v1.x ^ 0x80808080u, v1.y ^ 0x80808080u,
                              v1.z ^ 0x80808080u, v1.w ^ 0x80808080u};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          float a = acc[4 * j + x] * corr;
          a = fmaf(pv0, s8(w0[j], x), a);
          acc[4 * j + x] = fmaf(pv1, s8(w1[j], x), a);
        }
      }
      m = m_new;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // the warp's four token groups of each head, merged by xor shuffles
#pragma unroll
  for (int o = 8; o < 32; o <<= 1) {
    const float mo = __shfl_xor_sync(FULL, m, o);
    const float lo = __shfl_xor_sync(FULL, l, o);
    const float mn = fmaxf(m, mo);
    const float a = expf(m - mn), e = expf(mo - mn);
    l = l * a + lo * e;
#pragma unroll
    for (int x = 0; x < 16; ++x)
      acc[x] = acc[x] * a + __shfl_xor_sync(FULL, acc[x], o) * e;
    m = mn;
  }
  // then the warps that split the tokens, in warp order
  if (g.tws > 1) {
    float* mine = g.merge + ((long long)tw * H + hc) * (D + 2);
    if (tw > 0 && tt == 0 && h < H) {
      if (live) {
#pragma unroll
        for (int x = 0; x < 16; ++x) mine[2 + sub * 16 + x] = acc[x];
      }
      if (sub == 0) {
        mine[0] = m;
        mine[1] = l;
      }
    }
    consumers_sync(g.hws * g.tws * 32);
    if (tw > 0) return;
    for (int w = 1; w < g.tws; ++w) {
      const float* other = g.merge + ((long long)w * H + hc) * (D + 2);
      const float mo = other[0], lo = other[1];
      const float mn = fmaxf(m, mo);
      const float a = expf(m - mn), e = expf(mo - mn);
      l = l * a + lo * e;
#pragma unroll
      for (int x = 0; x < 16; ++x)
        acc[x] = acc[x] * a + (live ? other[2 + sub * 16 + x] : 0.f) * e;
      m = mn;
    }
  }
  if (tt == 0 && h < H) {
    float* w = part + (long long)h * (D + 2);
    if (live) {
#pragma unroll
      for (int x = 0; x < 16; ++x) w[2 + sub * 16 + x] = acc[x];
    }
    if (sub == 0) {
      w[0] = m;
      w[1] = l;
    }
  }
}

// One CTA: slot blockIdx.y, table entries split, split + splits, ...
// Warp 0 produces, the others consume; the CTA's partials go to its rows
// of `work`.
template <typename QT, int LPR>
__global__ void __launch_bounds__(THREADS, 2)
paged_decode_attn_int8_kernel(
    const QT* __restrict__ q, const int8_t* __restrict__ kp,
    const int8_t* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ table,
    const int* __restrict__ lengths, float* __restrict__ work,
    long long q_sb, long long q_sh, int H, int D, int P, int ps,
    int max_pages, int splits, int tws, float scale) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  Geometry g;
  g.H = H;
  g.D = D;
  g.ps = ps;
  g.tws = tws;
  g.hws = (H + 8 / LPR - 1) / (8 / LPR);
  g.page_bytes = ps * H * D;
  g.scale_bytes = ps * H * 4;
  g.stage_bytes = 2 * (g.page_bytes + g.scale_bytes);
  g.ring = smem + RING;
  g.merge = reinterpret_cast<float*>(g.ring + STAGES * g.stage_bytes);

  const int b = blockIdx.y, split = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long cap = (long long)max_pages * ps;
  const int len = int(min((long long)max(lengths[b], 0), cap));
  const int n_pages = (len + ps - 1) / ps;
  const int n_my = split < n_pages ? (n_pages - split + splits - 1) / splits
                                    : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], g.hws * tws);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 0) {
    if (lane == 0)
      produce(g, full, empty, kp, vp, ks, vs,
              table + (long long)b * max_pages + split, n_my, splits, P);
  } else {
    consume<QT, LPR>(g, full, empty, q + b * q_sb, q_sh,
                     work + ((long long)b * splits + split) * H * (D + 2),
                     len, split, n_my, splits, scale, warp - 1, lane);
  }
}

// Consumer warps: the warps a row of heads needs (hws), times as many
// token-group warps (tws) as fit in MAX_CONSUMERS, at most one group per
// 4 tokens of a page.
inline void warps_for(int H, int D, int ps, int& hws, int& tws) {
  int lpr = 1;
  while (lpr * 16 < D) lpr *= 2;
  const int hpw = 8 / lpr;
  hws = (H + hpw - 1) / hpw;
  tws = hws > 0 ? MAX_CONSUMERS / hws : 1;
  const int by_tokens = ps / 4 > 1 ? ps / 4 : 1;
  if (tws > by_tokens) tws = by_tokens;
  if (tws < 1) tws = 1;
}

inline long long smem_bytes(int H, int D, int ps, int tws) {
  const long long stage = 2LL * ps * H * (D + 4);
  return RING + STAGES * stage + 4LL * tws * H * (D + 2);
}

// Whether the kernel takes pools of H heads, head dim D and pages of ps
// tokens (alignment aside): D a multiple of 16 up to 128, a page's scales a
// multiple of 16 bytes, the head warps within MAX_CONSUMERS and the CTA's
// shared memory within MAX_SMEM; and its geometry there.
inline bool geometry(int H, int D, int ps, int& hws, int& tws,
                     long long& smem) {
  hws = tws = 0;
  smem = 0;
  if (H < 1 || ps < 1 || D < 16 || D > 128 || D % 16 || (ps * H) % 4)
    return false;
  warps_for(H, D, ps, hws, tws);
  smem = smem_bytes(H, D, ps, tws);
  return hws <= MAX_CONSUMERS && smem <= MAX_SMEM;
}

template <typename Kernel>
int prepare(Kernel* kernel, unsigned long long& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  if (dev < 64 && ((done >> dev) & 1)) return 0;
  int err = allow_smem(kernel, MAX_SMEM, done);
  if (err) return err;
  // as much of the SM's memory for shared memory as it gives, so that two
  // CTAs of ~85 KB can share an SM where the grid has more CTAs than SMs
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           int(cudaSharedmemCarveoutMaxShared));
  return int(e);
}

struct Args {                 // the entry point's operands, as given
  const void *q, *kp, *vp, *ks, *vs, *table, *lengths;
  void *out, *work;
  long long q_sb, q_sh;
  int B, H, D, P, ps, max_pages, splits;
  float scale;
  cudaStream_t stream;
};

template <typename QT, int LPR>
int launch(const Args& a) {
  static unsigned long long attr_set = 0;
  int hws, tws;
  long long smem;
  if (!geometry(a.H, a.D, a.ps, hws, tws, smem)) return ERR_SHAPE;
  auto kernel = paged_decode_attn_int8_kernel<QT, LPR>;
  int err = prepare(kernel, attr_set);
  if (err) return err;
  kernel<<<dim3(a.splits, a.B), (1 + hws * tws) * 32, int(smem),
           a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const int8_t*>(a.kp),
      static_cast<const int8_t*>(a.vp), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.table),
      static_cast<const int*>(a.lengths), static_cast<float*>(a.work),
      a.q_sb, a.q_sh, a.H, a.D, a.P, a.ps, a.max_pages, a.splits, tws,
      a.scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  return int(launch_combine<QT, 128>(a.work, a.out, a.B, a.H, a.D,
                                     a.splits, a.stream));
}

template <typename QT>
int dispatch_d(const Args& a) {
  if (a.D <= 16) return launch<QT, 1>(a);
  if (a.D <= 32) return launch<QT, 2>(a);
  if (a.D <= 64) return launch<QT, 4>(a);
  return launch<QT, 8>(a);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// The geometry a launch at (H, D, ps) takes: head warps, token warps,
// ring stages and shared memory bytes a CTA. Returns 0 where the kernel
// takes that shape (16-byte-aligned pools aside), else ERR_SHAPE. The
// route rule (ops/decode_attention.py:_decode_route) asks this.
extern "C" int paged_decode_attn_int8_geometry(int H, int D, int ps,
                                               int* hws, int* tws,
                                               int* stages,
                                               long long* smem) {
  const bool ok = geometry(H, D, ps, *hws, *tws, *smem);
  *stages = STAGES;
  return ok ? 0 : ERR_SHAPE;
}

// qdtype: q's code (0 f32, 1 bf16, 2 f16). kp, vp int8 and ks, vs f32,
// each 16-byte aligned; a shape paged_decode_attn_int8_geometry takes.
// work: f32 (B, splits, H, D + 2). Returns 0, a cudaError_t code or
// ERR_SHAPE.
extern "C" int paged_decode_attn_int8(const void* q, const void* kp,
                                      const void* vp, const void* ks,
                                      const void* vs, const void* table,
                                      const void* lengths, void* out,
                                      void* work, long long q_sb,
                                      long long q_sh, int B, int H, int D,
                                      int P, int ps, int max_pages,
                                      int splits, int qdtype, float scale,
                                      void* stream) {
  if (B < 1 || B > 65535 || H < 1 || P < 1 || ps < 1 || max_pages < 1 ||
      splits < 1 || splits > 65535 || qdtype < 0 || qdtype > 2)
    return int(cudaErrorInvalidValue);
  if (!aligned16(kp) || !aligned16(vp) || !aligned16(ks) || !aligned16(vs))
    return ERR_SHAPE;
  const Args a{q, kp, vp, ks, vs, table, lengths, out, work, q_sb, q_sh, B,
               H, D, P, ps, max_pages, splits, scale,
               static_cast<cudaStream_t>(stream)};
  switch (qdtype) {
    case 0:
      return dispatch_d<float>(a);
    case 1:
      return dispatch_d<__nv_bfloat16>(a);
    default:
      return dispatch_d<__half>(a);
  }
}

extern "C" const char* paged_decode_attn_int8_error_string(int err) {
  if (err == ERR_SHAPE)
    return "a shape or alignment the int8 bulk-copy kernel does not take "
           "(D a multiple of 16 up to 128, 16-byte-aligned pools, a page's "
           "scales a multiple of 16 bytes, a ring that fits in shared "
           "memory)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

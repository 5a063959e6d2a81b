// Paged decode attention for Hopper (sm_90a), kernel K4 of the port.
//
// Replaces mxnet_tpu/ops/decode_attention.py:paged_decode_attention (a
// fori_loop over page blocks there, not a pallas_call). For one query token
// per sequence slot, q (B, H, D), it attends over the slot's KV history in
// a shared page pool, k/v pages (P, page_size, H, D) in f32 or int8 (int8
// dequantized on the gather against f32 scales (P, page_size, H)), reached
// through an int32 page table (B, max_pages) and int32 lengths (B,), both
// read here on the device:
//   s_t = scale * q . k_t          for the slot's tokens t < length
//   O   = sum_t softmax(s)_t v_t   (softmax and sums in f32, O in q's dtype)
// A row of length 0 gives O = 0. A table entry outside [0, P) is clamped
// into it (the reference's gather clamps). Only the ceil(length /
// page_size) pages a row holds are read.
//
// Bound on the H100 SXM. One token reads every live KV byte once and does
// 4 D FLOP per (token, head): at B=32, H=12, D=64, 1024 tokens a row the
// f32 pool moves 201 MB (60 us at 3.35 TB/s) for 0.1 GFLOP, the int8 pool
// 50 MB plus 3 MB of scales (16 us). It is bytes-bound by far, so the
// design is about keeping enough loads in flight, not about the products.
//
// Design (simple first). Split-K over the pages: grid (splits, B), each CTA
// owning `per` consecutive table entries of one slot, with one warp per
// head (heads beyond the CTA's warps loop). B alone (32 slots) would leave
// most of the 132 SMs idle, so the wrapper picks the split count from the
// shapes and the SM count only (ops/decode_attention.py:decode_splits),
// never from the lengths: a captured launch then serves every later length,
// and a split past a row's last page writes an empty partial. Each lane
// owns the D elements lane + 32 j; a chunk of CH tokens of K and V is
// loaded in one go (CH * NV * 2 independent loads a lane), the CH scores
// reduced by xor shuffles, and folded into the warp's running max, sum and
// accumulator (f32). The partials (m, l, acc) go to an f32 workspace (B,
// splits, H, 2 + D); a second kernel (csrc/decode_combine.cuh) combines
// each (slot, head) over its splits in split order, so a second launch is
// bitwise equal. The loads are plain per-lane loads through the read-only
// path. An int8 pool whose pages the copy engine can move takes
// csrc/paged_decode_attn_int8.cu instead (ops/decode_attention.py:
// _decode_route); this kernel keeps every f32 pool and the int8 pools that
// one does not take (D not a multiple of 16, misaligned pools).
#include <stdint.h>

#include "decode_combine.cuh"

namespace {

constexpr int MAX_WARPS = 16;      // warps per CTA of the split kernel

__device__ __forceinline__ float kv_load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float kv_load(const int8_t* p) {
  return float(__ldg(reinterpret_cast<const signed char*>(p)));
}

// One CTA: slot blockIdx.y, table entries [split * per, split * per + per).
// Each warp takes heads warp, warp + nwarps, ...; lane owns d = lane + 32 j.
template <typename QT, typename KV, int NV, int CH>
__global__ void __launch_bounds__(MAX_WARPS * 32)
paged_decode_attn_split_kernel(
    const QT* __restrict__ q, const KV* __restrict__ kp,
    const KV* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ table,
    const int* __restrict__ lengths, float* __restrict__ work,
    long long q_sb, long long q_sh, int H, int D, int P, int ps,
    int max_pages, int splits, int per, float scale) {
  constexpr bool kInt8 = sizeof(KV) == 1;
  const int b = blockIdx.y, split = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const long long cap = (long long)max_pages * ps;
  const int len = int(min((long long)max(lengths[b], 0), cap));
  const int n_pages = (len + ps - 1) / ps;
  const int p0 = split * per;
  const int p1 = min(p0 + per, n_pages);
  const int* trow = table + (long long)b * max_pages;

  for (int h = warp; h < H; h += nwarps) {
    float qv[NV], acc[NV];
    const QT* qrow = q + b * q_sb + h * q_sh;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int d = lane + 32 * j;
      qv[j] = d < D ? to_f32(qrow[d]) : 0.f;
      acc[j] = 0.f;
    }
    float m = NEG, l = 0.f;
    for (int pi = p0; pi < p1; ++pi) {
      const int page = min(max(trow[pi], 0), P - 1);
      const int n_tok = min(ps, len - pi * ps);
      const long long row0 = (long long)page * ps * H + h;  // token 0's row
      for (int t0 = 0; t0 < n_tok; t0 += CH) {
        float kx[CH][NV], vx[CH][NV];
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const bool ok = t0 + c < n_tok;
          const long long row = row0 + (long long)(t0 + c) * H;
          float ksc = 1.f, vsc = 1.f;
          if (kInt8 && ok) {
            ksc = __ldg(ks + row);
            vsc = __ldg(vs + row);
          }
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            const int d = lane + 32 * j;
            const bool in = ok && d < D;
            kx[c][j] = in ? kv_load(kp + row * D + d) * ksc : 0.f;
            vx[c][j] = in ? kv_load(vp + row * D + d) * vsc : 0.f;
          }
        }
        float s[CH];
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          float dot = 0.f;
#pragma unroll
          for (int j = 0; j < NV; ++j) dot = fmaf(qv[j], kx[c][j], dot);
          s[c] = dot;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
          for (int c = 0; c < CH; ++c)
            s[c] += __shfl_xor_sync(FULL, s[c], off);
        }
        float cmax = NEG;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          s[c] *= scale;
          if (t0 + c < n_tok) cmax = fmaxf(cmax, s[c]);
        }
        const float m_new = fmaxf(m, cmax);
        const float corr = expf(m - m_new);
        float p[CH], psum = 0.f;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          p[c] = t0 + c < n_tok ? expf(s[c] - m_new) : 0.f;
          psum += p[c];
        }
        l = l * corr + psum;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          float a = acc[j] * corr;
#pragma unroll
          for (int c = 0; c < CH; ++c) a = fmaf(p[c], vx[c][j], a);
          acc[j] = a;
        }
        m = m_new;
      }
    }
    float* w = work + (((long long)b * splits + split) * H + h) * (D + 2);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int d = lane + 32 * j;
      if (d < D) w[2 + d] = acc[j];
    }
    if (lane == 0) {
      w[0] = m;
      w[1] = l;
    }
  }
}

template <typename QT, typename KV, int NV>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const void* table,
                   const void* lengths, void* out, void* work,
                   long long q_sb, long long q_sh, int B, int H, int D,
                   int P, int ps, int max_pages, int splits, int per,
                   float scale, cudaStream_t stream) {
  constexpr int CH = 16 / NV;
  const int warps = H < MAX_WARPS ? H : MAX_WARPS;
  paged_decode_attn_split_kernel<QT, KV, NV, CH>
      <<<dim3(splits, B), warps * 32, 0, stream>>>(
          static_cast<const QT*>(q), static_cast<const KV*>(kp),
          static_cast<const KV*>(vp), static_cast<const float*>(ks),
          static_cast<const float*>(vs), static_cast<const int*>(table),
          static_cast<const int*>(lengths), static_cast<float*>(work), q_sb,
          q_sh, H, D, P, ps, max_pages, splits, per, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_combine<QT, 256>(work, out, B, H, D, splits, stream);
}

template <typename QT, typename KV>
cudaError_t dispatch_d(const void* q, const void* kp, const void* vp,
                       const void* ks, const void* vs, const void* table,
                       const void* lengths, void* out, void* work,
                       long long q_sb, long long q_sh, int B, int H, int D,
                       int P, int ps, int max_pages, int splits, int per,
                       float scale, cudaStream_t s) {
  if (D <= 32)
    return launch<QT, KV, 1>(q, kp, vp, ks, vs, table, lengths, out, work,
                             q_sb, q_sh, B, H, D, P, ps, max_pages, splits,
                             per, scale, s);
  if (D <= 64)
    return launch<QT, KV, 2>(q, kp, vp, ks, vs, table, lengths, out, work,
                             q_sb, q_sh, B, H, D, P, ps, max_pages, splits,
                             per, scale, s);
  if (D <= 128)
    return launch<QT, KV, 4>(q, kp, vp, ks, vs, table, lengths, out, work,
                             q_sb, q_sh, B, H, D, P, ps, max_pages, splits,
                             per, scale, s);
  return launch<QT, KV, 8>(q, kp, vp, ks, vs, table, lengths, out, work,
                           q_sb, q_sh, B, H, D, P, ps, max_pages, splits, per,
                           scale, s);
}

template <typename QT>
cudaError_t dispatch_kv(bool int8, const void* q, const void* kp,
                        const void* vp, const void* ks, const void* vs,
                        const void* table, const void* lengths, void* out,
                        void* work, long long q_sb, long long q_sh, int B,
                        int H, int D, int P, int ps, int max_pages,
                        int splits, int per, float scale, cudaStream_t s) {
  if (int8)
    return dispatch_d<QT, int8_t>(q, kp, vp, ks, vs, table, lengths, out,
                                  work, q_sb, q_sh, B, H, D, P, ps, max_pages,
                                  splits, per, scale, s);
  return dispatch_d<QT, float>(q, kp, vp, ks, vs, table, lengths, out, work,
                               q_sb, q_sh, B, H, D, P, ps, max_pages, splits,
                               per, scale, s);
}

}  // namespace

// dtype: q's code (0 f32, 1 bf16, 2 f16) + 4 for an int8 pool (ks, vs then
// non-null). work: f32 (B, splits, H, D + 2). Returns a cudaError_t code.
extern "C" int paged_decode_attn(const void* q, const void* kp,
                                 const void* vp, const void* ks,
                                 const void* vs, const void* table,
                                 const void* lengths, void* out, void* work,
                                 long long q_sb, long long q_sh, int B, int H,
                                 int D, int P, int ps, int max_pages,
                                 int splits, int per, int dtype, float scale,
                                 void* stream) {
  const bool int8 = dtype >= 4;
  const int qd = dtype & 3;
  if (B < 1 || B > 65535 || H < 1 || D < 1 || D > 256 || P < 1 || ps < 1 ||
      max_pages < 1 || splits < 1 || per < 1 ||
      (long long)splits * per < max_pages || qd > 2 ||
      (int8 && (ks == nullptr || vs == nullptr)))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (qd) {
    case 0:
      return int(dispatch_kv<float>(int8, q, kp, vp, ks, vs, table, lengths,
                                    out, work, q_sb, q_sh, B, H, D, P, ps,
                                    max_pages, splits, per, scale, s));
    case 1:
      return int(dispatch_kv<__nv_bfloat16>(
          int8, q, kp, vp, ks, vs, table, lengths, out, work, q_sb, q_sh, B,
          H, D, P, ps, max_pages, splits, per, scale, s));
    default:
      return int(dispatch_kv<__half>(int8, q, kp, vp, ks, vs, table, lengths,
                                     out, work, q_sb, q_sh, B, H, D, P, ps,
                                     max_pages, splits, per, scale, s));
  }
}

extern "C" const char* paged_decode_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The second pass of K3's BatchNorm statistics, shared by its three sources
// (csrc/conv3x3_bn_stats.cu, csrc/conv3x3_bn_stats_tc.cu and
// csrc/conv3x3_bn_stats_tf32x3.cu). Each conv kernel writes one partial sum
// and sum of squares per (M tile, output channel) into part (2, M tiles,
// Cout); reduce_stats_kernel adds them in a fixed order, so no f32 atomics
// are needed and two launches are bitwise equal.
//
// ops/_build.py hashes this file into the digest of every source that
// includes it. Everything here has internal linkage: each library keeps its
// own copy.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int RC = 32;             // channels per reduction block
constexpr int RS = 32;             // partial-sum segments per channel

// sums[0][c] = sum over M tiles of part[0][t][c], sums[1][c] likewise, in
// a fixed order: segment g takes tiles g, g + RS, ... in turn, then the RS
// segments are added in order. Launch: (ceil(cout / RC)) blocks of
// (RC, RS) threads.
__global__ void __launch_bounds__(RC * RS)
reduce_stats_kernel(const float* __restrict__ part, float* __restrict__ sums,
                    int m_tiles, int cout) {
  __shared__ float ss[RS][RC + 1];
  __shared__ float sq[RS][RC + 1];
  const int lane = threadIdx.x;
  const int seg = threadIdx.y;
  const int c = blockIdx.x * RC + lane;
  float s = 0.f, q = 0.f;
  if (c < cout) {
    for (int t = seg; t < m_tiles; t += RS) {
      s += part[(size_t)t * cout + c];
      q += part[(size_t)(m_tiles + t) * cout + c];
    }
  }
  ss[seg][lane] = s;
  sq[seg][lane] = q;
  __syncthreads();
  if (seg == 0 && c < cout) {
    float a = 0.f, b = 0.f;
    for (int g = 0; g < RS; ++g) {
      a += ss[g][lane];
      b += sq[g][lane];
    }
    sums[c] = a;
    sums[cout + c] = b;
  }
}

// Launches reduce_stats_kernel on `stream`; returns its cudaError_t.
inline cudaError_t reduce_stats(const void* part, void* sums, int m_tiles,
                                int cout, cudaStream_t stream) {
  reduce_stats_kernel<<<(cout + RC - 1) / RC, dim3(RC, RS), 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(sums), m_tiles,
      cout);
  return cudaGetLastError();
}

}  // namespace

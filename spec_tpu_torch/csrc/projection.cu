// Full-perspective projection of batched point sets, hand-written for
// Hopper (sm_90a). Plain C interface, loaded with ctypes by
// spec_tpu_torch/ops/projection.py, which also holds the plain PyTorch
// twin.
//
// Replaces spec_tpu/ops/pallas/projection.py:_proj_kernel (reached
// through project_points). The camera of batch row b collapses to
// P = K'[R | t] (3, 4), K' being K with its third row forced to
// [0, 0, 1]; then per point X:
//
//   u = P0 . [X, 1],  v = P1 . [X, 1],  w = max(P2 . [X, 1], 1e-8)
//   out = (u * (1 / w), v * (1 / w))
//
// Exact fp32; 1 / w is an IEEE division.
//
// What bounds it on an H100: bytes. 20 B per point (12 in, 8 out) and
// ~26 FLOP, so a batch of 16 SMPL meshes (110,240 points, 2.2 MB) is
// ~0.7 us of HBM time at 3.35 TB/s; one launch costs more than that. So
// the whole call is one launch:
//
// - The kernel takes R (B, 3, 3), t (B, 3) and K (B, 3, 3) and collapses
//   the camera itself. A block covers 512 consecutive points of the flat
//   (B * V, 3) array; it first computes P for the batch rows those points
//   fall in (at most 32 rows are kept in shared memory; points of rows
//   past those, which only V < 17 gives, compute P where they are).
// - Each thread takes 4 consecutive points: three 16-byte loads and two
//   16-byte stores when the arrays are 16-byte aligned; the ragged tail
//   (and unaligned arrays) go word by word. A quad may straddle batch
//   rows: the row index advances at most once per point.
// - 216 blocks of 128 threads for 16 x 6890 points.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kQuad = 4;                           // points per thread
constexpr int kPointsPerBlock = kThreads * kQuad;  // 512
constexpr int kCachedRows = 32;

// Entry e (row e / 4, column e % 4) of P = K'[R | t] for batch row b.
__device__ __forceinline__ float camera_entry(const float* __restrict__ R,
                                              const float* __restrict__ t,
                                              const float* __restrict__ K,
                                              int b, int e) {
  const int i = e >> 2;
  const int j = e & 3;
  const float* Rb = R + (size_t)b * 9;
  const float* tb = t + (size_t)b * 3;
  if (i == 2) return j < 3 ? Rb[6 + j] : tb[2];
  const float* k = K + (size_t)b * 9 + 3 * i;
  if (j < 3) return k[0] * Rb[j] + k[1] * Rb[3 + j] + k[2] * Rb[6 + j];
  return k[0] * tb[0] + k[1] * tb[1] + k[2] * tb[2];
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
project_kernel(const float* __restrict__ pts,  // (B * V, 3)
               const float* __restrict__ R,    // (B, 3, 3)
               const float* __restrict__ t,    // (B, 3)
               const float* __restrict__ K,    // (B, 3, 3)
               float* __restrict__ out,        // (B * V, 2)
               int n, int V) {
  __shared__ float cam_s[kCachedRows * 12];
  const int p0 = blockIdx.x * kPointsPerBlock;
  const int b_lo = p0 / V;
  const int p_last = min(p0 + kPointsPerBlock, n) - 1;
  const int rows = min(p_last / V - b_lo + 1, kCachedRows);
  for (int i = threadIdx.x; i < rows * 12; i += kThreads) {
    cam_s[i] = camera_entry(R, t, K, b_lo + i / 12, i % 12);
  }
  __syncthreads();

  const int q = p0 + threadIdx.x * kQuad;
  if (q >= n) return;
  const int np = min(kQuad, n - q);
  const bool full = kVec && np == kQuad;

  float xyz[3 * kQuad];
  if (full) {
    const float4* s = reinterpret_cast<const float4*>(pts + (size_t)q * 3);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float4 a = __ldg(s + k);
      xyz[4 * k] = a.x;
      xyz[4 * k + 1] = a.y;
      xyz[4 * k + 2] = a.z;
      xyz[4 * k + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 3 * kQuad; ++k) {
      xyz[k] = k < 3 * np ? __ldg(pts + (size_t)q * 3 + k) : 0.f;
    }
  }

  float uv[2 * kQuad];
  int b = q / V;
  int next = (b + 1) * V;  // first point of row b + 1
#pragma unroll
  for (int k = 0; k < kQuad; ++k) {
    if (q + k >= next) {
      ++b;
      next += V;
    }
    float P[12];
    const int r = b - b_lo;
    if (r < rows) {
#pragma unroll
      for (int e = 0; e < 12; ++e) P[e] = cam_s[r * 12 + e];
    } else {
#pragma unroll
      for (int e = 0; e < 12; ++e) P[e] = camera_entry(R, t, K, b, e);
    }
    const float x = xyz[3 * k], y = xyz[3 * k + 1], z = xyz[3 * k + 2];
    const float u = P[0] * x + P[1] * y + P[2] * z + P[3];
    const float v = P[4] * x + P[5] * y + P[6] * z + P[7];
    const float w = fmaxf(P[8] * x + P[9] * y + P[10] * z + P[11], 1e-8f);
    const float inv_w = 1.0f / w;
    uv[2 * k] = u * inv_w;
    uv[2 * k + 1] = v * inv_w;
  }

  if (full) {
    float4* o = reinterpret_cast<float4*>(out + (size_t)q * 2);
    o[0] = make_float4(uv[0], uv[1], uv[2], uv[3]);
    o[1] = make_float4(uv[4], uv[5], uv[6], uv[7]);
  } else {
#pragma unroll
    for (int k = 0; k < 2 * kQuad; ++k) {
      if (k < 2 * np) out[(size_t)q * 2 + k] = uv[k];
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched). pts (B, V, 3) and out (B, V, 2)
// float32; R, t, K float32 and contiguous. Allocates nothing and does
// not synchronize.
int spec_project_points(const void* pts, const void* R, const void* t,
                        const void* K, void* out, int B, int V,
                        void* stream) {
  if (B < 0 || V < 0) return int(cudaErrorInvalidValue);
  const long long n = (long long)B * V;
  if (n == 0) return 0;
  // Point indices, and the row ends the kernel steps to, stay in an int.
  if (n > (long long)INT_MAX - kPointsPerBlock - V) {
    return int(cudaErrorInvalidValue);
  }
  const int blocks = int((n + kPointsPerBlock - 1) / kPointsPerBlock);
  const float* p = static_cast<const float*>(pts);
  const float* r = static_cast<const float*>(R);
  const float* tt = static_cast<const float*>(t);
  const float* k = static_cast<const float*>(K);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aligned16(pts) && aligned16(out)) {
    project_kernel<true><<<blocks, kThreads, 0, s>>>(p, r, tt, k, o, int(n),
                                                     V);
  } else {
    project_kernel<false><<<blocks, kThreads, 0, s>>>(p, r, tt, k, o,
                                                      int(n), V);
  }
  return int(cudaGetLastError());
}

}  // extern "C"

// Full-perspective projection of batched point sets, hand-written for
// Hopper (sm_90a). Plain C interface, loaded with ctypes by
// spec_tpu_torch/ops/projection.py, which also holds the plain PyTorch
// twin and collapses the camera to P = K'[R | t] (fp32, TF32 off).
//
// Replaces spec_tpu/ops/pallas/projection.py:_proj_kernel (reached
// through project_points). Per point X of batch row b, with P (B, 3, 4):
//
//   u = P0 . [X, 1],  v = P1 . [X, 1],  w = max(P2 . [X, 1], 1e-8)
//   out = (u * (1 / w), v * (1 / w))
//
// Design: one thread per point, reading (B, V, 3) and writing (B, V, 2)
// in place of the TPU's padded SoA (3, Bp, Vp) planes and transposes;
// the block's camera rows come from a 12-float read that every thread of
// a batch row shares through L1. Exact fp32; 1 / w is an IEEE division.
//
// What bounds it on an H100: bytes. 20 B per point (12 in, 8 out) and
// ~20 FLOP, so a full batch of 16 SMPL meshes (110,240 points, 2.2 MB)
// is ~0.7 us of HBM time at 3.35 TB/s and the call is dominated by its
// launch. The model heads keep geometry.perspective_projection for their
// 49 joints, as the JAX heads do; fusing this as an epilogue of the LBS
// kernel (K1) is where it would pay.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
project_kernel(const float* __restrict__ pts,  // (B, V, 3)
               const float* __restrict__ cam,  // (B, 3, 4)
               float* __restrict__ out,        // (B, V, 2)
               int V) {
  const int b = blockIdx.y;
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= V) return;
  const float* P = cam + size_t(b) * 12;
  const float* p = pts + (size_t(b) * V + v) * 3;
  const float x = p[0], y = p[1], z = p[2];
  const float u = P[0] * x + P[1] * y + P[2] * z + P[3];
  const float vv = P[4] * x + P[5] * y + P[6] * z + P[7];
  const float w = fmaxf(P[8] * x + P[9] * y + P[10] * z + P[11], 1e-8f);
  const float inv_w = 1.0f / w;
  float* o = out + (size_t(b) * V + v) * 2;
  o[0] = u * inv_w;
  o[1] = vv * inv_w;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched).
int spec_project_points(const void* pts, const void* cam, void* out, int B,
                        int V, void* stream) {
  if (B <= 0 || V <= 0 || B > 65535) return int(cudaErrorInvalidValue);
  dim3 grid((V + kThreads - 1) / kThreads, B);
  project_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(cam),
      static_cast<float*>(out), V);
  return int(cudaGetLastError());
}

}  // extern "C"

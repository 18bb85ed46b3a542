// Fused SMPL blendshapes + linear blend skinning, hand-written for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// spec_tpu_torch/ops/lbs.py, which also holds the plain PyTorch twin.
//
// Replaces spec_tpu/ops/pallas/lbs.py:_lbs_kernel (reached through
// _fused_core / fused_lbs_vertices). It computes the same thing, not the
// same block layout:
//
//   posed_c[b, v] = sum_m coeffs[b, m] * dirs[c, m, v]          c = x, y, z
//     with coeffs = [betas (10) | (R - I) pose features (207) | 1]
//     and dirs    = [shapedirs | posedirs | v_template]       (3, 218, Vp)
//   t_k[b, v]     = sum_j A[b, j, k] * weights_t[j, v]        k < 12
//     with A the rest-corrected 3x4 joint transforms (B, 24, 3, 4)
//   out[b, v, i]  = t_{4i} px + t_{4i+1} py + t_{4i+2} pz + t_{4i+3}
//
// Design. One thread per vertex, 64 vertices per block, and a batch tile
// of BT <= 32 rows per block (BT is the smallest power of two >= B, so
// small batches waste no FMAs). The block stages the tile's coefficients
// (BT x 218) and transforms (BT x 12 x 24) in shared memory, where every
// thread reads the same word (a broadcast). Each thread streams its
// vertex's column of dirs once per batch tile (neighbouring threads read
// neighbouring addresses, so loads coalesce along V) and keeps 3 x BT
// posed sums in registers; it parks them in its own shared-memory column,
// reads its 24 skinning weights once and applies the 12 blended transform
// rows row by row of the batch tile. Output is written as (B, V, 3)
// directly: no padded (3, Bp, Vp) buffer and no transpose afterwards.
//
// Precision: exact fp32 FMAs on the CUDA cores; no tensor cores and no
// TF32 (the vertex budget is 1e-5 m against the fp32 reference).
//
// What bounds it on an H100. At B = 32 the kernel reads dirs
// (3 * 218 * 7168 * 4 B = 18.8 MB) once, writes 32 * 6890 * 12 B = 2.6 MB
// and does about 0.43 GFLOP, i.e. ~6 us at 3.35 TB/s against ~6 us at
// 67 TFLOP/s of fp32 FMA: bytes and FMAs are about balanced. At B = 1 it
// is bound by reading dirs. Because the whole batch tile (up to 32 rows)
// lives in one block's registers and shared memory, dirs crosses device
// memory once per call for B <= 32; larger batches re-read it per tile,
// from the 50 MB L2. With 64-vertex blocks, V = 6890 gives 108 blocks
// per batch tile, so latency, not bandwidth, is the first limit at small
// B; TMA staging of dirs or 3xTF32 wgmma are the next steps. bf16 dirs
// would change the precision and are not an option.

#include <cuda_runtime.h>

namespace {

constexpr int kJoints = 24;
constexpr int kRows = 12;  // row-major 3x4 transform
constexpr int kVertsPerBlock = 64;

template <int BT>
__global__ void __launch_bounds__(kVertsPerBlock)
lbs_kernel(const float* __restrict__ dirs,    // (3, C, Vp)
           const float* __restrict__ wt,      // (24, Vp)
           const float* __restrict__ coeffs,  // (B, C)
           const float* __restrict__ rel_tf,  // (B, 24, 3, 4)
           float* __restrict__ out,           // (B, V, 3)
           int B, int C, int V, int Vp) {
  extern __shared__ float smem[];
  float* coef_s = smem;                          // (BT, C)
  float* a_s = coef_s + BT * C;                  // (BT, 12, 24)
  float* posed_s = a_s + BT * kRows * kJoints;   // (3, BT, 64)

  const int b0 = blockIdx.y * BT;
  const int nb = min(BT, B - b0);
  const int tid = threadIdx.x;

  // Stage the batch tile; rows past the batch are zero and never written.
  for (int i = tid; i < BT * C; i += kVertsPerBlock) {
    coef_s[i] = (i / C) < nb ? coeffs[(size_t)b0 * C + i] : 0.f;
  }
  for (int i = tid; i < BT * kJoints * kRows; i += kVertsPerBlock) {
    const int b = i / (kJoints * kRows);
    const int r = i - b * (kJoints * kRows);  // j * 12 + k
    const int j = r / kRows;
    const int k = r - j * kRows;
    a_s[(b * kRows + k) * kJoints + j] =
        b < nb ? rel_tf[(size_t)b0 * kJoints * kRows + i] : 0.f;
  }
  __syncthreads();

  const int v = blockIdx.x * kVertsPerBlock + tid;
  if (v >= V) return;

  float px[BT], py[BT], pz[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    px[b] = 0.f;
    py[b] = 0.f;
    pz[b] = 0.f;
  }

  const float* dx = dirs + v;
  const float* dy = dx + (size_t)C * Vp;
  const float* dz = dy + (size_t)C * Vp;
#pragma unroll 4
  for (int m = 0; m < C; ++m) {
    const size_t off = (size_t)m * Vp;
    const float x = __ldg(dx + off);
    const float y = __ldg(dy + off);
    const float z = __ldg(dz + off);
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      const float c = coef_s[b * C + m];
      px[b] = fmaf(c, x, px[b]);
      py[b] = fmaf(c, y, py[b]);
      pz[b] = fmaf(c, z, pz[b]);
    }
  }

  // The posed sums go to this thread's column of shared memory, so the
  // skinning loop below runs over the batch tile without being unrolled:
  // fully unrolled (32 x 12 x 24 FMAs at BT = 32) the nvcc build took
  // 99 s instead of 6 s.
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    posed_s[(0 * BT + b) * kVertsPerBlock + tid] = px[b];
    posed_s[(1 * BT + b) * kVertsPerBlock + tid] = py[b];
    posed_s[(2 * BT + b) * kVertsPerBlock + tid] = pz[b];
  }

  float w[kJoints];
#pragma unroll
  for (int j = 0; j < kJoints; ++j) w[j] = __ldg(wt + (size_t)j * Vp + v);

#pragma unroll 1
  for (int b = 0; b < nb; ++b) {
    const float* a = a_s + b * kRows * kJoints;
    float t[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kJoints; ++j) s = fmaf(a[k * kJoints + j], w[j], s);
      t[k] = s;
    }
    const float x = posed_s[(0 * BT + b) * kVertsPerBlock + tid];
    const float y = posed_s[(1 * BT + b) * kVertsPerBlock + tid];
    const float z = posed_s[(2 * BT + b) * kVertsPerBlock + tid];
    float* o = out + ((size_t)(b0 + b) * V + v) * 3;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      o[i] = t[4 * i] * x + t[4 * i + 1] * y + t[4 * i + 2] * z + t[4 * i + 3];
    }
  }
}

template <int BT>
cudaError_t launch(const float* dirs, const float* wt, const float* coeffs,
                   const float* rel_tf, float* out, int B, int C, int V,
                   int Vp, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t)BT * (C + kJoints * kRows + 3 * kVertsPerBlock);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lbs_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((V + kVertsPerBlock - 1) / kVertsPerBlock,
                  (B + BT - 1) / BT);
  lbs_kernel<BT><<<grid, kVertsPerBlock, smem, stream>>>(
      dirs, wt, coeffs, rel_tf, out, B, C, V, Vp);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Allocates nothing
// and does not synchronize; the caller owns every buffer.
extern "C" int spec_lbs_forward(const void* dirs, const void* wt,
                                const void* coeffs, const void* rel_tf,
                                void* out, int B, int C, int V, int Vp,
                                void* stream) {
  if (B <= 0 || V <= 0) return 0;
  const float* d = static_cast<const float*>(dirs);
  const float* w = static_cast<const float*>(wt);
  const float* c = static_cast<const float*>(coeffs);
  const float* a = static_cast<const float*>(rel_tf);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 1) return launch<1>(d, w, c, a, o, B, C, V, Vp, s);
  if (B == 2) return launch<2>(d, w, c, a, o, B, C, V, Vp, s);
  if (B <= 4) return launch<4>(d, w, c, a, o, B, C, V, Vp, s);
  if (B <= 8) return launch<8>(d, w, c, a, o, B, C, V, Vp, s);
  if (B <= 16) return launch<16>(d, w, c, a, o, B, C, V, Vp, s);
  return launch<32>(d, w, c, a, o, B, C, V, Vp, s);
}

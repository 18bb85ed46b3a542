// One ResNet identity bottleneck with folded BatchNorm, hand-written for
// Hopper (sm_90a). Plain C interface, loaded with ctypes by
// spec_tpu_torch/ops/bottleneck.py, which also holds the plain PyTorch
// twin and launches this kernel once per block of a chain.
//
// Replaces spec_tpu/ops/pallas/bottleneck.py:_chain_kernel (body
// _block_body; reached through fused_bottleneck_chain and
// fused_identity_bottleneck). It computes the same thing, not the same
// block layout. On NHWC x (B, H, W, C) in T (float or bf16):
//
//   h1 = relu(x . w1 + b1)                    rounded to T   w1 (C, M)
//   h2 = relu(sum_tap h1[+tap] . w2[tap] + b2) rounded to T  w2 (9, M, M)
//   y  = relu(h2 . w3 + b3 + x)               rounded to T   w3 (M, C)
//
// with the 3x3 zero-padding h1 (outside the image h1 is 0, not
// relu(b1)), fp32 biases and fp32 sums everywhere.
//
// Design. A thread block (256 threads) owns a TH x TW tile of output
// pixels of one image and keeps everything between x and y in shared
// memory:
//   1. h1 over the tile plus its one-pixel halo ((TH+2) x (TW+2) rows of
//      M), x and w1 streamed through shared memory in 16-channel chunks;
//      bias, ReLU, zero outside the image, rounded;
//   2. h2 over the tile: the 3x3 as a (9M)-deep product whose A rows are
//      gathered from h1 in shared memory (tap = 3 dy + dx), w2 streamed;
//   3. chunk by chunk of output channels, h2 . w3 + b3 + x (x re-read
//      from device memory), ReLU, stored.
// Each phase is the same block-level product (block_gemm): every thread
// holds a 4 pixel x 4 channel tile of fp32 sums in registers, reads A
// rows from shared memory (row stride an odd number of 32-bit words, so
// no bank conflicts) and B from a 16-row chunk staged in shared memory.
// The split of the 256 threads between pixels and channels is chosen
// per phase to waste the fewest lanes at that phase's sizes. The host
// picks the largest tile (8x8 down to 1x1) whose h1 + h2 + staging fit
// in the 227 KB of shared memory: 8x8 up to M = 256 in fp32, 4x8 at
// M = 512 (ResNet-50 layer4) in fp32, 8x8 everywhere in bf16.
//
// Precision: CUDA-core fp32 FMAs for both element types; the float
// variant is exact fp32 (no TF32), the bf16 variant rounds exactly where
// the Pallas body does (h1, h2, y).
//
// What bounds it on an H100, and the cost of this design. One bottleneck
// at ResNet-50's stage shapes is ~48 GFLOP at B = 16 frames of 512x672
// (2 x pixels x 17 M^2), so the kernel is compute-bound: on the CUDA
// cores (67 TFLOP/s fp32 peak) it cannot come near cuDNN on the tensor
// cores, and its inner loop does two shared-memory loads per 4 FMAs,
// which caps it near half the FMA rate. The halo recomputes h1 on
// (TH+2)(TW+2)/(TH TW) of the pixels (1.56x at 8x8, 1.88x at 4x8). One
// launch per block means the intermediate between two blocks of a chain
// goes through device memory (read 2x, written 1x per block), unlike the
// TPU chain that keeps K blocks' halo bands in VMEM: at layer4
// (C = 2048, M = 512) one block's tile already needs most of the shared
// memory. Later work: wgmma with TMA-fed tiles for the three products
// (tensor cores, bf16), then chain fusion at layer1 where M = 64 leaves
// room for several blocks' halos.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int TP = 4;            // pixels per thread tile
constexpr int TN = 4;            // channels per thread tile
constexpr int KC = 16;           // K-chunk staged in shared memory
constexpr int kMaxPT = 256;      // TP * PG with PG <= 64
constexpr int kMaxNT = 256;      // TN * CG with CG <= 64
constexpr size_t kSmemLimit = 232448;  // 227 KB usable per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Row stride (elements) of a shared-memory matrix with `cols` columns:
// padded so that it is an odd number of 32-bit words.
__host__ __device__ inline int padded_ld(int cols, int elem_bytes) {
  return cols + 4 / elem_bytes;
}

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~size_t(15);
}

// Shared-memory layout, identical on host and device.
struct Layout {
  int ldh, lda;
  size_t h1, h2, as, bs, total;  // byte offsets and total
};

__host__ __device__ inline Layout make_layout(int th, int tw, int M,
                                              int elem) {
  Layout L;
  L.ldh = padded_ld(M, elem);
  L.lda = padded_ld(KC, elem);
  const size_t np1 = size_t(th + 2) * (tw + 2), np2 = size_t(th) * tw;
  L.h1 = 0;
  L.h2 = align16(L.h1 + np1 * L.ldh * elem);
  L.as = align16(L.h2 + np2 * L.ldh * elem);
  L.bs = align16(L.as + size_t(kMaxPT) * L.lda * elem);
  L.total = align16(L.bs + size_t(KC) * kMaxNT * elem);
  return L;
}

// Thread split for a P x N product: CG threads along channels, PG along
// pixels (CG * PG = 256), the one that needs the fewest macro tiles;
// ties go to the wider channel split (coalesced stores).
__device__ __forceinline__ void choose_split(int P, int N, int& CG,
                                             int& PG) {
  int best = 1 << 30;
  for (int cg = 64; cg >= 4; cg >>= 1) {
    const int pg = kThreads / cg;
    const int tiles = ((P + TP * pg - 1) / (TP * pg)) *
                      ((N + TN * cg - 1) / (TN * cg));
    if (tiles < best) {
      best = tiles;
      CG = cg;
      PG = pg;
    }
  }
}

// out[p, n] = epi(p, n, sum_k A[p, k] * B[k, n]) for p < P, n < N.
//   row_ptr(p, p0, k0): pointer to A[p, k0 .. k0 + KC) in shared memory
//     (p0: the first row of the current macro tile);
//   stage_a(p0, PT, k0): fills a staging buffer read by row_ptr (or not);
//   B: (K, N) row-major in device memory, K a multiple of KC.
template <typename T, typename RowPtr, typename StageA, typename Epi>
__device__ __forceinline__ void block_gemm(int P, int N, int K,
                                           const T* __restrict__ B,
                                           T* __restrict__ Bs,
                                           RowPtr row_ptr, StageA stage_a,
                                           Epi epi) {
  int CG = 64, PG = 4;
  choose_split(P, N, CG, PG);
  const int NT = TN * CG, PT = TP * PG;
  const int cg = threadIdx.x % CG, pg = threadIdx.x / CG;
  for (int p0 = 0; p0 < P; p0 += PT) {
    for (int n0 = 0; n0 < N; n0 += NT) {
      float acc[TP][TN];
#pragma unroll
      for (int i = 0; i < TP; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < K; k0 += KC) {
        __syncthreads();  // the previous chunk's readers are done
        stage_a(p0, PT, k0);
        for (int e = threadIdx.x; e < KC * NT; e += kThreads) {
          const int kk = e / NT, nn = e - kk * NT, n = n0 + nn;
          Bs[e] = n < N ? B[size_t(k0 + kk) * N + n] : from_f<T>(0.f);
        }
        __syncthreads();
        const T* arow[TP];
#pragma unroll
        for (int i = 0; i < TP; ++i) {
          const int p = p0 + pg + PG * i;
          arow[i] = row_ptr(p < P ? p : p0, p0, k0);
        }
#pragma unroll 4
        for (int kk = 0; kk < KC; ++kk) {
          float a[TP], b[TN];
#pragma unroll
          for (int i = 0; i < TP; ++i) a[i] = to_f(arow[i][kk]);
#pragma unroll
          for (int j = 0; j < TN; ++j) b[j] = to_f(Bs[kk * NT + cg + CG * j]);
#pragma unroll
          for (int i = 0; i < TP; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < TP; ++i) {
        const int p = p0 + pg + PG * i;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int n = n0 + cg + CG * j;
          if (p < P && n < N) epi(p, n, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();  // the epilogue's shared-memory writes are visible
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bottleneck_kernel(const T* __restrict__ x,      // (B, H, W, C)
                  const T* __restrict__ w1,     // (C, M)
                  const float* __restrict__ b1, // (M,)
                  const T* __restrict__ w2,     // (9, M, M)
                  const float* __restrict__ b2, // (M,)
                  const T* __restrict__ w3,     // (M, C)
                  const float* __restrict__ b3, // (C,)
                  T* __restrict__ y,            // (B, H, W, C)
                  int H, int W, int C, int M, int th, int tw) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(th, tw, M, sizeof(T));
  T* h1s = reinterpret_cast<T*>(smem + L.h1);
  T* h2s = reinterpret_cast<T*>(smem + L.h2);
  T* As = reinterpret_cast<T*>(smem + L.as);
  T* Bs = reinterpret_cast<T*>(smem + L.bs);
  const int ldh = L.ldh, lda = L.lda;
  const int hw = tw + 2, np1 = (th + 2) * hw, np2 = th * tw;
  const int ty0 = blockIdx.y * th, tx0 = blockIdx.x * tw;
  const T* xb = x + size_t(blockIdx.z) * H * W * C;
  T* yb = y + size_t(blockIdx.z) * H * W * C;

  // Phase 1: h1 over the tile and its halo (row p = hy * hw + hx).
  block_gemm<T>(
      np1, M, C, w1, Bs,
      [&](int p, int p0, int) { return As + size_t(p - p0) * lda; },
      [&](int p0, int PT, int k0) {
        for (int e = threadIdx.x; e < PT * KC; e += kThreads) {
          const int r = e / KC, kk = e - r * KC, p = p0 + r;
          const int gy = ty0 - 1 + p / hw, gx = tx0 - 1 + p % hw;
          T v = from_f<T>(0.f);
          if (p < np1 && gy >= 0 && gy < H && gx >= 0 && gx < W)
            v = xb[(size_t(gy) * W + gx) * C + k0 + kk];
          As[size_t(r) * lda + kk] = v;
        }
      },
      [&](int p, int n, float acc) {
        const int gy = ty0 - 1 + p / hw, gx = tx0 - 1 + p % hw;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
        h1s[size_t(p) * ldh + n] =
            from_f<T>(inside ? fmaxf(acc + b1[n], 0.f) : 0.f);
      });

  // Phase 2: the 3x3 over h1 (k = tap * M + m, tap = 3 dy + dx).
  block_gemm<T>(
      np2, M, 9 * M, w2, Bs,
      [&](int q, int, int k0) {
        const int tap = k0 / M, m0 = k0 - tap * M;
        const int dy = tap / 3, dx = tap - 3 * dy;
        const int row = (q / tw + dy) * hw + q % tw + dx;
        return h1s + size_t(row) * ldh + m0;
      },
      [](int, int, int) {},
      [&](int q, int n, float acc) {
        h2s[size_t(q) * ldh + n] = from_f<T>(fmaxf(acc + b2[n], 0.f));
      });

  // Phase 3: y = relu(h2 . w3 + b3 + x) on the pixels inside the image.
  block_gemm<T>(
      np2, C, M, w3, Bs,
      [&](int q, int, int k0) { return h2s + size_t(q) * ldh + k0; },
      [](int, int, int) {},
      [&](int q, int n, float acc) {
        const int gy = ty0 + q / tw, gx = tx0 + q % tw;
        if (gy < H && gx < W) {
          const size_t o = (size_t(gy) * W + gx) * C + n;
          yb[o] = from_f<T>(fmaxf(acc + b3[n] + to_f(xb[o]), 0.f));
        }
      });
}

// The largest output tile whose shared memory fits in one block.
void pick_tile(int M, int elem, int* th, int* tw, size_t* bytes) {
  static const int kTiles[][2] = {{8, 8}, {4, 8}, {4, 4}, {2, 4},
                                  {2, 2}, {1, 2}, {1, 1}};
  for (const auto& t : kTiles) {
    const Layout L = make_layout(t[0], t[1], M, elem);
    if (L.total <= kSmemLimit) {
      *th = t[0];
      *tw = t[1];
      *bytes = L.total;
      return;
    }
  }
  *th = *tw = 0;
  *bytes = 0;
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* w3, const void* b3, void* y, int B,
           int H, int W, int C, int M, cudaStream_t stream) {
  int th, tw;
  size_t bytes;
  pick_tile(M, sizeof(T), &th, &tw, &bytes);
  if (th == 0) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return int(err);
  dim3 grid((W + tw - 1) / tw, (H + th - 1) / th, B);
  bottleneck_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<const T*>(w3),
      static_cast<const float*>(b3), static_cast<T*>(y), H, W, C, M, th,
      tw);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int spec_bottleneck_forward(int dtype, const void* x, const void* w1,
                            const void* b1, const void* w2, const void* b2,
                            const void* w3, const void* b3, void* y, int B,
                            int H, int W, int C, int M, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C % KC || M % KC || B > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w1, b1, w2, b2, w3, b3, y, B, H, W, C, M, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, y, B, H, W, C,
                                 M, s);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"

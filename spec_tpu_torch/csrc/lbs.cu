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
// Precision: exact fp32 FMAs on the CUDA cores; no tensor cores, no TF32
// and no narrower dirs (the vertex budget is 1e-5 m against fp32).
//
// What bounds it on an H100. dirs is 3 x 218 x Vp floats, of which the
// V = 6890 vertices' columns are 18.0 MB (the 216 tiles of 32 read 18.1
// MB; the padding up to Vp = 7168 is never read); weights, coefficients
// and transforms add under 1 MB and the output B x V x 12 bytes. At
// B <= 8 the kernel is bound by reading dirs
// (~5.4 us at 3.35 TB/s). The FMAs grow with B: 218 x 3 + 24 x 12 + 12 per
// (row, vertex), 0.42 GFLOP at B = 32, ~6 us at 67 TFLOP/s, so near B = 32
// bytes and FMAs balance, and above it the FMAs bound it.
//
// Design.
// - Bytes in flight. A block owns a tile of 32 vertices: one 128-byte
//   segment of every one of the 3 x 218 dirs rows (84 KB), copied into
//   shared memory by 16-byte cp.async in 8 row chunks of one commit group
//   each. Four chunks (~42 KB a block, ~84 KB an SM) are in flight ahead
//   of the products: the products on chunk k start once it has landed,
//   and then chunk k + 4 is put in flight. The tile is stored (m, c, 32),
//   so a row's x, y and z segments sit at fixed offsets.
// - Fill the card. V = 6890 gives 216 blocks of 8 warps; at ~111 KB of
//   shared memory two blocks fit on an SM, so all 216 are resident at
//   once on the 132 SMs (16 warps per SM).
// - dirs crosses device memory once per call at every B: the block walks
//   the batch in passes of BT <= 16 rows over the staged tile.
// - The reduction over the 218 rows. Lanes own vertices; each warp owns
//   BPW <= 4 batch rows (register sums, 3 x BPW) and one of G row groups
//   (rows m0 + g, m0 + g + G, ... of every chunk). Few batch rows: G = 8
//   groups split the rows; many: G = 2 and the 8 warps split the batch
//   rows. A pass's coefficients arrive by 4-byte cp.async, transposed, in
//   shared memory (one 16-byte broadcast gives a warp its 4 rows'
//   coefficients for a dirs row). Partial sums meet in shared memory and
//   are added in a fixed group order: no atomics, so two launches agree
//   bit for bit.
// - Skinning is spread over threads, one (batch row, vertex) each: the
//   vertex's 24 weights in registers, the batch row's transforms in the
//   warp's shared-memory buffer, fetched by cp.async with the pass's
//   coefficients (the warp's first row) or while the previous row's
//   output is stored (its later rows).
// - Output is coalesced: a warp's 32 vertices of one batch row are 96
//   consecutive words of (B, V, 3); they pass through shared memory so
//   that consecutive lanes store consecutive words (4-byte stores: a
//   row's offset b x V x 12 bytes is not 16-byte aligned for odd b).
// - The shared-memory limit is raised once per device and process.
//
// What holds it back on an H100 (measured: PERF.md). At B <= 8 the
// copies take most of the time, at about half the HBM rate. Each pass of
// 16 batch rows then costs two to three times its FMA time: every FMA pair waits on
// shared-memory loads of broadcast operands (coefficients in the sums,
// transforms in the skinning), and each pass restarts with a wait for its
// coefficients and three barriers. Larger register tiles (several
// vertices per thread) would cut the shared-memory traffic per FMA but
// need larger partial-sum buffers than two blocks per SM leave room for.

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kJoints = 24;
constexpr int kRows = 12;       // row-major 3x4 transform
constexpr int kVT = 32;         // vertices per block (one lane each)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunks = 8;      // dirs row chunks, one cp.async group each
constexpr int kAhead = 4;       // chunks in flight ahead of the products
constexpr int kMaxDevices = 64;

// How a pass of BT batch rows is split over the 8 warps.
template <int BT>
struct Plan {
  static constexpr int kBPW = BT < 4 ? BT : 4;  // batch rows per warp
  static constexpr int kH = BT / kBPW;          // batch groups
  static constexpr int kG = kWarps / kH;        // row groups
  // Row stride of the transposed coefficients: a multiple of 4 keeps the
  // 16-byte broadcasts aligned; + 4 spreads the staging copies over banks.
  static constexpr int kCS = BT % 4 == 0 ? BT + 4 : BT;
};

constexpr int kTf = kJoints * kRows;  // floats of one batch row's transforms

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// Floats of shared memory: the dirs tile (C, 3, 32); a region that holds
// the pass's coefficients (C, CS) and then its partial sums (G, 3, BT,
// 32); per warp, one batch row's transforms (288) and its output (96).
template <int BT>
__host__ __device__ constexpr int union_floats(int C) {
  using P = Plan<BT>;
  return round4(C * P::kCS > P::kG * 3 * BT * kVT ? C * P::kCS
                                                  : P::kG * 3 * BT * kVT);
}

template <int BT>
size_t smem_bytes(int C) {
  return sizeof(float) * ((size_t)3 * C * kVT + union_floats<BT>(C) +
                          kWarps * (kTf + 3 * kVT));
}

__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16- and 4-byte asynchronous copies to shared memory; src-size 0 fills
// the destination with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most `pending` of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    default: cp_async_wait<8>(); break;
  }
}
static_assert(kChunks == 8, "cp_async_wait_pending covers 8 + 1 groups");

// One batch row's transforms (72 16-byte pieces) into a warp's buffer.
__device__ __forceinline__ void fetch_transforms(float* a_s, const float* a,
                                                 int lane) {
  for (int i = lane; i < kTf / 4; i += 32) cp_async16(a_s + 4 * i, a + 4 * i,
                                                      true);
}

template <int N>
__device__ __forceinline__ void load_coefs(const float* p, float (&c)[N]) {
  if constexpr (N == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    c[0] = q.x;
    c[1] = q.y;
    c[2] = q.z;
    c[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) c[i] = p[i];
  }
}

template <int BT>
__global__ void __launch_bounds__(kThreads, 2)
lbs_kernel(const float* __restrict__ dirs,    // (3, C, Vp)
           const float* __restrict__ wt,      // (24, Vp)
           const float* __restrict__ coeffs,  // (B, C)
           const float* __restrict__ rel_tf,  // (B, 24, 3, 4)
           float* __restrict__ out,           // (B, V, 3)
           int B, int C, int V, int Vp) {
  using P = Plan<BT>;
  extern __shared__ __align__(16) float smem[];
  float* dirs_s = smem;                           // (C, 3, 32)
  float* u_s = dirs_s + 3 * C * kVT;              // coefT, then sums
  float* a_s = u_s + union_floats<BT>(C);         // (8, 288)
  float* stage_s = a_s + kWarps * kTf;            // (8, 96)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = warp % P::kG;
  const int h = warp / P::kG;
  const int v0 = blockIdx.x * kVT;
  const int v = v0 + lane;
  const int chunk_rows = (C + kChunks - 1) / kChunks;
  float* my_a = a_s + warp * kTf;
  float* my_out = stage_s + warp * 3 * kVT;

  // Row chunk k of the dirs tile, in the tile's (m, c, 32) layout: 3 x
  // rows x 8 pieces of 16 bytes, one copy group.
  auto issue_chunk = [&](int k) {
    const int m0 = k * chunk_rows;
    const int n = 3 * max(0, min(C, m0 + chunk_rows) - m0) * 8;
    for (int i = tid; i < n; i += kThreads) {
      const int q = i & 7;
      const int r = i >> 3;
      const int m = m0 + r / 3;
      const int c = r - (r / 3) * 3;
      const int col = v0 + 4 * q;
      const bool valid = col < Vp;
      cp_async16(dirs_s + (m * 3 + c) * kVT + 4 * q,
                 valid ? dirs + ((size_t)c * C + m) * Vp + col : dirs, valid);
    }
    cp_async_commit();
  };

  float w[kJoints];
#pragma unroll
  for (int j = 0; j < kJoints; ++j) {
    w[j] = v < Vp ? __ldg(wt + (size_t)j * Vp + v) : 0.f;
  }

  for (int b0 = 0; b0 < B; b0 += BT) {
    const int nb = min(BT, B - b0);

    // 1. One copy group: the pass's coefficients, transposed (coefT[m *
    //    CS + b], zeros past the batch), and each warp's first batch
    //    row of transforms.
    for (int m = tid; m < C; m += kThreads) {
#pragma unroll 4
      for (int b = 0; b < BT; ++b) {
        cp_async4(u_s + m * P::kCS + b,
                  coeffs + (size_t)(b0 + min(b, nb - 1)) * C + m, b < nb);
      }
    }
    if (warp < nb) {
      fetch_transforms(my_a, rel_tf + (size_t)(b0 + warp) * kTf, lane);
    }
    cp_async_commit();

    // 2. First pass: the first kAhead row chunks of the dirs tile in
    //    flight behind it, one group each.
    if (b0 == 0) {
      for (int k = 0; k < kAhead; ++k) issue_chunk(k);
    }
    cp_async_wait_pending(b0 == 0 ? kAhead : 0);
    __syncthreads();

    // 3. Posed sums of this warp's rows and batch rows, chunk by chunk.
    //    The first pass waits for each chunk and then puts the chunk
    //    kAhead further on in flight.
    float acc[3][P::kBPW];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int i = 0; i < P::kBPW; ++i) acc[c][i] = 0.f;
    }
    const float* cf = u_s + h * P::kBPW;
    for (int k = 0; k < kChunks; ++k) {
      if (b0 == 0) {
        cp_async_wait_pending(min(kAhead - 1, kChunks - 1 - k));
        __syncthreads();
        if (k + kAhead < kChunks) issue_chunk(k + kAhead);
      }
      const int m1 = min(C, (k + 1) * chunk_rows);
#pragma unroll 2
      for (int m = k * chunk_rows + g; m < m1; m += P::kG) {
        const float* d = dirs_s + m * 3 * kVT + lane;
        const float x = d[0];
        const float y = d[kVT];
        const float z = d[2 * kVT];
        float cm[P::kBPW];
        load_coefs(cf + m * P::kCS, cm);
#pragma unroll
        for (int i = 0; i < P::kBPW; ++i) {
          acc[0][i] = fmaf(cm[i], x, acc[0][i]);
          acc[1][i] = fmaf(cm[i], y, acc[1][i]);
          acc[2][i] = fmaf(cm[i], z, acc[2][i]);
        }
      }
    }
    __syncthreads();  // every warp is done with coefT

    // 4. Partial sums to shared memory: red[((g * 3 + c) * BT + b) * 32].
    float* red = u_s;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int i = 0; i < P::kBPW; ++i) {
        red[((g * 3 + c) * BT + h * P::kBPW + i) * kVT + lane] = acc[c][i];
      }
    }
    __syncthreads();

    // 5. Skinning, one (batch row, vertex) per thread; output staged per
    //    warp and stored as consecutive words.
    const int n_words = min(kVT, V - v0) * 3;
    for (int b = warp; b < nb; b += kWarps) {
      // The first row's transforms came with step 1, later ones were
      // fetched while the previous row's output was stored.
      if (b != warp) cp_async_wait<0>();
      __syncwarp();
      float p[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float s = red[(c * BT + b) * kVT + lane];
#pragma unroll
        for (int gg = 1; gg < P::kG; ++gg) {
          s += red[((gg * 3 + c) * BT + b) * kVT + lane];
        }
        p[c] = s;
      }
      const float4* a = reinterpret_cast<const float4*>(my_a);
      float t[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) t[k] = 0.f;
#pragma unroll
      for (int j = 0; j < kJoints; ++j) {
        const float4 r0 = a[3 * j];
        const float4 r1 = a[3 * j + 1];
        const float4 r2 = a[3 * j + 2];
        t[0] = fmaf(w[j], r0.x, t[0]);
        t[1] = fmaf(w[j], r0.y, t[1]);
        t[2] = fmaf(w[j], r0.z, t[2]);
        t[3] = fmaf(w[j], r0.w, t[3]);
        t[4] = fmaf(w[j], r1.x, t[4]);
        t[5] = fmaf(w[j], r1.y, t[5]);
        t[6] = fmaf(w[j], r1.z, t[6]);
        t[7] = fmaf(w[j], r1.w, t[7]);
        t[8] = fmaf(w[j], r2.x, t[8]);
        t[9] = fmaf(w[j], r2.y, t[9]);
        t[10] = fmaf(w[j], r2.z, t[10]);
        t[11] = fmaf(w[j], r2.w, t[11]);
      }
      __syncwarp();  // every lane has read my_a: fetch the next row's
      if (b + kWarps < nb) {
        fetch_transforms(my_a, rel_tf + (size_t)(b0 + b + kWarps) * kTf,
                         lane);
        cp_async_commit();
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        my_out[lane * 3 + i] = t[4 * i] * p[0] + t[4 * i + 1] * p[1] +
                               t[4 * i + 2] * p[2] + t[4 * i + 3];
      }
      __syncwarp();
      float* o = out + ((size_t)(b0 + b) * V + v0) * 3;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int idx = k * kVT + lane;
        if (idx < n_words) o[idx] = my_out[idx];
      }
    }
    __syncthreads();  // sums and buffers are read; the next pass refills
  }
}

// Lift the kernel's dynamic shared-memory limit to the device's opt-in
// maximum, once per device and process (a launch takes what it needs).
template <int BT>
cudaError_t allow_smem() {
  static std::mutex mu;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (done[dev]) return cudaSuccess;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(lbs_kernel<BT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e == cudaSuccess) done[dev] = true;
  return e;
}

template <int BT>
cudaError_t launch(const float* dirs, const float* wt, const float* coeffs,
                   const float* rel_tf, float* out, int B, int C, int V,
                   int Vp, cudaStream_t stream) {
  const cudaError_t e = allow_smem<BT>();
  if (e != cudaSuccess) return e;
  lbs_kernel<BT><<<(V + kVT - 1) / kVT, kThreads, smem_bytes<BT>(C),
                   stream>>>(dirs, wt, coeffs, rel_tf, out, B, C, V, Vp);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Allocates nothing
// and does not synchronize; the caller owns every buffer. dirs and rel_tf
// must be 16-byte aligned and Vp a multiple of 4 (16-byte copies).
extern "C" int spec_lbs_forward(const void* dirs, const void* wt,
                                const void* coeffs, const void* rel_tf,
                                void* out, int B, int C, int V, int Vp,
                                void* stream) {
  if (B <= 0 || V <= 0) return 0;
  if (C <= 0 || Vp < V || Vp % 4 != 0 || !aligned16(dirs) ||
      !aligned16(rel_tf)) {
    return int(cudaErrorInvalidValue);
  }
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
  return launch<16>(d, w, c, a, o, B, C, V, Vp, s);
}

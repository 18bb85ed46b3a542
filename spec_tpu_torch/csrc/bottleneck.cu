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
// One kernel template for both types (bottleneck_tc_kernel<T, kWide>,
// behind one C entry, spec_bottleneck_forward, with a dtype switch), one
// launch per block of a chain. A thread block (256 threads, 8 warps) owns
// a TH x TW tile of output pixels of one image and keeps everything
// between x and y in shared memory:
//   1. h1 over the tile plus its one-pixel halo ((TH+2) x (TW+2) rows of
//      M), x and w1 streamed through shared memory in K chunks; bias,
//      ReLU, zero outside the image, rounded;
//   2. h2 over the tile: the 3x3 as a (9M)-deep product whose A rows are
//      gathered from h1 in shared memory (tap = 3 dy + dx; no im2col
//      buffer), w2 streamed;
//   3. chunk by chunk of output channels, h2 . w3 + b3 + x (x re-read
//      from device memory), ReLU, stored.
//
// What bounds it on an H100. One bottleneck at ResNet-50's stage shapes
// is 47.92 GFLOP at B = 16 frames of 512x672 (2 x pixels x 17 M^2):
// 48.5 us on the tensor cores in bf16 (989 TFLOP/s dense). x read once
// and y written once are 352 / 176 / 88 / 44 MB at layer1..4 in bf16
// (twice that in fp32): 105 / 53 / 26 / 13 us at 3.35 TB/s. In fp32 the
// three products run as 3xTF32 (below), three TF32 products for each
// fp32 one: 3 x 47.92 GFLOP at 494.7 TFLOP/s (dense TF32) is 0.291 ms,
// more than the bytes at every stage (at most 0.210 ms, layer1).
//
// The three products run on the tensor cores with mma.sync: bf16 x bf16
// -> fp32 in m16n8k16 tiles, and for fp32 operands 3xTF32 in m16n8k8
// tiles. 3xTF32: each fp32 operand v splits into hi = tf32(v) (rounded
// to nearest, as cvt.rna.tf32.f32 rounds: the 13 low mantissa bits
// zero) and lo = tf32(v - hi) (the difference is exact in fp32), so
// |v - hi - lo| <= 2^-22 |v|; the product a b is taken as a_lo b_hi +
// a_hi b_lo + a_hi b_hi, each term exact in the tensor core and summed
// in fp32; the dropped a_lo b_lo is under 2^-22 |a b|. So each product
// is within about 2^-21 of a b, the order of fp32's own rounding of the
// sums, and the kernel keeps the fp32 budget, where a single TF32 pass
// (a_hi b_hi alone) errs by up to 2^-11 per operand. The tensor cores
// round their fp32 sums toward zero, though, which over a K of thousands
// drifts one way: each K chunk's products go into partial sums that are
// added to the running ones on the CUDA cores, rounded to nearest.
// tests/test_torch_cuda_bottleneck.py holds the result to the chain in
// float64 within a bound that one TF32 pass exceeds. bf16 is the Pallas
// body's arithmetic (bf16 operands, exact products, fp32 sums). In both
// only the order of the sums differs from the plain version, and it is
// fixed (no atomics), so two launches agree bit for bit.
//
// Shared memory is counted in bytes the same way for both types: a
// staged K chunk is 64 bytes of a row (32 bf16 or 16 fp32 values), one
// mma step 32 bytes of K (k16 bf16, k8 tf32), so the fp32 kernel stages
// the same bytes per chunk and holds h1 and h2 at twice the bf16 size.
// The 8 warps of a block form a warp grid picked per phase from the
// compiled ones (pick_plan); each warp owns up to 4 x 4 m16n8 tiles of a
// pass. A fragments come through ldmatrix.x4 from per-lane row addresses
// computed once per pass (phase 1: the staged x rows; phase 2: the h1
// row of the lane's pixel, shifted per k step by the tap's offset, found
// with a multiply-high instead of a division; phase 3: the h2 rows); an
// 8-row x 16-byte matrix is 8 x 8 bf16 or 8 x 4 fp32, so the same
// ldmatrix.x4 gives the m16n8k16 bf16 and the m16n8k8 tf32 A fragment.
// Weights (K, N) row-major are staged one chunk at a time with 16-byte
// cp.async through a ring of 2-4 buffers, one barrier per chunk; the
// passes of a phase run as one sequence, and each chunk's copies are
// issued while the tensor cores work on an earlier chunk. bf16 weights
// are read with ldmatrix.x4.trans; fp32 ones with 32-bit loads (ldmatrix
// transposes 16-bit elements only), at a row stride of 8 mod 32 words,
// so the lanes' (k = lane % 4, n = lane / 4) fall in 32 distinct banks.
// The fp32 kernel splits each A and B fragment once after loading it,
// with integer adds in place of cvt.rna (split_tf32), and issues the
// three products of all its tiles as three rounds, so no mma waits on
// the one before. Phase 1's x rows are staged beside the weights
// (zero-filled outside the image). Every other row stride in shared
// memory is cols + 16 bytes: 16-byte aligned for cp.async and ldmatrix,
// and an odd number of 16-byte units, so the 8 rows an ldmatrix phase
// reads fall in distinct banks. The inner loop has no division and no
// branch per product: rows past a pass or an operand read a valid row
// and the epilogue drops them. The epilogues work on the accumulator
// layout (rows lane/4 and +8, columns 2 (lane%4) and +1): each row's
// output offset once per pass, the biases once, each m16 tile's
// residuals loaded together before its pair stores.
//
// Two instantiations per type: above M = 64 the wide kernel, with warp
// tiles up to 64 x 32 and up to 255 registers a thread (one block per
// SM; the bf16 one capped at 128 spilled ~5.6 KB a thread and ran
// 1.5-2.6x slower); at and below, the narrow kernel with the small warp
// grids only (two blocks per SM), 1.4x faster at M = 64 than the wide one
// in bf16. The host picks the tile by a cost model (pick_tc_tile) and the
// deepest ring that keeps the blocks per SM. In fp32, h1 and h2 leave
// room at M = 512 for 4x8 tiles and a ring of 2 only, which re-stream
// the weights for every 32 pixels. On an H100 (PERF.md) the bf16 kernel
// runs 95-121 TFLOP/s at ResNet-50's stage shapes: ldmatrix latency with
// 8 warps an SM, cp.async issue and the weights re-streamed for every
// small pixel tile hold it there. The fp32 one runs 21-33 TFLOP/s of
// fp32 work (three TF32 products each, with the splits and partial sums
// beside them), and at M = 512 its 4x8 tiles wait on the weights'
// copies. Left for later: wgmma with B through TMA (mma.sync alone reaches
// only about two thirds of the card's tensor-core rate), a persistent
// grid, 16-byte y stores, and chain fusion at layer1.
//
// One launch per block means the intermediate between two blocks of a
// chain goes through device memory (read 2x, written 1x per block),
// unlike the TPU chain that keeps K blocks' halo bands in VMEM: at
// layer4 (C = 2048, M = 512) one block's tile already needs most of the
// shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kQuantum = 16;     // C and M are multiples of it
constexpr size_t kSmemLimit = 232448;  // 227 KB usable per block
constexpr int kNoRow = -2147483647 - 1;  // an epilogue row to drop
constexpr int kMaxRows = 128;    // rows of one pass (phase-1 x staging)
constexpr int kMaxCols = 256;    // columns of one pass (weight staging)

// Element geometry: a staged K chunk is 64 bytes of a row, one mma step
// 32 bytes of K, one cp.async or ldmatrix row segment 16 bytes.
template <typename T>
struct Elem {
  static constexpr int kBytes = sizeof(T);
  static constexpr int kChunk = 64 / kBytes;  // K rows of a staged chunk
  static constexpr int kStep = 32 / kBytes;   // K of one mma
  static constexpr int kVec = 16 / kBytes;    // values in 16 bytes
};

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~size_t(15);
}

// Row stride (elements) of an A operand in shared memory with `cols`
// columns (a multiple of 16): cols + 16 bytes, 16-byte aligned, and an
// odd number of 16-byte units, so ldmatrix's 8 rows fall in distinct
// banks.
template <typename T>
__host__ __device__ inline int tc_ld(int cols) {
  return cols + Elem<T>::kVec;
}

// Row stride (elements) of a staged weight chunk with `cols` columns (a
// multiple of 16): bf16, an odd number of 16-byte units (ldmatrix.trans);
// fp32, 8 mod 32 words (the B fragment's 32-bit loads, in distinct
// banks).
__host__ __device__ inline int tc_ldb(int cols) { return cols + 8; }

__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }

// Shared-memory layout, identical on host and device: h1 and h2, then
// `stages` buffers of one chunk of weight rows of up to
// min(kMaxCols, max(M, C)) columns. Phase 1's x staging (`stages`
// buffers of `arows` rows) lies over h2, which phase 1 does not use yet.
struct TcLayout {
  int ldh, lda, ldb, arows;
  size_t h1, h2, bs, total;  // byte offsets and total
};

template <typename T>
__host__ __device__ inline TcLayout make_tc_layout(int th, int tw, int M,
                                                   int C, int stages) {
  TcLayout L;
  const int np1 = (th + 2) * (tw + 2), np2 = th * tw;
  const int wide = M > C ? M : C;
  L.ldh = tc_ld<T>(M);
  L.lda = tc_ld<T>(Elem<T>::kChunk);
  L.ldb = tc_ldb(wide < kMaxCols ? wide : kMaxCols);
  L.arows = round16(np1) < kMaxRows ? round16(np1) : kMaxRows;
  const size_t e = sizeof(T);
  const size_t h2 = size_t(np2) * L.ldh,
               as = size_t(stages) * L.arows * L.lda;
  L.h1 = 0;
  L.h2 = align16(size_t(np1) * L.ldh * e);
  L.bs = align16(L.h2 + (h2 > as ? h2 : as) * e);
  L.total = align16(L.bs + size_t(stages) * Elem<T>::kChunk * L.ldb * e);
  return L;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory to the shared-memory address dst,
// asynchronously; zeros when !valid (src is then not read).
__device__ __forceinline__ void cp_async16_addr(unsigned dst,
                                                const void* src,
                                                bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Wait until at most n (0..2) of this thread's groups are in flight.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n <= 0)
    cp_async_wait<0>();
  else if (n == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<2>();
}

// Four 8x8 b16 matrices from the shared-memory address `addr`; lane l
// gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) . b (16x8, col), bf16 operands, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x8, row) . b (8x8, col), tf32 operands, fp32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// fp32 bits v as hi + lo for 3xTF32, each TF32 rounded to nearest with
// ties away from zero as the tensor core reads it: half a TF32 step is
// added to the bits, and the mma ignores the 13 low ones. That is
// cvt.rna.tf32.f32 (bit for bit, as the mma sees it) without its checks
// for NaN and overflow, which cost it several instructions more.
__device__ __forceinline__ void split_tf32(uint32_t v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = v + 0x1000u;
  const float d = __uint_as_float(v) - __uint_as_float(hi & 0xffffe000u);
  lo = __float_as_uint(d) + 0x1000u;
}

// The A operands of the three products. Each gives, for a pass whose
// rows start at m0: row(r, m0, rows), the element offset of pass row r
// (rows past the pass's or the operand's end read a valid row, and the
// epilogue drops them); base(buf), the shared-memory address of the
// chunk in staging buffer buf; kofs(k, kk), the element offset of column
// k (kk = k - the chunk's first k); and, for an operand staged through
// shared memory, stage_pass and stage_chunk, which issue its copies.

// Phase 1: x at the tile + halo pixels (p = hy * hw + hx), zero outside
// the image and past np1. A pass's rows are staged 4 vectors of 16 bytes
// a row, two vectors per thread (rows <= kMaxRows).
template <typename T>
struct XRows {
  const T* xb;
  unsigned as;  // shared address of buffer 0
  int astride, lda, H, W, C, hw, np1, ty0, tx0;
  int goff[2], soff[2];  // this thread's vectors: x offset (-1: zero) and
                         // buffer offset (-1: past the pass's rows)

  __device__ void stage_pass(int m0, int rows) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int v = threadIdx.x + kThreads * j, r = v >> 2;
      const int c = (v & 3) * Elem<T>::kVec;
      const int p = m0 + r, gy = ty0 - 1 + p / hw, gx = tx0 - 1 + p % hw;
      soff[j] = r < rows ? r * lda + c : -1;
      goff[j] = r < rows && p < np1 && gy >= 0 && gy < H && gx >= 0 &&
                        gx < W
                    ? (gy * W + gx) * C + c
                    : -1;
    }
  }
  __device__ void stage_chunk(int k0, int kl, int buf) {
    const int c = (threadIdx.x & 3) * Elem<T>::kVec;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (soff[j] >= 0 && c < kl)
        cp_async16_addr(as + Elem<T>::kBytes * (buf * astride + soff[j]),
                        xb + (goff[j] >= 0 ? goff[j] + k0 : 0),
                        goff[j] >= 0);
  }
  __device__ int row(int r, int, int rows) const {
    return (r < rows ? r : rows - 1) * lda;
  }
  __device__ unsigned base(int buf) const {
    return as + Elem<T>::kBytes * buf * astride;
  }
  __device__ int kofs(int, int kk) const { return kk; }
};

// Phase 2: the im2col rows of h1, gathered: column k = tap * M + m of
// pixel q is h1 at (q / tw + dy, q % tw + dx), tap = 3 dy + dx.
struct H1Taps {
  unsigned h1;
  int ldh, hw, tw, np2, M;
  unsigned minv;  // ceil(2^32 / M): tap = umulhi(k, minv), k < 2^16

  __device__ void stage_pass(int, int) {}
  __device__ void stage_chunk(int, int, int) {}
  __device__ int row(int r, int m0, int) const {
    int q = m0 + r;
    q = q < np2 ? q : np2 - 1;
    return ((q / tw) * hw + q % tw) * ldh;
  }
  __device__ unsigned base(int) const { return h1; }
  __device__ int kofs(int k, int) const {
    const int tap = __umulhi(unsigned(k), minv);
    const int dy = (tap * 11) >> 5, dx = tap - 3 * dy;  // tap / 3, tap % 3
    return (dy * hw + dx) * ldh + k - tap * M;
  }
};

// Phase 3: the h2 rows.
struct H2Rows {
  unsigned h2;
  int ldh, np2;

  __device__ void stage_pass(int, int) {}
  __device__ void stage_chunk(int, int, int) {}
  __device__ int row(int r, int m0, int) const {
    const int q = m0 + r;
    return (q < np2 ? q : np2 - 1) * ldh;
  }
  __device__ unsigned base(int) const { return h2; }
  __device__ int kofs(int k, int) const { return k; }
};

// For p < P and even n < N, with s = sum_k A[p, k] * B[k, n] and s' the
// same at n + 1, r = epi.row(p): epi.put(r, n, s, s', epi.bias(n),
// epi.residual(r, n)), on the tensor cores (row: a handle for output
// row p, kNoRow to drop it; bias: the pair of biases at n, n + 1;
// residual: the pair of x values added before the ReLU, as loaded). B:
// (K, N) row-major T in device memory; K and N multiples of 16.
//
// The 8 warps form a WM x (8 / WM) grid; each owns MT m16 tiles by NP2
// column pairs (n16) of a pass of RP rows by NP columns, NP <= N. The
// passes and their K chunks run as one sequence of chunks through a ring
// of `stages` buffers, so the copies of the next pass's first chunks
// overlap this pass's last ones; one barrier per chunk.
template <typename T, int WM, int MT, int NP2, typename AOp, typename Epi>
__device__ __forceinline__ void tc_gemm(int P, int N, int K,
                                        const T* __restrict__ B, T* Bs,
                                        int ldb, int stages, AOp& A,
                                        Epi epi) {
  using E = Elem<T>;
  constexpr bool kTf32 = std::is_same<T, float>::value;
  constexpr int WN = 8 / WM, RP = WM * MT * 16, NP = WN * NP2 * 16;
  constexpr int KB = E::kChunk;
  constexpr int kBVec = (KB * NP / E::kVec + kThreads - 1) / kThreads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp / WN * MT * 16, c0 = warp % WN * NP2 * 16;
  const int lrow = lane % 16, lcol = (lane / 16) * E::kVec;
  const int rows_all = round16(P);
  const int npass = (N + NP - 1) / NP, nk = (K + KB - 1) / KB;
  const int total = (rows_all + RP - 1) / RP * npass * nk;
  const unsigned bs = smem_addr(Bs);
  const int bstride = KB * ldb;

  // Copies: the next chunk to stage is (s_pass, s_kc) into buffer s_buf;
  // this thread's weight vectors in that pass's chunks are (row, col)
  // pairs packed as row << 16 | col (row KB: none).
  int s_pass = -1, s_kc = nk - 1, s_buf = 0, s_n0 = 0;
  int bvec[kBVec];
  auto stage = [&](int g) {
    if (g < total) {
      if (++s_kc == nk) {
        s_kc = 0;
        ++s_pass;
        const int m0 = s_pass / npass * RP;
        s_n0 = s_pass % npass * NP;
        const int cols = N - s_n0 < NP ? N - s_n0 : NP;
        const int vpr = cols / E::kVec;
#pragma unroll
        for (int j = 0; j < kBVec; ++j) {
          const int v = threadIdx.x + kThreads * j, r = v / vpr;
          bvec[j] =
              r < KB ? (r << 16) | ((v - r * vpr) * E::kVec) : KB << 16;
        }
        A.stage_pass(m0, rows_all - m0 < RP ? rows_all - m0 : RP);
      }
      const int k0 = s_kc * KB, kl = K - k0 < KB ? K - k0 : KB;
      const T* src = B + size_t(k0) * N + s_n0;
#pragma unroll
      for (int j = 0; j < kBVec; ++j) {
        const int r = bvec[j] >> 16, c = bvec[j] & 0xffff;
        if (r < kl)
          cp_async16_addr(bs + E::kBytes * (s_buf * bstride + r * ldb + c),
                          src + size_t(r) * N + c, true);
      }
      A.stage_chunk(k0, kl, s_buf);
      s_buf = s_buf + 1 == stages ? 0 : s_buf + 1;
    }
    cp_async_commit();  // possibly empty: one group per chunk slot
  };

  float acc[MT][2 * NP2][4];
  unsigned aoff[MT];
  int pass = -1, kc = nk - 1, buf = 0, m0 = 0, n0 = 0;
  for (int s = 0; s < stages - 1; ++s) stage(s);
  for (int g = 0; g < total; ++g) {
    cp_async_wait_upto(stages - 2);  // chunk g has landed (this thread)
    __syncthreads();  // ... for all threads; chunk g - 1's readers done
    if (++kc == nk) {
      kc = 0;
      ++pass;
      m0 = pass / npass * RP;
      n0 = pass % npass * NP;
      const int rows = rows_all - m0 < RP ? rows_all - m0 : RP;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        aoff[i] = E::kBytes * (A.row(r0 + 16 * i + lrow, m0, rows) + lcol);
#pragma unroll
        for (int j = 0; j < 2 * NP2; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
      }
    }
    // Chunk g + stages - 1 into chunk g - 1's buffer (its readers are past
    // the barrier): fp32 issues the copies here, a chunk's products ahead
    // of their wait, which its 2-stage tiles at M = 512 need; bf16 below.
    if constexpr (kTf32) stage(g + stages - 1);
    const int k0 = kc * KB, kl = K - k0 < KB ? K - k0 : KB;
    const unsigned abase = A.base(buf);
    [[maybe_unused]] const unsigned bbase =
        bs + 2 * (buf * bstride + lrow * ldb + c0 + lcol);
    // fp32: this chunk's products, summed into acc at its end. The tensor
    // cores' sums round toward zero, which over a K of thousands drifts
    // one way past the float64 test's bound; partial sums of one chunk
    // keep that drift to the chunk's small sums and add them rounded to
    // nearest.
    [[maybe_unused]] float part[MT][2 * NP2][4];
    if constexpr (kTf32) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 2 * NP2; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) part[i][j][v] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < KB; ks += E::kStep) {
      if (ks < kl) {
        const unsigned ak = abase + E::kBytes * A.kofs(k0 + ks, ks);
        uint32_t a[MT][4], b[NP2][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) ldsm_x4(a[i], ak + aoff[i]);
        if constexpr (kTf32) {
          // B fragments of n8 tiles 2j and 2j + 1: k = lane % 4 and + 4,
          // n = lane / 4.
          const uint32_t* bp = reinterpret_cast<const uint32_t*>(Bs) +
                               buf * bstride + (ks + lane % 4) * ldb + c0 +
                               lane / 4;
#pragma unroll
          for (int j = 0; j < NP2; ++j) {
            b[j][0] = bp[16 * j];
            b[j][1] = bp[4 * ldb + 16 * j];
            b[j][2] = bp[16 * j + 8];
            b[j][3] = bp[4 * ldb + 16 * j + 8];
          }
          uint32_t ah[MT][4], al[MT][4], bh[NP2][4], bl[NP2][4];
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int v = 0; v < 4; ++v)
              split_tf32(a[i][v], ah[i][v], al[i][v]);
#pragma unroll
          for (int j = 0; j < NP2; ++j)
#pragma unroll
            for (int v = 0; v < 4; ++v)
              split_tf32(b[j][v], bh[j][v], bl[j][v]);
          // Small terms first, each round over all tiles.
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NP2; ++j) {
              mma_tf32(part[i][2 * j], al[i], bh[j][0], bh[j][1]);
              mma_tf32(part[i][2 * j + 1], al[i], bh[j][2], bh[j][3]);
            }
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NP2; ++j) {
              mma_tf32(part[i][2 * j], ah[i], bl[j][0], bl[j][1]);
              mma_tf32(part[i][2 * j + 1], ah[i], bl[j][2], bl[j][3]);
            }
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NP2; ++j) {
              mma_tf32(part[i][2 * j], ah[i], bh[j][0], bh[j][1]);
              mma_tf32(part[i][2 * j + 1], ah[i], bh[j][2], bh[j][3]);
            }
        } else {
#pragma unroll
          for (int j = 0; j < NP2; ++j)
            ldsm_x4_trans(b[j], bbase + 2 * ks * ldb + 32 * j);
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NP2; ++j) {
              mma_bf16(acc[i][2 * j], a[i], b[j][0], b[j][1]);
              mma_bf16(acc[i][2 * j + 1], a[i], b[j][2], b[j][3]);
            }
        }
      }
    }
    if constexpr (kTf32) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 2 * NP2; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[i][j][v] += part[i][j][v];
    }
    // bf16: chunk g + stages - 1, issued behind this chunk's products so
    // the copies overlap the tensor cores' work.
    if constexpr (!kTf32) stage(g + stages - 1);
    if (kc == nk - 1) {
      // Accumulator (i, jj): rows lane/4 and +8, columns 2 (lane%4), +1.
      // Per pass: each of this thread's 2 MT rows once (epi.row), the
      // biases once, then per m16 tile all residuals before any store,
      // so their loads overlap instead of waiting on each store.
      using Res = decltype(epi.residual(0, 0));
      int row[MT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = m0 + r0 + 16 * i + lane / 4 + 8 * h;
          row[i][h] = p < P ? epi.row(p) : kNoRow;
        }
      float2 bias[2 * NP2];
#pragma unroll
      for (int jj = 0; jj < 2 * NP2; ++jj) {
        const int n = n0 + c0 + 8 * jj + 2 * (lane % 4);
        bias[jj] = n < N ? epi.bias(n) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        Res res[2 * NP2][2];
#pragma unroll
        for (int jj = 0; jj < 2 * NP2; ++jj) {
          const int n = n0 + c0 + 8 * jj + 2 * (lane % 4);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            res[jj][h] = n < N && row[i][h] != kNoRow
                             ? epi.residual(row[i][h], n)
                             : Res{};
        }
#pragma unroll
        for (int jj = 0; jj < 2 * NP2; ++jj) {
          const int n = n0 + c0 + 8 * jj + 2 * (lane % 4);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (n < N && row[i][h] != kNoRow)
              epi.put(row[i][h], n, acc[i][jj][2 * h],
                      acc[i][jj][2 * h + 1], bias[jj], res[jj][h]);
        }
      }
    }
    buf = buf + 1 == stages ? 0 : buf + 1;
  }
  cp_async_wait<0>();  // the trailing empty groups
  __syncthreads();  // the epilogue's shared-memory writes are visible
}

// The plan for a P x N product with the fewest estimated cycles: passes
// x the per-SM cycles of one k step, the larger of the products (per
// warp 2 MT NP2 mma of one m16n8 tile pair: about one a cycle over 8
// warps for bf16 m16n8k16, three for the 3xTF32 m16n8k8) and the loads
// (8 (MT + NP2) ldmatrix.x4 or their 32-bit counterparts, 4 cycles each
// at 128 bytes a cycle). Plans wider than N are skipped. The plans are
// the warp grids tc_gemm is built for (tc_product): (WM, MT, NP2), a
// pass of 16 WM MT rows by 128 NP2 / WM columns. The first kWidePlans
// are built only into the wide kernel: their accumulators need more than
// the 128 registers a thread has at two blocks per SM. The last, 32-row
// passes 256 wide, only into the wide fp32 kernel: the 4x8 tiles its
// shared memory allows at M = 512 have 32 pixels.
constexpr int kNumPlans = 8, kWidePlans = 4, kFp32Plan = 7;

template <typename T, bool kWide>
__device__ __forceinline__ bool has_plan(int i) {
  if (i < kWidePlans) return kWide;
  return i != kFp32Plan || (kWide && std::is_same<T, float>::value);
}

template <typename T, bool kWide>
__device__ __forceinline__ int pick_plan(int P, int N) {
  constexpr long kMmaCycles = std::is_same<T, float>::value ? 48 : 16;
  const int plans[kNumPlans][3] = {{1, 4, 2}, {2, 4, 2}, {2, 3, 2},
                                   {1, 3, 2}, {4, 2, 2}, {8, 1, 2},
                                   {8, 1, 1}, {1, 2, 2}};
  int best = 6;  // 16 columns: fits every N
  long best_cost = -1;
#pragma unroll
  for (int i = 0; i < kNumPlans; ++i) {
    const int wm = plans[i][0], mt = plans[i][1], np2 = plans[i][2];
    const int rp = wm * mt * 16, np = (8 / wm) * np2 * 16;
    if (!has_plan<T, kWide>(i) || np > N) continue;
    const long passes =
        long((round16(P) + rp - 1) / rp) * ((N + np - 1) / np);
    const long mma = kMmaCycles * mt * np2, lds = 32L * (mt + np2);
    const long cost = passes * (mma > lds ? mma : lds);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = i;
    }
  }
  return best;
}

template <typename T, bool kWide, typename AOp, typename Epi>
__device__ __forceinline__ void tc_product(int P, int N, int K,
                                           const T* __restrict__ B, T* Bs,
                                           int ldb, int stages, AOp& A,
                                           Epi epi) {
  const int plan = pick_plan<T, kWide>(P, N);
  if constexpr (kWide) {
    switch (plan) {
      case 0: tc_gemm<T, 1, 4, 2>(P, N, K, B, Bs, ldb, stages, A, epi); return;
      case 1: tc_gemm<T, 2, 4, 2>(P, N, K, B, Bs, ldb, stages, A, epi); return;
      case 2: tc_gemm<T, 2, 3, 2>(P, N, K, B, Bs, ldb, stages, A, epi); return;
      case 3: tc_gemm<T, 1, 3, 2>(P, N, K, B, Bs, ldb, stages, A, epi); return;
      default: break;
    }
  }
  if constexpr (kWide && std::is_same<T, float>::value) {
    if (plan == kFp32Plan) {
      tc_gemm<T, 1, 2, 2>(P, N, K, B, Bs, ldb, stages, A, epi);
      return;
    }
  }
  switch (plan) {
    case 4: tc_gemm<T, 4, 2, 2>(P, N, K, B, Bs, ldb, stages, A, epi); break;
    case 5: tc_gemm<T, 8, 1, 2>(P, N, K, B, Bs, ldb, stages, A, epi); break;
    default: tc_gemm<T, 8, 1, 1>(P, N, K, B, Bs, ldb, stages, A, epi); break;
  }
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// A pair of x values as the residual loads them (bf16: the raw bits,
// converted only in put), and the pair as floats.
__device__ __forceinline__ uint32_t load_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_to_float2(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}
__device__ __forceinline__ float2 pair_to_float2(float2 x) { return x; }
template <typename T> struct PairOf { using type = float2; };
template <> struct PairOf<bf16> { using type = uint32_t; };
template <typename T> using Pair = typename PairOf<T>::type;

__device__ __forceinline__ float2 load_bias(const float* b, int n) {
  return *reinterpret_cast<const float2*>(b + n);
}

// Phase 1's epilogue: h1 = relu(s + b1), 0 outside the image, into
// shared memory. Row handle: the row's offset in h1, or -1 - offset for
// a pixel outside the image.
template <typename T>
struct H1Out {
  T* h1s;
  const float* b1;
  int ldh, hw, ty0, tx0, H, W;
  __device__ int row(int p) const {
    const int gy = ty0 - 1 + p / hw, gx = tx0 - 1 + p % hw;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    return in ? p * ldh : -1 - p * ldh;
  }
  __device__ float2 bias(int n) const { return load_bias(b1, n); }
  __device__ Pair<T> residual(int, int) const { return Pair<T>{}; }
  __device__ void put(int r, int n, float a0, float a1, float2 b,
                      Pair<T>) const {
    if (r >= 0)
      store2(h1s + r + n, fmaxf(a0 + b.x, 0.f), fmaxf(a1 + b.y, 0.f));
    else
      store2(h1s + (-1 - r) + n, 0.f, 0.f);
  }
};

// Phase 2's epilogue: h2 = relu(s + b2) into shared memory. Row handle:
// the row's offset in h2.
template <typename T>
struct H2Out {
  T* h2s;
  const float* b2;
  int ldh;
  __device__ int row(int q) const { return q * ldh; }
  __device__ float2 bias(int n) const { return load_bias(b2, n); }
  __device__ Pair<T> residual(int, int) const { return Pair<T>{}; }
  __device__ void put(int r, int n, float a0, float a1, float2 b,
                      Pair<T>) const {
    store2(h2s + r + n, fmaxf(a0 + b.x, 0.f), fmaxf(a1 + b.y, 0.f));
  }
};

// Phase 3's epilogue: y = relu(s + b3 + x) on the pixels inside the
// image, stored to device memory. Row handle: the pixel's offset in the
// image's x and y, kNoRow outside the image.
template <typename T>
struct YOut {
  const T* xb;
  T* yb;
  const float* b3;
  int tw, ty0, tx0, H, W, C;
  __device__ int row(int q) const {
    const int gy = ty0 + q / tw, gx = tx0 + q % tw;
    return gy < H && gx < W ? (gy * W + gx) * C : kNoRow;
  }
  __device__ float2 bias(int n) const { return load_bias(b3, n); }
  __device__ Pair<T> residual(int r, int n) const {
    return load_pair(xb + r + n);
  }
  __device__ void put(int r, int n, float a0, float a1, float2 b,
                      Pair<T> x) const {
    const float2 xf = pair_to_float2(x);
    store2(yb + r + n, fmaxf(a0 + b.x + xf.x, 0.f),
           fmaxf(a1 + b.y + xf.y, 0.f));
  }
};

// kWide: all warp grids, up to 255 registers a thread (one block per
// SM); else the small grids only, at 128 (two blocks per SM).
template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads, kWide ? 1 : 2)
bottleneck_tc_kernel(const T* __restrict__ x,        // (B, H, W, C)
                     const T* __restrict__ w1,       // (C, M)
                     const float* __restrict__ b1,   // (M,)
                     const T* __restrict__ w2,       // (9, M, M)
                     const float* __restrict__ b2,   // (M,)
                     const T* __restrict__ w3,       // (M, C)
                     const float* __restrict__ b3,   // (C,)
                     T* __restrict__ y,              // (B, H, W, C)
                     int H, int W, int C, int M, int th, int tw,
                     int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TcLayout L = make_tc_layout<T>(th, tw, M, C, stages);
  T* h1s = reinterpret_cast<T*>(smem + L.h1);
  T* h2s = reinterpret_cast<T*>(smem + L.h2);
  T* Bs = reinterpret_cast<T*>(smem + L.bs);
  const int ldh = L.ldh;
  const int hw = tw + 2, np1 = (th + 2) * hw, np2 = th * tw;
  const int ty0 = blockIdx.y * th, tx0 = blockIdx.x * tw;
  const T* xb = x + size_t(blockIdx.z) * H * W * C;
  T* yb = y + size_t(blockIdx.z) * H * W * C;

  // Phase 1: h1 over the tile and its halo; phase 1's x staging lies
  // over h2, which is not written before phase 2.
  XRows<T> xr{xb, smem_addr(h2s), L.arows * L.lda, L.lda, H, W, C, hw,
              np1, ty0, tx0, {0, 0}, {0, 0}};
  tc_product<T, kWide>(np1, M, C, w1, Bs, L.ldb, stages, xr,
                       H1Out<T>{h1s, b1, ldh, hw, ty0, tx0, H, W});

  // Phase 2: the 3x3 over h1 as a 9M-deep product.
  H1Taps taps{smem_addr(h1s), ldh, hw, tw, np2, M, 0xffffffffu / M + 1};
  tc_product<T, kWide>(np2, M, 9 * M, w2, Bs, L.ldb, stages, taps,
                       H2Out<T>{h2s, b2, ldh});

  // Phase 3: y = relu(h2 . w3 + b3 + x) on the pixels inside the image.
  H2Rows h2r{smem_addr(h2s), ldh, np2};
  tc_product<T, kWide>(np2, C, M, w3, Bs, L.ldb, stages, h2r,
                       YOut<T>{xb, yb, b3, tw, ty0, tx0, H, W, C});
}

// What bounds a kernel's blocks per SM on the current device.
struct TcOccupancy {
  int sms, smem_sm;
  long reg_cap;  // blocks per SM its registers allow
};

// The kernel for width M: the wide warp grids pay above M = 64 (timed
// at ResNet-50's stage shapes in bf16), the narrow kernel at and below.
bool tc_wide(int M) { return M > 64; }

template <typename T>
const void* tc_kernel(bool wide) {
  return wide ? reinterpret_cast<const void*>(bottleneck_tc_kernel<T, true>)
              : reinterpret_cast<const void*>(bottleneck_tc_kernel<T, false>);
}

template <typename T>
int tc_regs(bool wide) {
  auto regs = [](const void* fn) {
    cudaFuncAttributes a{};
    cudaFuncGetAttributes(&a, fn);
    return a.numRegs > 0 ? a.numRegs : 255;
  };
  static const int wide_regs = regs(tc_kernel<T>(true));
  static const int narrow_regs = regs(tc_kernel<T>(false));
  return wide ? wide_regs : narrow_regs;
}

template <typename T>
TcOccupancy tc_occupancy(bool wide) {
  const int regs = tc_regs<T>(wide);
  TcOccupancy o{132, 233472, 0};
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&o.smem_sm,
                         cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  o.reg_cap = 65536L / (kThreads * ((regs + 7) & ~7));
  return o;
}

long blocks_per_sm(const TcOccupancy& o, size_t bytes) {
  long n = o.smem_sm / long(bytes + 1024);  // 1 KB reserved per block
  n = n < o.reg_cap ? n : o.reg_cap;
  n = n < 2048 / kThreads ? n : 2048 / kThreads;
  return n > 1 ? n : 1;
}

// The deepest ring (4 down to 2 stages) for a tile that keeps as many
// blocks on an SM as 2 stages do; 0 when the tile does not fit.
template <typename T>
int pick_stages(const TcOccupancy& o, int th, int tw, int M, int C,
                size_t* bytes, long* per_sm) {
  const size_t two = make_tc_layout<T>(th, tw, M, C, 2).total;
  if (two > kSmemLimit) return 0;
  *per_sm = blocks_per_sm(o, two);
  for (int s = 4; s > 2; --s) {
    const size_t b = make_tc_layout<T>(th, tw, M, C, s).total;
    if (b <= kSmemLimit && blocks_per_sm(o, b) == *per_sm) {
      *bytes = b;
      return s;
    }
  }
  *bytes = two;
  return 2;
}

// The tile for one launch: of the candidates whose shared memory fits,
// the one with the least estimated time, i.e. waves of blocks (at the
// blocks per SM that its shared memory and registers allow) x blocks per
// SM x the cost of one block: its MACs, rows padded to 16, plus 8 per
// byte of weights it streams (every block streams all 2 C M + 9 M^2 of
// them, so small tiles pay for them more often). chip_smoke.py
// --k3-tiles times its picks beside every tile forced.
template <typename T>
void pick_tc_tile(int B, int H, int W, int C, int M, int* th, int* tw,
                  int* stages, size_t* bytes) {
  static const int kTiles[][2] = {{8, 16}, {16, 8}, {8, 8}, {8, 7},
                                  {7, 8},  {8, 6},  {6, 8}, {4, 8},
                                  {8, 4},  {4, 4},  {2, 4}, {2, 2},
                                  {1, 2},  {1, 1}};
  const TcOccupancy o = tc_occupancy<T>(tc_wide(M));
  double best = -1.0;
  *th = *tw = *stages = 0;
  *bytes = 0;
  for (const auto& t : kTiles) {
    size_t b;
    long per_sm;
    const int s = pick_stages<T>(o, t[0], t[1], M, C, &b, &per_sm);
    if (s == 0) continue;
    const long blocks = long(B) * ((H + t[0] - 1) / t[0]) *
                        ((W + t[1] - 1) / t[1]);
    const long waves = (blocks + o.sms * per_sm - 1) / (o.sms * per_sm);
    const double work =
        double(round16((t[0] + 2) * (t[1] + 2))) * C * M +
        double(round16(t[0] * t[1])) * (9.0 * M * M + double(M) * C) +
        8.0 * sizeof(T) * (2.0 * C * M + 9.0 * M * M);
    const double cost = double(waves) * per_sm * work;
    if (best < 0 || cost < best) {
      best = cost;
      *th = t[0];
      *tw = t[1];
      *stages = s;
      *bytes = b;
    }
  }
}

// th = tw = 0: the tile of pick_tc_tile; else that tile, if it fits.
template <typename T>
int launch_tc(const void* x, const void* w1, const void* b1, const void* w2,
              const void* b2, const void* w3, const void* b3, void* y,
              int B, int H, int W, int C, int M, int th, int tw,
              cudaStream_t stream) {
  if (size_t(H) * W * C > size_t(1) << 30)  // int offsets in one image
    return int(cudaErrorInvalidValue);
  size_t bytes;
  int stages;
  const bool wide = tc_wide(M);
  if (th > 0 && tw > 0) {
    long per_sm;
    stages = pick_stages<T>(tc_occupancy<T>(wide), th, tw, M, C, &bytes,
                            &per_sm);
  } else {
    pick_tc_tile<T>(B, H, W, C, M, &th, &tw, &stages, &bytes);
  }
  if (stages == 0) return int(cudaErrorInvalidValue);
  auto kernel =
      wide ? bottleneck_tc_kernel<T, true> : bottleneck_tc_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  dim3 grid((W + tw - 1) / tw, (H + th - 1) / th, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<const T*>(w3),
      static_cast<const float*>(b3), static_cast<T*>(y), H, W, C, M, th,
      tw, stages);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; th = tw = 0 picks the tile, else
// that tile. Returns a cudaError_t (0 = launched).
int spec_bottleneck_forward(int dtype, const void* x, const void* w1,
                            const void* b1, const void* w2, const void* b2,
                            const void* w3, const void* b3, void* y, int B,
                            int H, int W, int C, int M, int th, int tw,
                            void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C % kQuantum || M % kQuantum ||
      B > 65535 || th < 0 || tw < 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_tc<float>(x, w1, b1, w2, b2, w3, b3, y, B, H, W, C, M, th,
                            tw, s);
  if (dtype == 1)
    return launch_tc<bf16>(x, w1, b1, w2, b2, w3, b3, y, B, H, W, C, M, th,
                           tw, s);
  return int(cudaErrorInvalidValue);
}

// The tile and ring depth spec_bottleneck_forward picks for this dtype
// and shape on the current device (for reports). Returns a cudaError_t.
int spec_bottleneck_pick_tile(int dtype, int B, int H, int W, int C, int M,
                              int* th, int* tw, int* stages) {
  size_t bytes;
  if (dtype == 0)
    pick_tc_tile<float>(B, H, W, C, M, th, tw, stages, &bytes);
  else if (dtype == 1)
    pick_tc_tile<bf16>(B, H, W, C, M, th, tw, stages, &bytes);
  else
    return int(cudaErrorInvalidValue);
  return *th == 0 ? int(cudaErrorInvalidValue) : int(cudaGetLastError());
}

}  // extern "C"

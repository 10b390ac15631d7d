// Fused ETA-MLP forward for Hopper (sm_90a): (B, 12) ABI rows → (B,) point
// minutes or (B, n_q) non-crossing quantile minutes in one launch.
//
// Replaces the TPU kernel routest_tpu/ops/fused_mlp.py::fused_eta_forward
// (pl.pallas_call at :366, body _kernel :214-299). The Python side
// (routest_tpu_torch/ops/fused_mlp.py) packs the weights (every K and N
// zero-padded to a multiple of 16), checks shapes, caches the launch
// arguments and holds the plain PyTorch version this kernel is compared
// against.
//
// What bounds it on the H100. The shipped trunk (42→256→256→128→6) costs
// ~220 kFLOP per row against 60 bytes of row traffic, so on paper the
// tensor-core rate (989 TFLOP/s bf16) is the floor: ~0.9 µs for 4096 rows.
// At serving batches (8..4096 rows, at most one tile per SM) the real limit
// is one block's latency: its chain of slab copies, products, barriers and
// epilogues. Weight traffic is not: every block streams the whole packed
// trunk (~256 KB bf16, ~143 KB int8) from L2, where it stays resident, and
// 64-row tiles, which halve that traffic, measured slower at every serving
// batch (PERF.md). What the design does about it:
//   * bf16 and int8 run every layer's product on the tensor cores with
//     mma.sync.m16n8k16 (bf16 operands, f32 accumulators in registers), fed
//     by ldmatrix. mma.sync rather than wgmma: it takes 16-row tiles, which
//     halve a small batch's latency (wgmma's warpgroup tile is 64 rows), and
//     its fragments take the int8 dequantization in registers. wgmma over a
//     canonical-layout weight stream is the lever for the product's share.
//   * Weights stream through shared memory in K-slabs of up to 64 rows × 256
//     columns, kStages slabs in flight, in one continuous sequence across
//     layers: the next layer's first slabs load while this one finishes.
//     The wrapper lays the weights out once, slab by slab, already padded
//     for ldmatrix (the slab stream, below), so one TMA bulk copy
//     (cp.async.bulk, completing on an mbarrier) moves a whole slab: one
//     instruction from one thread, where per-thread 16-byte cp.async copies
//     spent longer issuing than the slab's products took, and a bulk copy
//     per row paid TMA's fixed cost per copy. Each slab is read from L2 once
//     per block and feeds every row of the tile. The first slabs are issued
//     before the feature expansion.
//   * int8 slabs move half the bytes of bf16 and share the path: ldmatrix
//     hands each thread the bytes of its B fragments, which it dequantizes
//     in registers to bf16_rn(float(q) * s), the JAX kernel's rounding
//     (fused_mlp.py:271) — no dequantized copy, no extra barrier.
//   * Activations stay in shared memory as bf16, ping-pong, with a row
//     stride of (width + 8) elements so ldmatrix rows fall in distinct banks.
//     Bias and tanh-GELU run on the accumulator registers in f32 and round
//     to bf16 once, where _kernel :274-277 does.
//   * 16 warps per block, each owning whole 16-column pairs of a pass; 16- or
//     32-row tiles, chosen per batch by the wrapper (tile_rows).
//   * The f32 variant (parity/debug, never served by default) stays on a
//     CUDA-core kernel: TF32 keeps ~3 decimal digits and cannot meet the f32
//     class (rtol 1e-4 / atol 1e-3).
//
// Plain C interface, loaded with ctypes; the launcher returns
// cudaGetLastError() and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;         // 16 warps, both kernels
constexpr int kMaxLayers = 8;
constexpr int kMaxQ = 16;
constexpr int kFeatures = 12;
constexpr int kK0 = 80;               // layer-0 K: expanded lanes 0..66, padded
constexpr int kPad = 16;              // tensor-core variants: K, N multiples

// Tensor-core kernel (bf16, int8).
constexpr int kSlabRows = 64;         // K rows of one weight slab
constexpr int kStages = 3;            // slabs in the ring of TMA copies
constexpr int kPassCols = 256;        // output columns one pass accumulates
constexpr int kWarps = kThreads / 32;  // each owns pairs p ≡ warp (mod 16)

// CUDA-core kernel (f32).
constexpr int kTileF32 = 32;
constexpr int kRowChunk = 8;          // rows one thread accumulates per column

// Expanded-row lanes (the JAX kernel's order, fused_mlp.py:103-109).
constexpr int kWd = 8, kHr = 40, kDist = 64, kLogd = 65, kAge = 66;

enum Variant { kF32 = 0, kBf16 = 1, kInt8 = 2 };

struct Layers {
  const void* w[kMaxLayers];     // f32: (K_l, N_l) row-major
  const float* b[kMaxLayers];    // f32: (N_l,)
  const unsigned char* slabs;    // bf16 / int8: the slab stream (below)
  int dim[kMaxLayers + 1];       // dim[0] = kK0, dim[l + 1] = N_l
  int n_layers;
  int ld;                        // activation row stride, elements
};

__device__ __forceinline__ void store_act(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_act(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float kSqrt2OverPi = 0.7978845608028654f;
  return 0.5f * x * (1.0f + tanhf(kSqrt2OverPi * (x + 0.044715f * x * x * x)));
}

// The same function as 0.5·x·(1 + tanh(u)), u = √(2/π)(x + 0.044715x³),
// written as x·sigmoid(2u) with the fast exponential: f32 error ~1e-6
// relative, far below the bf16 rounding that follows it. The tensor-core
// kernel's epilogue; the f32 kernel keeps gelu_tanh.
__device__ __forceinline__ float gelu_fast(float x) {
  const float kTwoSqrt2OverPi = 1.5957691216057308f;
  return __fdividef(x, 1.0f + __expf(-kTwoSqrt2OverPi *
                                     (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// Expand the tile's rows into act lanes 0..kK0-1 (zeros past B): every
// row's lanes are zeroed 16 bytes at a time, then one thread per row
// writes its nonzero lanes — no per-lane branches that would diverge
// across a warp. Weekday/hour truncate toward zero after a clamp (like
// astype(int32), but defined for huge inputs); out-of-range values set no
// lane. The normalizer lives in the packed layer-0 weights. Ends with a
// barrier.
template <typename T>
__device__ void expand_tile(const float* __restrict__ x, int row0, int nrows,
                            int tile, float* dist, T* act, int ld) {
  const int r = threadIdx.x;
  float xr[kFeatures];
#pragma unroll
  for (int f = 0; f < kFeatures; ++f)
    xr[f] = r < nrows ? x[(size_t)(row0 + r) * kFeatures + f] : 0.0f;
  constexpr int kVec = 16 / sizeof(T);            // elements per 16 bytes
  constexpr int kVecs = kK0 / kVec;               // 16-byte pieces per row
  for (int i = threadIdx.x; i < tile * kVecs; i += kThreads) {
    const int row = i / kVecs;
    *reinterpret_cast<uint4*>(act + row * ld + (i - row * kVecs) * kVec) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  if (r < tile) {
    T* a = act + r * ld;
#pragma unroll
    for (int c = 0; c < kWd; ++c) store_act(a + c, xr[c]);
    const int wd = (int)fminf(fmaxf(xr[8], -1.0f), 8.0f);
    if (wd >= 0 && wd < 7) store_act(a + kWd + wd, 1.0f);
    const int hr = (int)fminf(fmaxf(xr[9], -1.0f), 25.0f);
    if (hr >= 0 && hr < 24) store_act(a + kHr + hr, 1.0f);
    const float d = xr[10] > 0.0f ? xr[10] : 0.0f;
    store_act(a + kDist, d);
    store_act(a + kLogd, log1pf(d));
    store_act(a + kAge, xr[11]);
    dist[r] = d;
  }
  __syncthreads();
}

// Epilogue in f32: point pace·dist + overhead, or cumulative softplus sums
// per head family (non-crossing by construction). head rows have stride hp.
__device__ void write_out(const float* head, int hp, const float* dist,
                          float* __restrict__ out, int row0, int nrows,
                          int n_q) {
  for (int r = threadIdx.x; r < nrows; r += kThreads) {
    const float* h = head + r * hp;
    const float d = dist[r];
    if (n_q == 0) {
      out[row0 + r] = softplus(h[0]) * d + softplus(h[1]);
    } else {
      float pace = 0.0f, over = 0.0f;
      for (int q = 0; q < n_q; ++q) {
        pace += softplus(h[q]);
        over += softplus(h[n_q + q]);
        out[(size_t)(row0 + r) * n_q + q] = pace * d + over;
      }
    }
  }
}

// ── CUDA-core kernel: the f32 variant ─────────────────────────────────────
// One 32-row tile per block; each thread owns one output column for an
// 8-row chunk, so each weight element it reads from L2 feeds 8 FMAs, and
// activations are read four K-steps at a time as one broadcast float4.

__global__ void __launch_bounds__(kThreads)
fused_eta_f32_kernel(const float* __restrict__ x, float* __restrict__ out,
                     int batch, Layers L, int n_q) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* act_a = reinterpret_cast<float*>(smem);
  float* act_b = act_a + kTileF32 * L.ld;
  const int hp = L.dim[L.n_layers];
  float* head = act_b + kTileF32 * L.ld;
  float* dist = head + kTileF32 * hp;

  const int row0 = blockIdx.x * kTileF32;
  const int nrows = min(kTileF32, batch - row0);
  expand_tile(x, row0, nrows, kTileF32, dist, act_a, L.ld);

  float* in = act_a;
  float* nxt = act_b;
  constexpr int kChunks = kTileF32 / kRowChunk;
  for (int l = 0; l < L.n_layers; ++l) {
    const int K = L.dim[l], N = L.dim[l + 1];
    const float* __restrict__ W = static_cast<const float*>(L.w[l]);
    const float* __restrict__ bias = L.b[l];
    const bool last = l == L.n_layers - 1;
    for (int item = threadIdx.x; item < N * kChunks; item += kThreads) {
      const int j = item % N;
      const int r0 = (item / N) * kRowChunk;
      float acc[kRowChunk];
#pragma unroll
      for (int r = 0; r < kRowChunk; ++r) acc[r] = 0.0f;
      if (r0 < nrows) {
        int k = 0;
        for (; k + 4 <= K; k += 4) {
          const float w0 = W[(size_t)(k + 0) * N + j];
          const float w1 = W[(size_t)(k + 1) * N + j];
          const float w2 = W[(size_t)(k + 2) * N + j];
          const float w3 = W[(size_t)(k + 3) * N + j];
#pragma unroll
          for (int r = 0; r < kRowChunk; ++r) {
            const float4 a =
                *reinterpret_cast<const float4*>(in + (r0 + r) * L.ld + k);
            acc[r] = fmaf(a.x, w0, acc[r]);
            acc[r] = fmaf(a.y, w1, acc[r]);
            acc[r] = fmaf(a.z, w2, acc[r]);
            acc[r] = fmaf(a.w, w3, acc[r]);
          }
        }
        for (; k < K; ++k) {
          const float w = W[(size_t)k * N + j];
#pragma unroll
          for (int r = 0; r < kRowChunk; ++r)
            acc[r] = fmaf(in[(r0 + r) * L.ld + k], w, acc[r]);
        }
      }
      const float bj = bias[j];
#pragma unroll
      for (int r = 0; r < kRowChunk; ++r) {
        const float v = acc[r] + bj;
        if (last) {
          head[(r0 + r) * hp + j] = v;
        } else {
          nxt[(r0 + r) * L.ld + j] = gelu_tanh(v);
        }
      }
    }
    __syncthreads();
    float* t = in; in = nxt; nxt = t;
  }
  write_out(head, hp, dist, out, row0, nrows, n_q);
}

// ── Tensor-core kernel: the bf16 and int8 variants ────────────────────────

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// One TMA bulk copy, global → shared, completing on bar (16-byte multiples,
// 16-byte aligned ends).
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A fragment of m16n8k16: rows 0-15 × k 0-15 of a row-major bf16 tile.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// B fragments of two n8 tiles from a (K, N) row-major bf16 slab:
// r[0], r[1] for columns n..n+7, r[2], r[3] for n+8..n+15.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The slab stream (built once per packing by the wrapper): for each layer,
// each pass of up to kPassCols columns, each K-slab of up to kSlabRows rows,
// one contiguous record
//   [rows × (cols + 8) bf16 | rows × (cols + 16) int8]  weights, row-padded
//   [cols f32 scales]                                    int8 only
//   [cols f32 bias]                                      last slab of a pass
// so one TMA bulk copy moves a whole slab into its ring slot, already laid
// out for ldmatrix: a (cols + 8)-element bf16 row stride is an odd multiple
// of 16 bytes, so the eight rows of each 8×8 matrix fall in distinct banks.
template <bool kQuant>
__host__ __device__ constexpr int row_bytes(int cols) {
  return kQuant ? cols + 16 : (cols + 8) * 2;
}
template <bool kQuant>
__host__ __device__ constexpr int slot_bytes() {
  return kSlabRows * row_bytes<kQuant>(kPassCols) + (kQuant ? 2 : 1) * kPassCols * 4;
}

// Position in the slab sequence: layer, column pass, K slab, and the
// record's byte offset in the stream.
struct Slab {
  int l, c, s;
  size_t off;
};

template <bool kQuant>
__device__ __forceinline__ int record_bytes(const Slab& q, const Layers& L) {
  const int K = L.dim[q.l], N = L.dim[q.l + 1];
  const int k0 = q.s * kSlabRows, cols = min(kPassCols, N - q.c * kPassCols);
  return min(kSlabRows, K - k0) * row_bytes<kQuant>(cols) +
         (kQuant ? cols * 4 : 0) + (k0 + kSlabRows >= K ? cols * 4 : 0);
}

// One thread starts slab q's TMA copy into slot, completing on bar, and
// advances q. Nothing past the last layer.
template <bool kQuant>
__device__ __forceinline__ void issue_slab(Slab& q, const Layers& L,
                                           unsigned char* slot, uint64_t* bar) {
  if (q.l >= L.n_layers) return;
  const int bytes = record_bytes<kQuant>(q, L);
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, bytes);
    bulk_copy(slot, L.slabs + q.off, bytes, bar);
  }
  q.off += bytes;
  if (++q.s * kSlabRows < L.dim[q.l]) return;
  q.s = 0;
  if (++q.c * kPassCols < L.dim[q.l + 1]) return;
  q.c = 0;
  ++q.l;
}

// B fragments of two n8 tiles from an int8 (K, N) row-major slab: the
// 16 int8 columns of a group read as eight b16 pairs, so after the
// transpose a thread holds, for k = 2t, 2t+1 (r[0]) and 2t+8, 2t+9 (r[1]),
// the bytes of columns 2m and 2m+1 (t = lane % 4, m = lane / 4): the
// fragments of an n8 tile of the group's even columns and one of its odd
// columns.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)));
}

// Four int8 weights (bytes: [k][2m], [k][2m+1], [k+1][2m], [k+1][2m+1])
// → the even- and odd-column bf16 pairs, each bf16_rn(float(q) * s), the
// JAX kernel's dequantization (fused_mlp.py:271). float(q) is exact:
// 0x4B000000 | (q + 128) is the float 2^23 + q + 128.
__device__ __forceinline__ void dequant4(uint32_t q, float s_even, float s_odd,
                                         uint32_t& even, uint32_t& odd) {
  const uint32_t u = q ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) -
           8388736.0f;
  const __nv_bfloat162 e = __floats2bfloat162_rn(f[0] * s_even, f[2] * s_even);
  const __nv_bfloat162 o = __floats2bfloat162_rn(f[1] * s_odd, f[3] * s_odd);
  even = *reinterpret_cast<const uint32_t*>(&e);
  odd = *reinterpret_cast<const uint32_t*>(&o);
}

// One block per kTile-row tile. A pass covers up to kPassCols output
// columns as 16-column pairs; warp w owns every row of the tile and the
// pairs p ≡ w (mod 16), so each B fragment is loaded (and, for int8,
// dequantized) by one warp only. 16 warps rather than 8: with one block
// per SM at serving batches, the extra warps hide mma and SFU latency.
// minBlocks = 1 states that design (shared memory holds one block per SM
// from 32 rows up); without it ptxas sizes registers for three and spills.
template <bool kQuant, int kTile>
__global__ void __launch_bounds__(kThreads, 1)
fused_eta_tc_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int batch, Layers L, int n_q) {
  constexpr int kMt = kTile / 16;                 // m16 tiles per warp
  constexpr int kNp = kPassCols / (16 * kWarps);  // column pairs per warp
  constexpr int kSlot = slot_bytes<kQuant>();
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* act_a = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* act_b = act_a + kTile * L.ld;
  unsigned char* ring = reinterpret_cast<unsigned char*>(act_b + kTile * L.ld);
  float* head = reinterpret_cast<float*>(ring + kStages * kSlot);
  const int hp = L.dim[L.n_layers];
  float* dist = head + kTile * hp;
  uint64_t* full = reinterpret_cast<uint64_t*>(dist + kTile);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kTile;
  const int nrows = min(kTile, batch - row0);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // The first slabs stream in while the tile is expanded.
  Slab prod{0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i)
    issue_slab<kQuant>(prod, L, ring + i * kSlot, full + i);
  expand_tile(x, row0, nrows, kTile, dist, act_a, L.ld);

  float acc[kMt][kNp][2][4];
  __nv_bfloat16* in = act_a;
  __nv_bfloat16* nxt = act_b;
  int g = 0;                                       // slab sequence number
  for (int l = 0; l < L.n_layers; ++l) {
    const int K = L.dim[l], N = L.dim[l + 1];
    const bool last = l == L.n_layers - 1;
    for (int c0 = 0; c0 < N; c0 += kPassCols) {
      const int cols = min(kPassCols, N - c0);
      const int npairs = cols / 16;
      const int ldb = row_bytes<kQuant>(cols) / (kQuant ? 1 : 2);
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
        for (int j = 0; j < kNp; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][j][h][e] = 0.0f;

      for (int k0 = 0; k0 < K; k0 += kSlabRows, ++g) {
        // Every warp is done with slab g-1, whose slot may be refilled;
        // then wait for slab g to land.
        __syncthreads();
        const int refill = (g + kStages - 1) % kStages;
        issue_slab<kQuant>(prod, L, ring + refill * kSlot, full + refill);
        const unsigned char* slot = ring + (g % kStages) * kSlot;
        mbar_wait(full + g % kStages, (g / kStages) & 1);
        const int rows = min(kSlabRows, K - k0);
        float2 sc[kNp];                            // int8: (even, odd) scales
        if constexpr (kQuant) {
          const float* scale = reinterpret_cast<const float*>(slot + rows * ldb);
#pragma unroll
          for (int j = 0; j < kNp; ++j)
            sc[j] = *reinterpret_cast<const float2*>(
                scale + min(warp + j * kWarps, npairs - 1) * 16 + 2 * (lane >> 2));
        }
        for (int kk = 0; kk < rows; kk += 16) {
          uint32_t a[kMt][4];
#pragma unroll
          for (int mt = 0; mt < kMt; ++mt)
            ldmatrix_x4(a[mt], in + (mt * 16 + (lane & 15)) * L.ld + k0 + kk
                                   + (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < kNp; ++j) {
            const int p = warp + j * kWarps;
            if (p < npairs) {
              uint32_t b[4];
              if constexpr (kQuant) {
                uint32_t q[2];
                ldmatrix_x2_trans(q, slot + (kk + (lane & 15)) * ldb + p * 16);
                dequant4(q[0], sc[j].x, sc[j].y, b[0], b[2]);
                dequant4(q[1], sc[j].x, sc[j].y, b[1], b[3]);
              } else {
                ldmatrix_x4_trans(b, reinterpret_cast<const __nv_bfloat16*>(slot)
                                         + (kk + (lane & 15)) * ldb + p * 16
                                         + (lane >> 4) * 8);
              }
#pragma unroll
              for (int mt = 0; mt < kMt; ++mt) {
                mma_bf16(acc[mt][j][0], a[mt], b[0], b[1]);
                mma_bf16(acc[mt][j][1], a[mt], b[2], b[3]);
              }
            }
          }
        }
      }

      // Pass epilogue on the accumulators: bias (from the last slab's slot)
      // plus GELU, rounded to bf16 once, into the next activation buffer;
      // or raw f32 heads. Two adjacent columns per store: n8 tile h's
      // columns 2t, 2t+1 (bf16: h·8 + 2t; int8, whose tiles are a group's
      // even and odd columns: 4t + 2e) at rows t/4 and t/4 + 8.
      const int rows_last = K - (K - 1) / kSlabRows * kSlabRows;
      const float* bias = reinterpret_cast<const float*>(
          ring + ((g - 1) % kStages) * kSlot +
          rows_last * row_bytes<kQuant>(cols) + (kQuant ? cols * 4 : 0));
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
#pragma unroll
        for (int j = 0; j < kNp; ++j) {
          const int p = warp + j * kWarps;
          if (p >= npairs) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = mt * 16 + half * 8 + (lane >> 2);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = kQuant ? p * 16 + 4 * (lane & 3) + 2 * e
                                     : p * 16 + e * 8 + 2 * (lane & 3);
              const float v0 = kQuant ? acc[mt][j][0][2 * half + e]
                                      : acc[mt][j][e][2 * half];
              const float v1 = kQuant ? acc[mt][j][1][2 * half + e]
                                      : acc[mt][j][e][2 * half + 1];
              const float2 bb = *reinterpret_cast<const float2*>(bias + col);
              if (last) {
                float* o = head + row * hp + c0 + col;
                o[0] = v0 + bb.x;
                o[1] = v1 + bb.y;
              } else {
                *reinterpret_cast<__nv_bfloat162*>(nxt + row * L.ld + c0 + col) =
                    __floats2bfloat162_rn(gelu_fast(v0 + bb.x),
                                          gelu_fast(v1 + bb.y));
              }
            }
          }
        }
      }
    }
    __nv_bfloat16* t = in; in = nxt; nxt = t;
  }
  __syncthreads();
  write_out(head, hp, dist, out, row0, nrows, n_q);
}

size_t tc_smem_bytes(const Layers& L, int tile, bool quant) {
  return 2 * (size_t)tile * L.ld * sizeof(__nv_bfloat16)
      + kStages * (size_t)(quant ? slot_bytes<true>() : slot_bytes<false>())
      + sizeof(float) * tile * (L.dim[L.n_layers] + 1)
      + sizeof(uint64_t) * kStages;
}

size_t f32_smem_bytes(const Layers& L) {
  return sizeof(float) * kTileF32 * (2 * L.ld + L.dim[L.n_layers] + 1);
}

template <typename Kernel>
int launch(Kernel kernel, int tile, size_t smem, const float* x, float* out,
           int batch, const Layers& L, int n_q, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (batch + tile - 1) / tile;
  kernel<<<blocks, kThreads, smem, stream>>>(x, out, batch, L, n_q);
  return (int)cudaGetLastError();
}

}  // namespace

// variant: 0 f32 (CUDA cores; weights and biases through w_ptrs, b_ptrs),
// 1 bf16, 2 int8 (tensor cores; everything through the slab stream).
// tile: rows per block of the tensor-core kernel, 16 or 32 (the f32 kernel
// always takes 32).
extern "C" int rtpu_fused_eta_forward(const float* x, float* out, int batch,
                                      const uint64_t* w_ptrs,
                                      const uint64_t* b_ptrs,
                                      const void* slabs, const int* dims,
                                      int n_layers, int n_q, int variant,
                                      int tile, void* stream) {
  if (batch <= 0) return 0;
  const bool tc = variant == kBf16 || variant == kInt8;
  if (n_layers < 1 || n_layers > kMaxLayers || n_q < 0 || n_q > kMaxQ ||
      dims[0] != kK0 || dims[n_layers] < 2 * (n_q > 0 ? n_q : 1) ||
      (variant != kF32 && !tc) || (tc && slabs == nullptr) ||
      (!tc && (w_ptrs == nullptr || b_ptrs == nullptr)) ||
      (tc && tile != 16 && tile != 32))
    return (int)cudaErrorInvalidValue;
  Layers L;
  L.slabs = static_cast<const unsigned char*>(slabs);
  int widest = 0;
  for (int l = 0; l < n_layers; ++l) {
    L.w[l] = tc ? nullptr : reinterpret_cast<const void*>(w_ptrs[l]);
    L.b[l] = tc ? nullptr : reinterpret_cast<const float*>(b_ptrs[l]);
    widest = dims[l] > widest ? dims[l] : widest;
  }
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] <= 0 || (tc && dims[l] % kPad != 0))
      return (int)cudaErrorInvalidValue;
    L.dim[l] = dims[l];
  }
  L.n_layers = n_layers;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!tc) {
    L.ld = (widest + 3) / 4 * 4;
    return launch(fused_eta_f32_kernel, kTileF32, f32_smem_bytes(L), x, out,
                  batch, L, n_q, s);
  }
  L.ld = widest + 8;
  const bool quant = variant == kInt8;
  const size_t smem = tc_smem_bytes(L, tile, quant);
  switch (tile * 2 + quant) {
    case 32: return launch(fused_eta_tc_kernel<false, 16>, 16, smem, x, out, batch, L, n_q, s);
    case 33: return launch(fused_eta_tc_kernel<true, 16>, 16, smem, x, out, batch, L, n_q, s);
    case 64: return launch(fused_eta_tc_kernel<false, 32>, 32, smem, x, out, batch, L, n_q, s);
    default: return launch(fused_eta_tc_kernel<true, 32>, 32, smem, x, out, batch, L, n_q, s);
  }
}

extern "C" const char* rtpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

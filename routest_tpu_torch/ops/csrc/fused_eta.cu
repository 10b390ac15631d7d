// Fused ETA-MLP forward for Hopper (sm_90a): (B, 12) ABI rows → (B,) point
// minutes or (B, n_q) non-crossing quantile minutes in one launch.
//
// Replaces the TPU kernel routest_tpu/ops/fused_mlp.py::fused_eta_forward
// (pl.pallas_call at :366, body _kernel :214-299). The Python side
// (routest_tpu_torch/ops/fused_mlp.py) packs the weights, checks shapes
// and holds the plain PyTorch version this kernel is compared against.
//
// Bound on the H100: at serving batches the work (~239 kFLOP per row for
// the shipped 42→256→256→128→6 trunk against 60 bytes of row traffic) sits
// far above the bytes-per-FLOP line, so the floor is the tensor cores'
// rate. This kernel is the simple, right first version: its GEMMs run as
// f32 FMAs on the CUDA cores, bounded by the FMA rate and by the shared-
// memory reads that feed them. The design keeps every activation in shared
// memory (two ping-pong buffers in the compute dtype), reads each weight
// from L2 once per 8-row chunk (the packed trunk, ~239 KB in bf16, stays
// resident in the 50 MB L2), and loads activations four K-steps at a time
// as one broadcast vector load. wgmma/TMA tiling is later work.
//
// Plain C interface, loaded with ctypes; the launcher returns
// cudaGetLastError() and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;        // rows per block
constexpr int kThreads = 256;
constexpr int kRowChunk = 8;     // rows one thread accumulates per column
constexpr int kMaxLayers = 8;
constexpr int kMaxQ = 16;
constexpr int kFeatures = 12;
constexpr int kK0 = 80;          // layer-0 K: expanded lanes 0..66, padded

// Expanded-row lanes (the JAX kernel's order, fused_mlp.py:103-109).
constexpr int kWd = 8, kHr = 40, kDist = 64, kLogd = 65, kAge = 66;

struct Layers {
  const void* w[kMaxLayers];     // (K_l, N_l) row-major, compute dtype
  const float* b[kMaxLayers];    // (N_l,) f32
  int dim[kMaxLayers + 1];       // dim[0] = kK0, dim[l + 1] = N_l
  int n_layers;
  int ld;                        // activation row stride, multiple of 4
};

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// Four consecutive activations (16-byte / 8-byte aligned) as f32.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float kSqrt2OverPi = 0.7978845608028654f;
  return 0.5f * x * (1.0f + tanhf(kSqrt2OverPi * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_eta_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int batch, Layers L, int n_q) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* act_a = reinterpret_cast<T*>(smem);
  T* act_b = act_a + kTile * L.ld;
  const int n_heads = L.dim[L.n_layers];
  float* head = reinterpret_cast<float*>(act_b + kTile * L.ld);
  float* dist = head + kTile * n_heads;
  float* xs = dist + kTile;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kTile;
  const int nrows = min(kTile, batch - row0);

  // Stage the tile's raw rows; the ragged last tile reads zeros past B.
  for (int i = tid; i < kTile * kFeatures; i += kThreads) {
    const int r = i / kFeatures;
    xs[i] = r < nrows ? x[(size_t)row0 * kFeatures + i] : 0.0f;
  }
  __syncthreads();

  // Expansion into act_a: weekday/hour truncate toward zero after a clamp
  // (like astype(int32), but defined for huge inputs); out-of-range values
  // set no lane. The normalizer lives in the packed layer-0 weights.
  for (int i = tid; i < kTile * kK0; i += kThreads) {
    const int r = i / kK0, lane = i - r * kK0;
    const float* xr = xs + r * kFeatures;
    const float d = xr[10] > 0.0f ? xr[10] : 0.0f;
    float v = 0.0f;
    if (lane < kWd) {
      v = xr[lane];
    } else if (lane < kWd + 7) {
      const int wd = (int)fminf(fmaxf(xr[8], -1.0f), 8.0f);
      v = (lane - kWd == wd) ? 1.0f : 0.0f;
    } else if (lane >= kHr && lane < kHr + 24) {
      const int hr = (int)fminf(fmaxf(xr[9], -1.0f), 25.0f);
      v = (lane - kHr == hr) ? 1.0f : 0.0f;
    } else if (lane == kDist) {
      v = d;
    } else if (lane == kLogd) {
      v = log1pf(d);
    } else if (lane == kAge) {
      v = xr[11];
    }
    act_a[r * L.ld + lane] = from_f32<T>(v);
    if (lane == 0) dist[r] = d;
  }
  __syncthreads();

  T* in = act_a;
  T* nxt = act_b;
  constexpr int kChunks = kTile / kRowChunk;
  for (int l = 0; l < L.n_layers; ++l) {
    const int K = L.dim[l], N = L.dim[l + 1];
    const T* __restrict__ W = static_cast<const T*>(L.w[l]);
    const float* __restrict__ bias = L.b[l];
    const bool last = l == L.n_layers - 1;
    for (int item = tid; item < N * kChunks; item += kThreads) {
      const int j = item % N;
      const int r0 = (item / N) * kRowChunk;
      float acc[kRowChunk];
#pragma unroll
      for (int r = 0; r < kRowChunk; ++r) acc[r] = 0.0f;
      if (r0 < nrows) {
        int k = 0;
        for (; k + 4 <= K; k += 4) {
          const float w0 = to_f32<T>(W[(size_t)(k + 0) * N + j]);
          const float w1 = to_f32<T>(W[(size_t)(k + 1) * N + j]);
          const float w2 = to_f32<T>(W[(size_t)(k + 2) * N + j]);
          const float w3 = to_f32<T>(W[(size_t)(k + 3) * N + j]);
#pragma unroll
          for (int r = 0; r < kRowChunk; ++r) {
            float a[4];
            load4(in + (r0 + r) * L.ld + k, a);
            acc[r] = fmaf(a[0], w0, acc[r]);
            acc[r] = fmaf(a[1], w1, acc[r]);
            acc[r] = fmaf(a[2], w2, acc[r]);
            acc[r] = fmaf(a[3], w3, acc[r]);
          }
        }
        for (; k < K; ++k) {
          const float w = to_f32<T>(W[(size_t)k * N + j]);
#pragma unroll
          for (int r = 0; r < kRowChunk; ++r)
            acc[r] = fmaf(to_f32<T>(in[(r0 + r) * L.ld + k]), w, acc[r]);
        }
      }
      const float bj = bias[j];
#pragma unroll
      for (int r = 0; r < kRowChunk; ++r) {
        const float v = acc[r] + bj;
        if (last) {
          head[(r0 + r) * n_heads + j] = v;
        } else {
          nxt[(r0 + r) * L.ld + j] = from_f32<T>(gelu_tanh(v));
        }
      }
    }
    __syncthreads();
    T* t = in; in = nxt; nxt = t;
  }

  // Epilogue in f32: point pace·dist + overhead, or cumulative softplus
  // sums per head family (non-crossing by construction).
  for (int r = tid; r < nrows; r += kThreads) {
    const float* h = head + r * n_heads;
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

template <typename T>
int launch(const float* x, float* out, int batch, const Layers& L, int n_q,
           cudaStream_t stream) {
  const size_t smem = 2 * (size_t)kTile * L.ld * sizeof(T)
      + sizeof(float) * kTile * (L.dim[L.n_layers] + 1 + kFeatures);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_eta_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (batch + kTile - 1) / kTile;
  fused_eta_kernel<T><<<blocks, kThreads, smem, stream>>>(x, out, batch, L,
                                                          n_q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rtpu_fused_eta_forward(const float* x, float* out, int batch,
                                      const uint64_t* w_ptrs,
                                      const uint64_t* b_ptrs, const int* dims,
                                      int n_layers, int n_q, int bf16,
                                      void* stream) {
  if (batch <= 0) return 0;
  if (n_layers < 1 || n_layers > kMaxLayers || n_q < 0 || n_q > kMaxQ ||
      dims[0] != kK0 || dims[n_layers] != 2 * (n_q > 0 ? n_q : 1))
    return (int)cudaErrorInvalidValue;
  Layers L;
  int widest = 0;
  for (int l = 0; l < n_layers; ++l) {
    L.w[l] = reinterpret_cast<const void*>(w_ptrs[l]);
    L.b[l] = reinterpret_cast<const float*>(b_ptrs[l]);
    widest = dims[l] > widest ? dims[l] : widest;
  }
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] <= 0) return (int)cudaErrorInvalidValue;
    L.dim[l] = dims[l];
  }
  L.n_layers = n_layers;
  L.ld = (widest + 3) / 4 * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, out, batch, L, n_q, s)
              : launch<float>(x, out, batch, L, n_q, s);
}

extern "C" const char* rtpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

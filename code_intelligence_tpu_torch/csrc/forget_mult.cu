// QRNN forget-mult recurrence for Hopper (sm_90a): the forward K6, its
// adjoint K7 and the length-aware forward K8.
//
// K6 replaces the TPU kernel code_intelligence_tpu/ops/pallas_qrnn.py::
// _forward_tm (body _fwd_kernel). Time-major z, f, out (T, B, H), h0 (B, H),
// all of one dtype (f32 or bf16):
//
//   h = h0 (in f32)
//   for t in 0..T-1:  h = f[t] * h + (1 - f[t]) * z[t]   (f32)
//                     out[t] = h, rounded to the dtype
//
// so the carry stays f32 inside a call and only the stored outputs round.
//
// K7 replaces _backward_tm (body _bwd_kernel), the adjoint in reverse time.
// With g (T, B, H) the output cotangent and the f32 carry c = 0:
//
//   for t = T-1 down to 0:  s = c + g[t]
//                           dz[t] = s * (1 - f[t])
//                           df[t] = s * (h_prev - z[t])
//                           c = f[t] * s
//   dh0 = c
//
// where h_prev is the stored output out[t-1], or h0 at t = 0.
//
// K8 replaces _forward_tm_ragged (body _fwd_kernel_ragged): K6 plus
// valid (B,) int32. Row b runs min(valid[b], T) steps (none when valid[b] <=
// 0), then writes its frozen carry, rounded, over the rest of its outputs,
// so out[T-1] is its state after min(valid, T) steps. The TPU kernel loops a
// tile of rows to the tile's longest length and freezes the shorter rows
// with a where; the result is the same, so no tile is needed here.
//
// What bounds them on an H100: no weight matrix, two operations per element
// and step, so bytes. K6 reads z and f and writes out once: 3 T*B*H elements
// (30.7 MB in bf16 at T=64, B=32, H=2500: 9.2 us at 3.35 TB/s). K7 reads z,
// f, out, g and writes dz, df: 6 T*B*H elements.
//
// Design, simple first: one launch per call. One thread per (b, h) lane of
// the time-major tensors, so consecutive threads touch consecutive
// addresses and every load and store coalesces; each thread walks T in
// order with the carry in a register. The loads do not depend on the carry,
// so a thread issues kAhead steps of them before it uses any: a step's
// latency is paid once per kAhead steps, not once per step. The arithmetic
// uses the _rn intrinsics, so nvcc contracts nothing into an FMA and each
// operation rounds as the plain PyTorch version's does.
//
// The TPU kernels' VMEM budget (fits_stream_budget, _pick_block_b), their
// sublane and lane padding (_pad_tm, _pad_state) and the fallback to the
// associative scan have no counterpart: every shape runs its kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAhead = 8;  // steps of loads in flight before their use

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// f * h + (1 - f) * z, each operation rounded on its own
__device__ __forceinline__ float fm_step(float h, float f, float z) {
  return __fadd_rn(__fmul_rn(f, h), __fmul_rn(__fsub_rn(1.0f, f), z));
}

// K6, and K8 when valid is not null. lanes = B * H; lane i is (i / H, i % H).
template <typename T>
__global__ void __launch_bounds__(kThreads)
forget_mult_fwd(const T* __restrict__ z, const T* __restrict__ f,
                const T* __restrict__ h0, const int* __restrict__ valid,
                T* __restrict__ out, int T_len, int H, size_t lanes) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= lanes) return;
  int n = T_len;
  if (valid != nullptr) n = max(0, min(valid[i / H], T_len));
  float h = load(h0 + i);
  for (int t0 = 0; t0 < n; t0 += kAhead) {
    float zr[kAhead], fr[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (t0 + k < n) {
        const size_t at = (size_t)(t0 + k) * lanes + i;
        zr[k] = load(z + at);
        fr[k] = load(f + at);
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (t0 + k < n) {
        h = fm_step(h, fr[k], zr[k]);
        store(out + (size_t)(t0 + k) * lanes + i, h);
      }
    }
  }
  for (int t = n; t < T_len; ++t) store(out + (size_t)t * lanes + i, h);
}

// K7. out is K6's output; g the cotangent of out.
template <typename T>
__global__ void __launch_bounds__(kThreads)
forget_mult_bwd(const T* __restrict__ z, const T* __restrict__ f,
                const T* __restrict__ out, const T* __restrict__ h0,
                const T* __restrict__ g, T* __restrict__ dz,
                T* __restrict__ df, T* __restrict__ dh0, int T_len,
                size_t lanes) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= lanes) return;
  float c = 0.0f;
  for (int t0 = T_len - 1; t0 >= 0; t0 -= kAhead) {
    float zr[kAhead], fr[kAhead], gr[kAhead], hr[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int t = t0 - k;
      if (t >= 0) {
        const size_t at = (size_t)t * lanes + i;
        zr[k] = load(z + at);
        fr[k] = load(f + at);
        gr[k] = load(g + at);
        hr[k] = t > 0 ? load(out + at - lanes) : load(h0 + i);
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int t = t0 - k;
      if (t >= 0) {
        const size_t at = (size_t)t * lanes + i;
        const float s = __fadd_rn(c, gr[k]);
        store(dz + at, __fmul_rn(s, __fsub_rn(1.0f, fr[k])));
        store(df + at, __fmul_rn(s, __fsub_rn(hr[k], zr[k])));
        c = __fmul_rn(fr[k], s);
      }
    }
  }
  store(dh0 + i, c);
}

inline unsigned blocks(size_t lanes) {
  return (unsigned)((lanes + kThreads - 1) / kThreads);
}

template <typename T>
int run_fwd(const void* z, const void* f, const void* h0, const int* valid,
            void* out, int T_len, int B, int H, cudaStream_t stream) {
  const size_t lanes = (size_t)B * H;
  forget_mult_fwd<T><<<blocks(lanes), kThreads, 0, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(f),
      static_cast<const T*>(h0), valid, static_cast<T*>(out), T_len, H,
      lanes);
  return (int)cudaGetLastError();
}

template <typename T>
int run_bwd(const void* z, const void* f, const void* out, const void* h0,
            const void* g, void* dz, void* df, void* dh0, int T_len, int B,
            int H, cudaStream_t stream) {
  const size_t lanes = (size_t)B * H;
  forget_mult_bwd<T><<<blocks(lanes), kThreads, 0, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(f),
      static_cast<const T*>(out), static_cast<const T*>(h0),
      static_cast<const T*>(g), static_cast<T*>(dz), static_cast<T*>(df),
      static_cast<T*>(dh0), T_len, lanes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for every tensor but valid. Tensors are
// contiguous device tensors: z, f, out, g, dz, df (T, B, H); h0, dh0 (B, H);
// valid (B,) int32. One launch each; B * H > 0 is the caller's to ensure.
// Each returns a cudaError_t (0 on success).

// K6
int forget_mult_forward(int dtype, const void* z, const void* f,
                        const void* h0, void* out, int T, int B, int H,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_fwd<float>(z, f, h0, nullptr, out, T, B, H, s);
  if (dtype == 1)
    return run_fwd<__nv_bfloat16>(z, f, h0, nullptr, out, T, B, H, s);
  return (int)cudaErrorInvalidValue;
}

// K8
int forget_mult_forward_ragged(int dtype, const void* z, const void* f,
                               const void* h0, const int* valid, void* out,
                               int T, int B, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_fwd<float>(z, f, h0, valid, out, T, B, H, s);
  if (dtype == 1)
    return run_fwd<__nv_bfloat16>(z, f, h0, valid, out, T, B, H, s);
  return (int)cudaErrorInvalidValue;
}

// K7: out is K6's output for these z, f, h0; g its cotangent.
int forget_mult_backward(int dtype, const void* z, const void* f,
                         const void* out, const void* h0, const void* g,
                         void* dz, void* df, void* dh0, int T, int B, int H,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_bwd<float>(z, f, out, h0, g, dz, df, dh0, T, B, H, s);
  if (dtype == 1)
    return run_bwd<__nv_bfloat16>(z, f, out, h0, g, dz, df, dh0, T, B, H, s);
  return (int)cudaErrorInvalidValue;
}

const char* forget_mult_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

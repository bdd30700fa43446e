// Fused LSTM recurrence, inference forward (kernel K1), for Hopper (sm_90a).
//
// Replaces the TPU kernel code_intelligence_tpu/ops/pallas_lstm.py::
// fused_lstm_forward with with_gates=False (body _kernel_no_gates). Same
// function, time-major:
//
//   for t in 0..T-1:
//     gates = x_proj[t] + h @ W_hh^T            (f32 accumulation)
//     i, f, g, o = sigmoid, sigmoid, tanh, sigmoid of the four H-slices
//     c = f * c + i * g ;  h = o * tanh(c)      (f32), then h and c are
//     stored in the input dtype, so bf16 rounds the carry every step
//     out[t] = h
//
// x_proj (T, B, 4H) is x @ W_ih^T + b, computed outside the kernel as in the
// JAX package. W_hh is (4H, H), gate order i, f, g, o.
//
// What bounds it on an H100: every step needs all of W_hh (4H*H elements:
// 50 MB in bf16 and 100 MB in f32 at H=2500) against the previous step's h.
// That is more than the card's shared memory (~30 MB over 132 SMs) and as
// large as its 50 MB L2, so the TPU kernel's trick of keeping W_hh resident
// on chip for the whole sequence does not carry over: each step streams
// W_hh again, and a step can take no less than 4H*H*itemsize / 3.35 TB/s
// (about 15 us in bf16 at H=2500). The step's 2*B*4H*H FLOPs (1.6 GFLOP at
// B=32) would take under 2 us on the tensor cores; this kernel does them as
// f32 FMAs on the CUDA cores (67 TFLOP/s), where they need at least 24 us,
// so at B=32 the FMAs, not the bytes, set its floor.
//
// Design, simple first:
//  * One launch per time step; the host loop enqueues T launches on the
//    caller's stream, which orders the steps. h_{t-1} is read back from
//    out[t-1]; c ping-pongs between a scratch buffer and c_T, so the last
//    step lands in c_T.
//  * A block owns kUnits hidden units, one warp each, and a tile of
//    kBatchTile batch rows. A warp holds all four gate rows of its unit
//    (rows j, H+j, 2H+j, 3H+j of W_hh), so the cell update needs no second
//    pass: after the dot products it is done in registers.
//  * The block stages h_{t-1} for its batch rows in shared memory as f32,
//    kChunk columns at a time. Each lane walks a strided slice of the
//    columns: one W_hh load per gate row feeds kBatchTile FMAs. A warp
//    reduce-scatter sums the lanes' partials, and the batch rows' cell
//    updates then run on 16 lanes at once.
//  * A step is too short to hide memory latency with many warps, so each
//    thread issues its loads in batches before using them: all its staging
//    loads of a chunk, then 8 columns of each of its four W_hh rows as two
//    vector loads per row (when H % 4 == 0; otherwise one column at a time).
//  * Batch tiles are the fastest-varying block index, so the blocks that
//    read the same W_hh rows run together and the second read hits L2.
//  Tensor cores (wgmma), TMA and a persistent design that keeps h on chip
//  across steps are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kUnits = 8;                // hidden units per block
constexpr int kThreads = kUnits * 32;    // one warp per unit
constexpr int kBatchTile = 16;           // batch rows per block
static_assert(kBatchTile == 16, "the reduce-scatter maps row bb to lanes 2bb, 2bb+1");
constexpr int kChunk = 512;              // h columns staged at a time
static_assert(kChunk % 256 == 0, "a 256-column pass must not straddle chunks");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype/.to do
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Four consecutive elements as f32, in one 8-byte (bf16) or 16-byte (f32)
// load; p is 4-element aligned.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);  // little-endian pairs
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

// Stages h_prev[b0 .. b0+kBatchTile, k0 .. k0+kChunk) into hs as f32, zero
// past B and H. Every load of the thread is issued before the first store,
// so they are in flight together. Called by all threads of the block.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_h(float (&hs)[kBatchTile][kChunk],
                                        const T* __restrict__ h_prev, int B,
                                        int H, int b0, int k0) {
  constexpr int kWidth = kVec ? 4 : 1;
  constexpr int kLoads = kBatchTile * kChunk / (kThreads * kWidth);
  const int kn = min(kChunk, H - k0);
  float staged[kLoads][kWidth];
#pragma unroll
  for (int r = 0; r < kLoads; ++r) {
    const int idx = (r * kThreads + threadIdx.x) * kWidth;
    const int bb = idx / kChunk, kk = idx % kChunk;
    const int b = b0 + bb;
    if (b < B && kk < kn) {
      if constexpr (kVec) {
        load4(h_prev + (size_t)b * H + k0 + kk, staged[r]);
      } else {
        staged[r][0] = to_f32(h_prev[(size_t)b * H + k0 + kk]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kWidth; ++e) staged[r][e] = 0.0f;
    }
  }
  __syncthreads();  // the previous chunk is consumed
#pragma unroll
  for (int r = 0; r < kLoads; ++r) {
    const int idx = (r * kThreads + threadIdx.x) * kWidth;
#pragma unroll
    for (int e = 0; e < kWidth; ++e)
      hs[idx / kChunk][idx % kChunk + e] = staged[r][e];
  }
  __syncthreads();
}

// The lane's 8 columns (kc + 4*lane .. +3 and kc + 128 + 4*lane .. +3) of
// its unit's four gate rows, as f32; 0 past H or for an inactive warp.
template <typename T>
__device__ __forceinline__ void load_w_pass(const T* __restrict__ w_row,
                                            size_t HH, int H, int kc,
                                            int lane, bool active,
                                            float (&w)[4][8]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int col = kc + 128 * half + 4 * lane;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (active && col < H) load4(w_row + g * HH + col, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) w[g][4 * half + e] = v[e];
    }
  }
}

// One level of the warp reduce-scatter: lanes kN apart swap the halves of
// their first kN batch-row sums, so each keeps kN/2 rows, now summed over
// both lanes. Template bounds keep acc in registers.
template <int kN>
__device__ __forceinline__ void halve_rows(float (&acc)[4][kBatchTile],
                                           int lane) {
  const bool upper = (lane & kN) != 0;
#pragma unroll
  for (int i = 0; i < kN / 2; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float send = upper ? acc[g][i] : acc[g][i + kN / 2];
      const float keep = upper ? acc[g][i + kN / 2] : acc[g][i];
      acc[g][i] = keep + __shfl_xor_sync(0xffffffffu, send, kN);
    }
}

// kVec (H % 4 == 0): h and W_hh move four columns per load. A lane owns
// columns 4*lane..+3 and 128+4*lane..+3 of each 256-column pass, so a warp's
// shared-memory reads of a row are 512 contiguous bytes (no bank conflicts)
// and its 8 W_hh loads per pass cover 2 KB. Otherwise one column per load.
// kChunk is a multiple of 256, so a pass never straddles two chunks.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
lstm_step(const T* __restrict__ x_proj,  // (B, 4H), this step
          const T* __restrict__ w_hh,    // (4H, H)
          const T* __restrict__ h_prev,  // (B, H)
          const T* __restrict__ c_prev,  // (B, H)
          T* __restrict__ h_out,         // (B, H), out[t]
          T* __restrict__ c_out,         // (B, H)
          T* __restrict__ h_last,        // (B, H) on the last step, else null
          int B, int H) {
  __shared__ __align__(16) float hs[kBatchTile][kChunk];
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.y * kUnits + (threadIdx.x >> 5);
  const int b0 = blockIdx.x * kBatchTile;
  const bool active = j < H;

  float acc[4][kBatchTile];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int bb = 0; bb < kBatchTile; ++bb) acc[g][bb] = 0.0f;

  const size_t HH = (size_t)H * H;
  const T* w_row = w_hh + (size_t)(active ? j : 0) * H;  // gate i row

  if constexpr (kVec) {
    // Passes of 256 columns walk the whole row; a chunk of h is staged
    // every kChunk columns. The next pass's W_hh loads are issued before
    // the current pass's FMAs, so their latency hides behind them.
    float w[4][8];
    load_w_pass(w_row, HH, H, 0, lane, active, w);
    for (int kc = 0; kc < H; kc += 256) {
      if (kc % kChunk == 0) stage_h<T, true>(hs, h_prev, B, H, b0, kc);
      float w_next[4][8];
      load_w_pass(w_row, HH, H, kc + 256, lane, active, w_next);
      if (active) {
        const int local = kc % kChunk;
#pragma unroll
        for (int bb = 0; bb < kBatchTile; ++bb) {
          const float4 h0 =
              *reinterpret_cast<const float4*>(&hs[bb][local + 4 * lane]);
          const float4 h1 = *reinterpret_cast<const float4*>(
              &hs[bb][local + 128 + 4 * lane]);
          const float h[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
          for (int e = 0; e < 8; ++e)
#pragma unroll
            for (int g = 0; g < 4; ++g)
              acc[g][bb] = fmaf(w[g][e], h[e], acc[g][bb]);
        }
      }
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e) w[g][e] = w_next[g][e];
    }
  } else {
    for (int k0 = 0; k0 < H; k0 += kChunk) {
      stage_h<T, false>(hs, h_prev, B, H, b0, k0);
      if (!active) continue;
      const int kn = min(kChunk, H - k0);
      for (int kk = lane; kk < kn; kk += 32) {
        float w[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) w[g] = to_f32(w_row[g * HH + k0 + kk]);
#pragma unroll
        for (int bb = 0; bb < kBatchTile; ++bb) {
          const float h = hs[bb][kk];
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[g][bb] = fmaf(w[g], h, acc[g][bb]);
        }
      }
    }
  }
  if (!active) return;  // no barrier follows

  // Reduce-scatter across the warp: at each offset a lane keeps half of its
  // batch rows and adds its partner's partial sums for them, so the values
  // halve each level (64 shuffles in all). Afterwards lanes 2*bb and 2*bb+1
  // hold the totals of batch row bb, and the 16 rows finish in parallel.
  halve_rows<16>(acc, lane);
  halve_rows<8>(acc, lane);
  halve_rows<4>(acc, lane);
  halve_rows<2>(acc, lane);
#pragma unroll
  for (int g = 0; g < 4; ++g)
    acc[g][0] += __shfl_xor_sync(0xffffffffu, acc[g][0], 1);

  const int b = b0 + (lane >> 1);
  if ((lane & 1) || b >= B) return;
  const T* xp = x_proj + (size_t)b * 4 * H;
  const float ig = sigmoid(to_f32(xp[j]) + acc[0][0]);
  const float fg = sigmoid(to_f32(xp[H + j]) + acc[1][0]);
  const float gg = tanhf(to_f32(xp[2 * H + j]) + acc[2][0]);
  const float og = sigmoid(to_f32(xp[3 * H + j]) + acc[3][0]);
  const size_t at = (size_t)b * H + j;
  const float c = fg * to_f32(c_prev[at]) + ig * gg;
  const T h = from_f32<T>(og * tanhf(c));
  h_out[at] = h;
  c_out[at] = from_f32<T>(c);
  if (h_last != nullptr) h_last[at] = h;
}

template <typename T>
int run(const void* x_proj, const void* w_hh, const void* h0, const void* c0,
        void* out, void* h_t, void* c_t, void* c_scratch, int T_len, int B,
        int H, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x_proj);
  T* o = static_cast<T*>(out);
  const size_t BH = (size_t)B * H;
  const dim3 grid((B + kBatchTile - 1) / kBatchTile, (H + kUnits - 1) / kUnits);
  const auto step = H % 4 == 0 ? lstm_step<T, true> : lstm_step<T, false>;
  // c after step t lands in c_T when (T-1-t) is even, else in the scratch,
  // so the steps alternate buffers and the last one writes c_T.
  auto c_after = [&](int t) -> T* {
    return ((T_len - 1 - t) % 2 == 0) ? static_cast<T*>(c_t)
                                      : static_cast<T*>(c_scratch);
  };
  for (int t = 0; t < T_len; ++t) {
    const T* hp = t == 0 ? static_cast<const T*>(h0) : o + (t - 1) * BH;
    const T* cp = t == 0 ? static_cast<const T*>(c0) : c_after(t - 1);
    T* h_last = t == T_len - 1 ? static_cast<T*>(h_t) : nullptr;
    step<<<grid, kThreads, 0, stream>>>(
        xp + (size_t)t * 4 * BH, static_cast<const T*>(w_hh), hp, cp,
        o + (size_t)t * BH, c_after(t), h_last, B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. All pointers are device pointers of that
// dtype; c_scratch is (B, H). Returns a cudaError_t (0 on success). T = 0 is
// the caller's to handle.
int fused_lstm_forward(int dtype, const void* x_proj, const void* w_hh,
                       const void* h0, const void* c0, void* out, void* h_t,
                       void* c_t, void* c_scratch, int T, int B, int H,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x_proj, w_hh, h0, c0, out, h_t, c_t, c_scratch, T, B,
                      H, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x_proj, w_hh, h0, c0, out, h_t, c_t, c_scratch,
                              T, B, H, s);
  return (int)cudaErrorInvalidValue;
}

const char* fused_lstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

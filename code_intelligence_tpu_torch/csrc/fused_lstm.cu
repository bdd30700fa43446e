// Fused LSTM recurrence for Hopper (sm_90a): the inference forward K1, its
// length-aware variants K2 (ragged) and K3 (ragged, int8 W_hh), the
// training forward K4 and its adjoint K5 (at the end of the file).
//
// K1 replaces the TPU kernel code_intelligence_tpu/ops/pallas_lstm.py::
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
// K4 replaces fused_lstm_forward with with_gates=True (body
// _kernel_with_gates): K1, plus each step also stores the post-activation
// gates i, f, g, o (B, 4H) and the carry c it read (B, H), both rounded to
// the input dtype as the TPU kernel stores them, since K5 recomputes from
// those rounded values. In f32 it is the kGates instantiation of K1's
// template.
//
// In bf16, K1, K2, K3 and K4 are one tensor-core step (lstm_fwd_tc_step,
// at the end of the file) with four epilogues; the CUDA-core template
// below serves them in f32.
//
// K2 replaces fused_lstm_forward_ragged (body _ragged_kernel): K1 plus
// valid_lens (B,) int32 on the device. Row b is live at step t while
// t < valid_lens[b]; a dead row keeps its h and c and writes out[t, b] = 0,
// so h_T, c_T are each row's carry after min(valid, T) steps. The host
// launches only the first t_live steps (t_live >= max(valid_lens), given by
// the caller, which knows the lengths on the host: reading valid_lens back
// would sync every layer) and zero-fills out[t_live:]. Inside a step, a
// block whose batch rows are all dead skips the product, the counterpart
// of the TPU kernel's exhausted-tile skip.
//
// K3 replaces fused_lstm_forward_ragged_int8 (body _ragged_kernel_int8): K2
// with W_hh as int8 codes (4H, H) and an f32 scale per output row (4H,).
// The codes are widened in registers (to f32 on the CUDA cores, to bf16,
// exactly, for the tensor cores), sum(h[k] * q[j, k]) is taken in f32, and
// the row's scale multiplies that sum before x_proj is added, as the TPU
// kernel does; no dequantized W_hh exists anywhere.
//
// What bounds them on an H100: every step needs all of W_hh (4H*H elements:
// 50 MB in bf16, 100 MB in f32 and 25 MB in int8 at H=2500) against the
// previous step's h. That is more than the card's shared memory (~30 MB
// over 132 SMs) and as large as its 50 MB L2, so the TPU kernel's trick of
// keeping W_hh resident on chip for the whole sequence does not carry
// over: each step streams W_hh again, and a step can take no less than
// 4H*H*itemsize / 3.35 TB/s (about 15 us in bf16 at H=2500). The step's
// 2*B*4H*H FLOPs (1.6 GFLOP at B=32) would take under 2 us on the tensor
// cores; these kernels do them as f32 FMAs on the CUDA cores (67 TFLOP/s),
// where they need at least 24 us, so at B=32 the FMAs, not the bytes, set
// their floor.
//
// Design, simple first (one template serves the CUDA-core K1-K4):
//  * One launch per time step; the host loop enqueues the launches on the
//    caller's stream, which orders the steps. K1 reads h_{t-1} back from
//    out[t-1]; K2 and K3 write zeros there for dead rows, so they carry h
//    in its own buffer. Carries ping-pong between a scratch buffer and
//    h_T / c_T, so the last step lands in h_T / c_T.
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
//    An int8 row of H=2500 is 4-byte but not 16-byte aligned, so K3's
//    vector load is 4 codes (one char4).
//  * Batch tiles are the fastest-varying block index, so the blocks that
//    read the same W_hh rows run together and the second read hits L2.
//  These serve f32 activations; in bf16, K1-K5 do their product on the
//  tensor cores (end of the file).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

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
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

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

// Four consecutive elements as f32, in one 4-byte (int8) or 16-byte (f32)
// load; p is 4-element aligned.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const int8_t* p, float (&v)[4]) {
  const char4 q = *reinterpret_cast<const char4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
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
// T is the activation type (f32), W the weight type (T for K1 and K2,
// int8_t for K3). kRagged (K2, K3) adds the per-row freeze at step t and
// the h carry.
template <typename T, typename W, bool kVec, bool kRagged, bool kGates>
__global__ void __launch_bounds__(kThreads)
lstm_step(const T* __restrict__ x_proj,   // (B, 4H), this step
          const W* __restrict__ w_hh,     // (4H, H)
          const float* __restrict__ w_scale,  // (4H,), int8 W only
          const int* __restrict__ valid,  // (B,), kRagged only
          int t,                          // this step, kRagged only
          const T* __restrict__ h_prev,   // (B, H)
          const T* __restrict__ c_prev,   // (B, H)
          T* __restrict__ h_out,          // (B, H): out[t] for K1, else carry
          T* __restrict__ c_out,          // (B, H)
          T* __restrict__ h_last,         // K1: (B, H) on the last step, else null
          T* __restrict__ y_out,          // kRagged: (B, H), out[t]
          T* __restrict__ gates_out,      // kGates: (B, 4H), gates[t]
          T* __restrict__ c_seq_out,      // kGates: (B, H), c_prev[t]
          int B, int H) {
  constexpr bool kInt8 = std::is_same<W, int8_t>::value;
  __shared__ __align__(16) float hs[kBatchTile][kChunk];
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.y * kUnits + (threadIdx.x >> 5);
  const int b0 = blockIdx.x * kBatchTile;
  const bool active = j < H;

  // A tile whose rows are all past their valid length does no product; the
  // flag is the same for every thread of the block, so the barriers in the
  // loops below stay uniform.
  bool tile_live = true;
  if constexpr (kRagged) {
    const int b = b0 + (int)threadIdx.x;
    tile_live = __syncthreads_or(threadIdx.x < kBatchTile && b < B &&
                                 t < valid[b]) != 0;
  }

  float acc[4][kBatchTile];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int bb = 0; bb < kBatchTile; ++bb) acc[g][bb] = 0.0f;

  const size_t HH = (size_t)H * H;
  const W* w_row = w_hh + (size_t)(active ? j : 0) * H;  // gate i row

  if (!tile_live) {
    // every row of the tile is frozen this step: no product
  } else if constexpr (kVec) {
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

  if (tile_live) {
    // Reduce-scatter across the warp: at each offset a lane keeps half of
    // its batch rows and adds its partner's partial sums for them, so the
    // values halve each level (64 shuffles in all). Afterwards lanes 2*bb
    // and 2*bb+1 hold the totals of batch row bb, and the 16 rows finish in
    // parallel.
    halve_rows<16>(acc, lane);
    halve_rows<8>(acc, lane);
    halve_rows<4>(acc, lane);
    halve_rows<2>(acc, lane);
#pragma unroll
    for (int g = 0; g < 4; ++g)
      acc[g][0] += __shfl_xor_sync(0xffffffffu, acc[g][0], 1);
  }

  const int b = b0 + (lane >> 1);
  if ((lane & 1) || b >= B) return;
  const size_t at = (size_t)b * H + j;
  if constexpr (kRagged) {
    if (t >= valid[b]) {  // dead row: the carry stays, the output is 0
      h_out[at] = h_prev[at];
      c_out[at] = c_prev[at];
      y_out[at] = from_f32<T>(0.0f);
      return;
    }
  }
  float dot[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    dot[g] = acc[g][0];
    // per output row: (h . q_row) * scale, as the TPU kernel scales its
    // accumulator after the product
    if constexpr (kInt8) dot[g] *= w_scale[g * H + j];
  }
  const T* xp = x_proj + (size_t)b * 4 * H;
  const float ig = sigmoid(to_f32(xp[j]) + dot[0]);
  const float fg = sigmoid(to_f32(xp[H + j]) + dot[1]);
  const float gg = tanhf(to_f32(xp[2 * H + j]) + dot[2]);
  const float og = sigmoid(to_f32(xp[3 * H + j]) + dot[3]);
  const float c = fg * to_f32(c_prev[at]) + ig * gg;
  const T h = from_f32<T>(og * tanhf(c));
  if constexpr (kGates) {  // K4's residuals, rounded to T as K5 reads them
    T* gt = gates_out + (size_t)b * 4 * H;
    gt[j] = from_f32<T>(ig);
    gt[H + j] = from_f32<T>(fg);
    gt[2 * H + j] = from_f32<T>(gg);
    gt[3 * H + j] = from_f32<T>(og);
    c_seq_out[at] = c_prev[at];  // the carry as stored, before this step
  }
  h_out[at] = h;
  c_out[at] = from_f32<T>(c);
  if constexpr (kRagged) {
    y_out[at] = h;
  } else {
    if (h_last != nullptr) h_last[at] = h;
  }
}

// K1 (kGates false) and K4 (kGates true: gates and c_seq are (T, B, 4H)
// and (T, B, H) outputs).
template <typename T, bool kGates>
int run(const void* x_proj, const void* w_hh, const void* h0, const void* c0,
        void* out, void* gates, void* c_seq, void* h_t, void* c_t,
        void* c_scratch, int T_len, int B, int H, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x_proj);
  T* o = static_cast<T*>(out);
  const size_t BH = (size_t)B * H;
  const dim3 grid((B + kBatchTile - 1) / kBatchTile, (H + kUnits - 1) / kUnits);
  const auto step = H % 4 == 0 ? lstm_step<T, T, true, false, kGates>
                               : lstm_step<T, T, false, false, kGates>;
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
    T* gates_t = kGates ? static_cast<T*>(gates) + (size_t)t * 4 * BH
                        : nullptr;
    T* c_seq_t = kGates ? static_cast<T*>(c_seq) + (size_t)t * BH : nullptr;
    step<<<grid, kThreads, 0, stream>>>(
        xp + (size_t)t * 4 * BH, static_cast<const T*>(w_hh), nullptr,
        nullptr, t, hp, cp, o + (size_t)t * BH, c_after(t), h_last, nullptr,
        gates_t, c_seq_t, B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// What K2 and K3 do around their t_live launches: the dead tail of out is
// zero-filled, and with t_live = 0 the carry is h0, c0 (*done: no step runs).
template <typename T>
cudaError_t ragged_prologue(void* out, const void* h0, const void* c0,
                            void* h_t, void* c_t, int T_len, int t_live,
                            size_t BH, cudaStream_t stream, bool* done) {
  cudaError_t err = cudaSuccess;
  *done = t_live == 0;
  if (t_live < T_len)
    err = cudaMemsetAsync(static_cast<T*>(out) + (size_t)t_live * BH, 0,
                          (size_t)(T_len - t_live) * BH * sizeof(T), stream);
  if (err == cudaSuccess && *done)
    err = cudaMemcpyAsync(h_t, h0, BH * sizeof(T), cudaMemcpyDeviceToDevice,
                          stream);
  if (err == cudaSuccess && *done)
    err = cudaMemcpyAsync(c_t, c0, BH * sizeof(T), cudaMemcpyDeviceToDevice,
                          stream);
  return err;
}

// K2 (W = T) and K3 (W = int8_t) in f32: t_live launches.
template <typename T, typename W>
int run_ragged(const void* x_proj, const void* w_hh, const float* w_scale,
               const int* valid, const void* h0, const void* c0, void* out,
               void* h_t, void* c_t, void* h_scratch, void* c_scratch,
               int T_len, int t_live, int B, int H, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x_proj);
  T* o = static_cast<T*>(out);
  const size_t BH = (size_t)B * H;
  bool done = false;
  cudaError_t err = ragged_prologue<T>(out, h0, c0, h_t, c_t, T_len, t_live,
                                       BH, stream, &done);
  if (err != cudaSuccess || done) return (int)err;
  const dim3 grid((B + kBatchTile - 1) / kBatchTile, (H + kUnits - 1) / kUnits);
  const auto step = H % 4 == 0 ? lstm_step<T, W, true, true, false>
                               : lstm_step<T, W, false, true, false>;
  // the carry after step t: h_T / c_T when (t_live-1-t) is even, else the
  // scratch, so the last live step writes h_T / c_T
  auto after = [&](int t, void* last, void* scratch) -> T* {
    return static_cast<T*>(((t_live - 1 - t) % 2 == 0) ? last : scratch);
  };
  for (int t = 0; t < t_live; ++t) {
    const T* hp = t == 0 ? static_cast<const T*>(h0)
                         : after(t - 1, h_t, h_scratch);
    const T* cp = t == 0 ? static_cast<const T*>(c0)
                         : after(t - 1, c_t, c_scratch);
    step<<<grid, kThreads, 0, stream>>>(
        xp + (size_t)t * 4 * BH, static_cast<const W*>(w_hh), w_scale, valid,
        t, hp, cp, after(t, h_t, h_scratch), after(t, c_t, c_scratch),
        nullptr, o + (size_t)t * BH, nullptr, nullptr, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K5: the LSTM adjoint over a window, in reverse time.
//
// Replaces code_intelligence_tpu/ops/pallas_lstm.py::fused_lstm_backward
// (body _bwd_kernel). With the f32 carry (dh, dc) = (dh_T, dc_T), for
// t = T-1 down to 0:
//
//   i, f, g, o = gates[t] ; c = f * c_prev[t] + i * g (recomputed)
//   dh += d_out[t] ; dc += dh * o * (1 - tanh(c)^2)
//   dz[t] = (dc*g*i*(1-i), dc*c_prev*f*(1-f), dc*i*(1-g^2),
//            dh*tanh(c)*o*(1-o)), stored in T
//   dh = dz[t] @ W_hh (dz as stored, f32 sums) ; dc = dc * f
//
// and dh0, dc0 are the final carry in T. What bounds it is what bounds K1:
// every step's product needs all of W_hh (4H*H elements) against dz[t].
//
// Design of the f32 path (bf16 runs lstm_bwd_tc_step, below), simple
// first. The product of step t needs all of dz[t], which
// every block writes a part of, so a step ends with its launch: one launch
// per step. A block owns kBwdCols consecutive columns j of the row-major
// W_hh and kBwdRows batch rows. In one launch it computes
// dh[:, j] = dz[t+1] @ W_hh[:, j] for its tile (lanes on consecutive j, so
// each W_hh row is read coalesced; the 4H sum is split over the block's
// warps and added in shared memory; dz is staged in shared memory and read
// as a broadcast), and then, with those dh values, finishes the
// element-wise adjoint of step t for the same (b, j): the four dz[t]
// entries at j, H+j, 2H+j, 3H+j, and its dc, which only this thread reads
// and writes, in place in an f32 buffer. The first launch has no product
// (dh = dh_T) and the last has no element-wise step (it writes dh0, dc0),
// so a window takes T + 1 launches.

constexpr int kBwdCols = 32;                 // W_hh columns per block
constexpr int kBwdWarps = 8;                 // warps splitting the 4H sum
constexpr int kBwdThreads = kBwdWarps * 32;
constexpr int kBwdRows = 16;                 // batch rows per block
constexpr int kBwdChunk = kBwdWarps * 32;    // dz columns staged at a time

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
lstm_bwd_step(const T* __restrict__ dz_next,  // (B, 4H) dz[t+1], or null
              const T* __restrict__ w_hh,     // (4H, H)
              const T* __restrict__ dh_init,  // (B, H) dh_T, when no dz_next
              const T* __restrict__ gates,    // (B, 4H) gates[t], or null
              const T* __restrict__ c_prev,   // (B, H) c_prev[t]
              const T* __restrict__ d_out,    // (B, H) d_out[t]
              float* __restrict__ dc,         // (B, H) f32 carry, in place
              T* __restrict__ dz_out,         // (B, 4H) dz[t]
              T* __restrict__ dh0,            // (B, H), when no gates
              T* __restrict__ dc0,            // (B, H), when no gates
              int B, int H) {
  __shared__ float zs[kBwdRows][kBwdChunk];
  __shared__ float red[kBwdWarps][kBwdRows][kBwdCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = blockIdx.y * kBwdCols, b0 = blockIdx.x * kBwdRows;
  const int j = j0 + lane;
  const int G = 4 * H;

  if (dz_next != nullptr) {  // the same for the whole block
    float acc[kBwdRows];
#pragma unroll
    for (int bb = 0; bb < kBwdRows; ++bb) acc[bb] = 0.0f;
    for (int r0 = 0; r0 < G; r0 += kBwdChunk) {
      __syncthreads();  // the previous chunk is consumed
      for (int i = threadIdx.x; i < kBwdRows * kBwdChunk; i += kBwdThreads) {
        const int bb = i / kBwdChunk, rr = i % kBwdChunk;
        const int b = b0 + bb, r = r0 + rr;
        zs[bb][rr] = (b < B && r < G) ? to_f32(dz_next[(size_t)b * G + r])
                                      : 0.0f;
      }
      __syncthreads();
      // warp w takes rows r0 + 32w .. +31: all 32 W_hh loads first
      const int rbase = r0 + warp * 32;
      float w[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int r = rbase + k;
        w[k] = (j < H && r < G) ? to_f32(w_hh[(size_t)r * H + j]) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 32; ++k)
#pragma unroll
        for (int bb = 0; bb < kBwdRows; ++bb)
          acc[bb] = fmaf(zs[bb][warp * 32 + k], w[k], acc[bb]);
    }
#pragma unroll
    for (int bb = 0; bb < kBwdRows; ++bb) red[warp][bb][lane] = acc[bb];
    __syncthreads();
  }

  // element-wise part: consecutive threads on consecutive columns
  for (int p = threadIdx.x; p < kBwdRows * kBwdCols; p += kBwdThreads) {
    const int bb = p / kBwdCols, jj = p % kBwdCols;
    const int b = b0 + bb, jx = j0 + jj;
    if (b >= B || jx >= H) continue;
    const size_t at = (size_t)b * H + jx;
    float dh;
    if (dz_next != nullptr) {
      dh = 0.0f;
#pragma unroll
      for (int w = 0; w < kBwdWarps; ++w) dh += red[w][bb][jj];
    } else {
      dh = to_f32(dh_init[at]);
    }
    if (gates == nullptr) {  // past step 0: the carry is dh0, dc0
      dh0[at] = from_f32<T>(dh);
      dc0[at] = from_f32<T>(dc[at]);
      continue;
    }
    const T* g = gates + (size_t)b * G;
    const float i_t = to_f32(g[jx]), f_t = to_f32(g[H + jx]);
    const float g_t = to_f32(g[2 * H + jx]), o_t = to_f32(g[3 * H + jx]);
    const float cp = to_f32(c_prev[at]);
    const float tanh_c = tanhf(f_t * cp + i_t * g_t);
    dh += to_f32(d_out[at]);
    const float d_o = dh * tanh_c;
    const float dcv = dc[at] + dh * o_t * (1.0f - tanh_c * tanh_c);
    T* z = dz_out + (size_t)b * G;
    z[jx] = from_f32<T>((dcv * g_t) * i_t * (1.0f - i_t));
    z[H + jx] = from_f32<T>((dcv * cp) * f_t * (1.0f - f_t));
    z[2 * H + jx] = from_f32<T>((dcv * i_t) * (1.0f - g_t * g_t));
    z[3 * H + jx] = from_f32<T>(d_o * o_t * (1.0f - o_t));
    dc[at] = dcv * f_t;
  }
}

template <typename T>
int run_bwd(const void* gates, const void* c_seq, const void* d_out,
            const void* w_hh, const void* dh_t, float* dc, void* dz,
            void* dh0, void* dc0, int T_len, int B, int H,
            cudaStream_t stream) {
  const size_t BH = (size_t)B * H, BG = 4 * BH;
  const T* gs = static_cast<const T*>(gates);
  const T* cs = static_cast<const T*>(c_seq);
  const T* dout = static_cast<const T*>(d_out);
  T* z = static_cast<T*>(dz);
  const dim3 grid((B + kBwdRows - 1) / kBwdRows,
                  (H + kBwdCols - 1) / kBwdCols);
  // launch s: the product of dz[s] (none for s = T), then step t = s - 1
  for (int s = T_len; s >= 0; --s) {
    const int t = s - 1;
    const bool last = s == 0;
    lstm_bwd_step<T><<<grid, kBwdThreads, 0, stream>>>(
        s == T_len ? nullptr : z + s * BG, static_cast<const T*>(w_hh),
        static_cast<const T*>(dh_t), last ? nullptr : gs + t * BG,
        last ? nullptr : cs + t * BH, last ? nullptr : dout + t * BH, dc,
        last ? nullptr : z + t * BG, static_cast<T*>(dh0),
        static_cast<T*>(dc0), B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K1-K5 in bf16 on the tensor cores.
//
// What bounded the CUDA-core versions above at the training shape (T=67,
// B=104, H=2500): each step's product, 2*B*4H*H = 5.2 GFLOP, ran as f32
// FMAs (>= 78 us a step at 67 TFLOP/s), and K5's 7 batch tiles each
// streamed all of W_hh, so it was read 7 times a step. Here a block owns a
// tile of W_hh's rows (K1, K2, K4) or columns (K5) for every batch row at
// once, with the batch as the MMA's N dimension, so W_hh is read once a
// step, and the product runs as mma.sync.m16n8k16 (bf16 in, f32
// accumulate: the operands and sums of the TPU kernel's jnp.dot with
// preferred_element_type=f32; only the order of the sum differs). The
// floor of a step is then streaming W_hh (50 MB at H=2500, ~15 us at
// 3.35 TB/s); the product itself needs ~5 us of the tensor cores at B=104.
//
// mma.sync and cp.async, not wgmma and TMA: a step is short, the tile is
// what wgmma would take too, and mma.sync's register fragments need no
// descriptors. Measured on an H100 80GB HBM3 (700 W), a K4 step at B=8,
// with almost no MMA work, still took ~2/3 of a step at B=104: what
// remains is latency (launch, the pipeline's fill, the epilogue), not the
// MMA issue.
//
// Layout. A bf16 row of H=2500 is 5000 bytes, which is not 16-byte aligned,
// and 2500 is not a multiple of the MMA's K of 16. So W_hh is packed into a
// copy whose rows have a leading dimension Hp (a multiple of kTcK,
// zero-filled past H), ordered for the kernel (ops/fused_lstm.py:
// tc_layout, pack_w_hh_fwd, pack_w_hh_bwd): K4 and K5 pack it per call,
// the serve path once per loaded model (models/awd_lstm.py). The kernels
// keep their own recurrent operand (h, or K5's dz) in zero-padded (B, Hp)
// / (B, 4*Hp) scratches, two of each, written by the epilogue of one step
// and read by the next. Every cp.async is then 16 bytes on a 16-byte
// boundary, and batch rows past B are zero-filled in shared memory.
//
// The block: one per SM (the grids below fit the H100's 132 SMs at
// H=2500), so its ring can be deep: 6 stages of 64-wide K slices of both
// operands, ~50 KB of W_hh in flight per SM, as streaming at the HBM rate
// needs. A warp per 16-row slice of the tile and half of each stage's k16
// steps (kKSplit), over the block's batch rows (K4's tile: 14 n8 tiles, up
// to 112 rows; the grid's z covers more). Fragments come from shared
// memory by ldmatrix (rows padded to 72 elements, so the 8 row addresses of
// an 8x8 matrix hit distinct banks), the next k16 step's while the current
// one's MMAs run. The f32 sums go to shared memory as [batch][row]; the
// element-wise step then runs from there, fused as before, each thread
// issuing all its global loads before any arithmetic (one element at a
// time, their latencies added up).
//
// The forward step (lstm_fwd_tc_step): gates^T = W_hh . h_{t-1}^T. A block
// owns kRows/4 hidden units, i.e. the W_hh rows j, H+j, 2H+j, 3H+j of each,
// packed contiguously, so the tile holds all four gates of its units and
// the cell update needs no second pass. K is H: ceil(4H/kRows) blocks (125
// at H=2500, 40 at H=800, with 80 rows). Its epilogue makes it one of
// four kernels (FwdKind):
//  * K4 stores out[t], h into the next scratch, c, and the residuals,
//    rounded where the CUDA-core K4 rounds them;
//  * K1 stores out[t], h and c only;
//  * K2 reads valid_lens: a dead row (t >= valid[b]) writes out[t, b] = 0
//    and carries its h (into the next scratch too) and c over unchanged.
//    An n8 batch tile whose 8 rows are all dead gets no MMAs and is not
//    staged, and a block with no live row skips its product, W_hh
//    included: the counterpart of the TPU kernel's exhausted-tile skip.
//    The host launches only t_live steps, as for the CUDA-core K2.
//  * K3 is K2 on int8 codes: the f32 sum of W_hh row r is scaled by
//    scale[r] before x_proj is added. Its weight operand is a Tile
//    parameter (kQCopy), so no other kernel runs any of what follows. The
//    codes are read where they lie in the row-major (4H, H) W_hh, in the
//    pack's row order, with no padded copy. A row of H=2500 starts 4, 8
//    or 12 bytes past a 16-byte boundary, so for even H a stage copies the
//    five aligned 16-byte chunks around each row's 64 columns by cp.async
//    (four where the row is aligned, as every row is at H=800) and the
//    fragment reads skip the row's offset; 4-byte copies, measured first,
//    took 1.7x as long at H=2500 (PERF.md). Odd H takes ordinary loads. Both
//    zero-fill past H (the host picks the way from H). A stage of codes is
//    under half a bf16 stage's bytes; the ring keeps K2's depth. Each warp
//    widens its A fragment's codes to bf16 in registers between the 2-byte
//    shared reads and the MMA: every code in [-127, 127] is a bf16
//    integer, so the product is the TPU kernel's (h in bf16 times the
//    codes, f32 sums) up to the order of the sum. h is not quantized.
// K4 always takes the 112-row tile above. K1, K2 and K3 take it above
// kTcServeBatch batch rows (the B=104 validation window) and the serve
// tile (kTcServe*) at or below: 32 batch rows, serving's batch
// (inference/engine.py), so its ring stages, accumulators and epilogue are
// sized for 4 n8 tiles and not 14.
//
// K5 (lstm_bwd_tc_step): dh^T = W_hh^T . dz[t+1]^T. A block owns 96 hidden
// units j; the 4H sum is split over a cluster of 4 blocks, one per gate
// slab of W_hh, and each block adds the four partials of a quarter of the
// batch rows through distributed shared memory before its element-wise
// step: 4 * ceil(H/96) blocks (108 at H=2500, 36 at H=800). With 80 units
// (128 blocks) a call took 1.8x as long: a cluster's blocks must share a
// GPC, and not all 32 clusters of one-block SMs were resident at once.
// scripts/torch_lstm_tc_sweep.py rebuilds this file with other tiles.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
namespace cg = cooperative_groups;

constexpr int kTcBatch = 112;    // batch rows per block: 14 n8 tiles
constexpr int kTcK = 64;         // K per pipeline stage
constexpr int kTcStages = 6;
constexpr int kTcKSplit = 2;     // warps splitting a stage's k16 steps
constexpr int kTcLd = kTcK + 8;  // shared row stride, bf16 elements
// K3's shared row stride of int8 codes, in bytes: five 16-byte chunks, and
// the 8 rows of an A fragment's 2-byte reads, 20 words apart, hit
// distinct banks (the rows' shifts make some of them share one)
constexpr int kTcQLd = kTcK + 16;
constexpr int kTcCluster = 4;    // K5: one block per gate slab
constexpr int kTcFwdRows = 80;   // K4: 20 hidden units x 4 gates
constexpr int kTcBwdRows = 96;   // K5: hidden units
// K1, K2 and K3 at B <= kTcServeBatch
constexpr int kTcServeBatch = 32;  // 4 n8 tiles
constexpr int kTcServeRows = 80;   // W_hh rows: 20 hidden units x 4 gates
constexpr int kTcServeStages = 6;
constexpr int kTcServeKSplit = 2;

// A block's tile: kRows rows (the forward step: W_hh rows, K5: its
// columns) times up to kBatch batch rows, K in kStages-deep slices of
// kTcK; a warp per 16-row slice and share (one of kKSplit) of the k16
// steps. kQCopy (K3 only): the weight rows are int8 codes, copied in
// aligned 16-byte chunks (kQCopy 16, even H) or a byte at a time by
// ordinary loads (1, odd H); 0: a bf16 pack.
template <int kRows_, int kBatch_, int kStages_, int kKSplit_,
          int kQCopy_ = 0>
struct Tile {
  static constexpr int kRows = kRows_, kBatch = kBatch_;
  static constexpr int kStages = kStages_, kKSplit = kKSplit_;
  static constexpr int kQCopy = kQCopy_;
  using Weight = typename std::conditional<kQCopy != 0, int8_t, bf16>::type;
  static_assert(kQCopy == 0 || kQCopy == 1 || kQCopy == 16,
                "16-byte cp.async chunks, or ordinary loads");
  static_assert(kRows % 16 == 0, "16-row warp slices");
  static_assert(kBatch % 16 == 0 && kBatch <= 128,
                "pairs of n8 tiles, a bit each in a 16-bit mask");
  static_assert((kTcK / 16) % kKSplit == 0, "k16 steps split evenly");
  static constexpr int kThreads = kRows / 16 * kKSplit * 32;
  static constexpr int kRedLd = kRows + 4;  // f32 stride of sums [batch][row]
  static constexpr int kSumElems = kBatch * kRedLd;  // one K split's sums
  // a stage, in bf16 elements: the weight rows (K3: kTcQLd bytes each),
  // then the batch rows
  static constexpr int kAElems = kRows * (kQCopy ? kTcQLd / 2 : kTcLd);
  static constexpr int kStageElems = kAElems + kBatch * kTcLd;
  static constexpr int kSmem = kStages * kStageElems * (int)sizeof(bf16);
  static_assert(kKSplit * kSumElems * 4 <= kSmem, "the sums reuse the ring");
};
using FwdTile = Tile<kTcFwdRows, kTcBatch, kTcStages, kTcKSplit>;
using BwdTile = Tile<kTcBwdRows, kTcBatch, kTcStages, kTcKSplit>;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared: the first n (<= 16) bytes of src, zero past
// them (with n = 0, src is not read)
__device__ __forceinline__ void cp_async16_n(unsigned dst, const void* src,
                                             int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

// 16 bytes global -> shared; zero-filled when !live (src is then not read)
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool live) {
  cp_async16_n(dst, src, live ? 16 : 0);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two int8 codes from shared memory (the lower column in the low byte) as a
// bf16 pair, exactly: a code c becomes the f32 2^23 + 128 + c by its bits,
// less 2^23 + 128, and an integer of 8 bits' magnitude is the upper half
// of its f32.
__device__ __forceinline__ unsigned widen2(const unsigned char* p) {
  const unsigned v = *reinterpret_cast<const unsigned short*>(p) ^ 0x8080u;
  const float lo = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440));
  const float hi = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7441));
  return __byte_perm(__float_as_uint(lo - 8388736.0f),
                     __float_as_uint(hi - 8388736.0f), 0x7632);
}

// K3 reads W_hh where it lies: the row-major (4H, H) int8 codes (lda = H).
// Tile row r = g * n + jj (n = kRows / 4 units) is W_hh row g * H + u0 +
// jj, and `a` points at row u0.
template <class Tl>
__device__ __forceinline__ const int8_t* code_row(const int8_t* a,
                                                  size_t lda, int r) {
  constexpr int kN = Tl::kRows / 4;
  return a + ((r / kN) * lda + r % kN) * lda;
}

// Where column k0 + k of a row lands in its shared row: at k plus the row's
// offset from a 16-byte boundary, which the chunks copy along (1: ordinary
// loads land it at k).
template <class Tl>
__device__ __forceinline__ int code_shift(const int8_t* row) {
  return Tl::kQCopy == 16 ? (int)(reinterpret_cast<uintptr_t>(row) & 15) : 0;
}

// The codes of the stage at K offset k0: per row, the aligned 16-byte
// chunks that hold its columns k0 .. k0 + 63 (five, or four for a row on
// a boundary), or those 64 bytes one at a time. Rows with jj >= q_units
// and columns past H are zero-filled; a chunk reads no byte past its row.
template <class Tl>
__device__ __forceinline__ void stage_codes(unsigned char* sa,
                                            const int8_t* __restrict__ a,
                                            size_t lda, int q_units, int k0) {
  constexpr int kN = Tl::kRows / 4;
  constexpr int kChunks = Tl::kQCopy == 16 ? kTcK / 16 + 1 : kTcK;
  const int H = (int)lda;
  for (int i = threadIdx.x; i < Tl::kRows * kChunks; i += Tl::kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool on = r % kN < q_units;
    const int8_t* row = code_row<Tl>(a, lda, r);
    if constexpr (Tl::kQCopy == 16) {
      const int o = code_shift<Tl>(row);
      const int k = k0 - o + 16 * c;  // the chunk's first column
      const int n = on && (o != 0 || c < kChunks - 1)
                        ? min(max(H - k, 0), 16) : 0;
      cp_async16_n(smem_addr(sa + r * kTcQLd + 16 * c), n ? row + k : a, n);
    } else {
      sa[r * kTcQLd + c] =
          on && k0 + c < H ? static_cast<unsigned char>(row[k0 + c]) : 0;
    }
  }
}

// sums[n][m] = sum over k < n_k * kTcK of a[m][k] * b[n][k], for the tile's
// kRows rows m of a (row stride lda; K3: the codes, see stage_codes) and
// the nb rows n of b (row stride ldb), written to `sums` (stride kRedLd,
// aliasing `ring`) as kKSplit partial sums kSumElems apart (tc_sum adds
// them). Both n8 tiles of every
// pair that holds a row are computed (rows past nb are zero-filled). With
// kMask (K2, K3) only the n8 tiles marked in `live` are (bit i: rows 8i ..
// 8i+7): an unmarked tile gets no MMAs and no sums, a pair of them is not
// staged, and with no tile marked nothing is read at all. Called by every
// thread of the block with the same `live`; ends with the sums visible to
// the block.
template <class Tl, bool kMask = false>
__device__ __forceinline__ void tc_product(
    const typename Tl::Weight* __restrict__ a, size_t lda,
    const bf16* __restrict__ b, size_t ldb, int nb, unsigned live, int n_k,
    bf16* ring, float* sums, int q_units = 0) {
  if (kMask && live == 0) return;
  constexpr int kRows = Tl::kRows, kPairs = Tl::kBatch / 16;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = (tid >> 5) % (kRows / 16);  // the warp's 16-row slice
  const int split = (tid >> 5) / (kRows / 16);  // its share of each stage
  constexpr int kSteps = kTcK / 16 / Tl::kKSplit;  // k16 steps per stage
  // pairs of n8 tiles staged: those that hold rows, or up to the last
  // marked tile
  const int n_pairs = kMask ? (33 - __clz(live)) / 2 : (nb + 15) / 16;
  int o_lo = 0, o_hi = 0;  // K3: the shifts of the warp's rows g, g + 8
  if constexpr (Tl::kQCopy != 0) {
    const int g = warp * 16 + (lane >> 2);
    o_lo = code_shift<Tl>(code_row<Tl>(a, lda, g));
    o_hi = code_shift<Tl>(code_row<Tl>(a, lda, g + 8)) + 8 * kTcQLd;
  }
  auto tile_on = [&](int nt) { return !kMask || ((live >> nt) & 1u); };
  auto pair_on = [&](int p) {  // the same for the whole block
    return kMask ? ((live >> (2 * p)) & 3u) != 0 : p < n_pairs;
  };
  auto load = [&](int slot, int kt) {
    bf16* sa = ring + slot * Tl::kStageElems;
    bf16* sb = sa + Tl::kAElems;
    const int k0 = kt * kTcK;
    constexpr int kChunks = kTcK / 8;  // 16-byte chunks per bf16 row
    if constexpr (Tl::kQCopy != 0) {
      stage_codes<Tl>(reinterpret_cast<unsigned char*>(sa), a, lda, q_units,
                      k0);
    } else {
      for (int i = tid; i < kRows * kChunks; i += Tl::kThreads) {
        const int r = i / kChunks, c = (i % kChunks) * 8;
        cp_async16(smem_addr(sa + r * kTcLd + c), a + r * lda + k0 + c, true);
      }
    }
    for (int i = tid; i < n_pairs * 16 * kChunks; i += Tl::kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool row = r < nb && tile_on(r >> 3);
      cp_async16(smem_addr(sb + r * kTcLd + c),
                 b + (row ? r : 0) * ldb + k0 + c, row);
    }
  };
  float acc[Tl::kBatch / 8][4];
#pragma unroll
  for (int nt = 0; nt < Tl::kBatch / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;

  for (int s = 0; s < Tl::kStages - 1; ++s) {
    if (s < n_k) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<Tl::kStages - 2>();  // slice kt has landed
    __syncthreads();                   // and every warp is done with kt - 1
    const int next = kt + Tl::kStages - 1;
    if (next < n_k) load(next % Tl::kStages, next);
    cp_async_commit();
    const bf16* sa = ring + (kt % Tl::kStages) * Tl::kStageElems;
    const bf16* sb = sa + Tl::kAElems;
    // Fragments of k16 step kk: a (rows warp*16 .. +15) and, for each pair
    // p of n8 tiles, b0 and b1 of tiles 2p and 2p + 1. The asm statements
    // keep their order, so step kk + 1's loads are written before step
    // kk's MMAs: they are in flight while the tensor cores work.
    unsigned af[2][4], bfr[2][kPairs][4];
    auto load_frags = [&](int kk, unsigned (&fa)[4],
                          unsigned (&fb)[kPairs][4]) {
      if constexpr (Tl::kQCopy != 0) {  // rows g, g + 8; columns 2t, 2t + 8
        const unsigned char* q = reinterpret_cast<const unsigned char*>(sa) +
                                 (warp * 16 + (lane >> 2)) * kTcQLd +
                                 kk * 16 + 2 * (lane & 3);
        fa[0] = widen2(q + o_lo);
        fa[1] = widen2(q + o_hi);
        fa[2] = widen2(q + o_lo + 8);
        fa[3] = widen2(q + o_hi + 8);
      } else {
        ldmatrix_x4(smem_addr(sa + (warp * 16 + (lane & 15)) * kTcLd +
                              kk * 16 + (lane >> 4) * 8),
                    fa);
      }
#pragma unroll
      for (int p = 0; p < kPairs; ++p)
        if (pair_on(p))
          ldmatrix_x4(smem_addr(sb +
                                (p * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                    kTcLd +
                                kk * 16 + ((lane >> 3) & 1) * 8),
                      fb[p]);
    };
    const int k_first = split * kSteps;
    load_frags(k_first, af[0], bfr[0]);
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      if (kk + 1 < kSteps)
        load_frags(k_first + kk + 1, af[(kk + 1) % 2], bfr[(kk + 1) % 2]);
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
        if (kMask || p < n_pairs) {  // kMask: each tile's own bit below
          if (tile_on(2 * p))
            mma_bf16(acc[2 * p], af[kk % 2], bfr[kk % 2][p][0],
                     bfr[kk % 2][p][1]);
          if (tile_on(2 * p + 1))
            mma_bf16(acc[2 * p + 1], af[kk % 2], bfr[kk % 2][p][2],
                     bfr[kk % 2][p][3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the sums overwrite it
  // accumulator (m, n): c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
  const int m = warp * 16 + (lane >> 2), n = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < Tl::kBatch / 8; ++nt) {
    if (kMask ? tile_on(nt) : nt < 2 * n_pairs) {
      float* s = sums + split * Tl::kSumElems + (nt * 8 + n) * Tl::kRedLd + m;
      s[0] = acc[nt][0];
      s[Tl::kRedLd] = acc[nt][1];
      s[8] = acc[nt][2];
      s[Tl::kRedLd + 8] = acc[nt][3];
    }
  }
  __syncthreads();
}

// The product's sum at index i of `sums`: its K splits added.
template <class Tl>
__device__ __forceinline__ float tc_sum(const float* sums, int i) {
  float v = 0.0f;
#pragma unroll
  for (int s = 0; s < Tl::kKSplit; ++s) v += sums[s * Tl::kSumElems + i];
  return v;
}

enum class FwdKind { kK1, kK2, kK4, kK3 };

// The forward step t on the tensor cores, with K1's, K2's, K3's or K4's
// epilogue. w is the pack (tiles * kRows, Hp): tile u's rows are W_hh rows
// g*H + (kRows/4)*u + jj in order (g, jj), zero past H; for K3, the int8
// W_hh (4H, H) itself, read in that order.
template <class Tl, FwdKind kKind>
__global__ void __launch_bounds__(Tl::kThreads, 1)
lstm_fwd_tc_step(const bf16* __restrict__ x_proj,  // (B, 4H), this step
                 const typename Tl::Weight* __restrict__ w,
                 const float* __restrict__ w_scale,  // K3: (4H,)
                 const int* __restrict__ valid,    // K2, K3: (B,)
                 int t,                            // K2, K3: this step
                 const bf16* __restrict__ h_in,    // (B, Hp) h_{t-1}
                 const bf16* __restrict__ c_prev,  // (B, H)
                 bf16* __restrict__ h_next,        // (B, Hp) h_t
                 bf16* __restrict__ c_out,         // (B, H)
                 bf16* __restrict__ out,           // (B, H) out[t]
                 bf16* __restrict__ h_last,        // (B, H) or null
                 bf16* __restrict__ gates_out,     // K4: (B, 4H)
                 bf16* __restrict__ c_seq_out,     // K4: (B, H)
                 int B, int H, int Hp) {
  constexpr int kUnitsT = Tl::kRows / 4;  // the block's hidden units
  constexpr bool kK3 = kKind == FwdKind::kK3;
  constexpr bool kRag = kKind == FwdKind::kK2 || kK3;
  static_assert(kK3 == (Tl::kQCopy != 0), "K3 alone reads int8 codes");
  static_assert(!kRag || Tl::kThreads >= Tl::kBatch, "a thread per row");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned live_rows[(Tl::kBatch + 31) / 32];  // a bit a row
  float* sums = reinterpret_cast<float*>(smem);
  const int u0 = blockIdx.x * kUnitsT, b0 = blockIdx.y * Tl::kBatch;
  const int nb = min(Tl::kBatch, B - b0);
  unsigned live = 0;  // K2, K3: the n8 tiles with a row live at step t
  if constexpr (kRag) {  // the rows live at step t, and their n8 tiles
    const int r = threadIdx.x;
    const unsigned word =
        __ballot_sync(0xffffffffu, r < nb && t < valid[b0 + r]);
    if ((r & 31) == 0 && r < Tl::kBatch) live_rows[r >> 5] = word;
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < Tl::kBatch / 8; ++nt)
      if ((live_rows[nt >> 2] >> ((nt & 3) * 8)) & 0xffu) live |= 1u << nt;
  }
  auto row_live = [&](int bb) {
    return !kRag || ((live_rows[bb >> 5] >> (bb & 31)) & 1u);
  };
  if constexpr (kK3)
    tc_product<Tl, true>(w + (size_t)u0 * H, H, h_in + (size_t)b0 * Hp, Hp,
                         nb, live, Hp / kTcK, reinterpret_cast<bf16*>(smem),
                         sums, min(kUnitsT, H - u0));
  else
    tc_product<Tl, kRag>(w + (size_t)blockIdx.x * Tl::kRows * Hp, Hp,
                         h_in + (size_t)b0 * Hp, Hp, nb, live, Hp / kTcK,
                         reinterpret_cast<bf16*>(smem), sums);
  // The cell update of the block's (b, j) pairs, kEpi a thread: every
  // global load first, so their latencies overlap, then the arithmetic.
  // A dead K2 or K3 row loads its carry instead: h into pre[e][0], c into
  // cp. K3 scales W_hh row g*H + j's sum by its scale, as the TPU kernel
  // scales the accumulator.
  constexpr int kEpi =
      (Tl::kBatch * kUnitsT + Tl::kThreads - 1) / Tl::kThreads;
  float pre[kEpi][4], cp[kEpi];
#pragma unroll
  for (int e = 0; e < kEpi; ++e) {
    const int p = threadIdx.x + e * Tl::kThreads;
    const int bb = p / kUnitsT, jj = p % kUnitsT, j = u0 + jj;
    if (bb >= nb || j >= H) continue;
    if (!row_live(bb)) {
      pre[e][0] = to_f32(h_in[(size_t)(b0 + bb) * Hp + j]);
      cp[e] = to_f32(c_prev[(size_t)(b0 + bb) * H + j]);
      continue;
    }
    const bf16* xp = x_proj + (size_t)(b0 + bb) * 4 * H + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      float dot = tc_sum<Tl>(sums, bb * Tl::kRedLd + g * kUnitsT + jj);
      if constexpr (kK3) dot *= w_scale[g * H + j];
      pre[e][g] = to_f32(xp[g * H]) + dot;
    }
    cp[e] = to_f32(c_prev[(size_t)(b0 + bb) * H + j]);
  }
#pragma unroll
  for (int e = 0; e < kEpi; ++e) {
    const int p = threadIdx.x + e * Tl::kThreads;
    const int bb = p / kUnitsT, jj = p % kUnitsT, j = u0 + jj;
    if (bb >= nb || j >= H) continue;
    const int b = b0 + bb;
    const size_t at = (size_t)b * H + j;
    if (!row_live(bb)) {  // the carry stays (exact: bf16 -> f32 -> bf16)
      const bf16 h = from_f32<bf16>(pre[e][0]);
      out[at] = from_f32<bf16>(0.0f);
      h_next[(size_t)b * Hp + j] = h;
      c_out[at] = from_f32<bf16>(cp[e]);
      if (h_last != nullptr) h_last[at] = h;
      continue;
    }
    const float ig = sigmoid(pre[e][0]), fg = sigmoid(pre[e][1]);
    const float gg = tanhf(pre[e][2]), og = sigmoid(pre[e][3]);
    const float c = fg * cp[e] + ig * gg;
    const bf16 h = from_f32<bf16>(og * tanhf(c));
    if constexpr (kKind == FwdKind::kK4) {
      bf16* gt = gates_out + (size_t)b * 4 * H + j;  // rounded as K5 reads
      gt[0] = from_f32<bf16>(ig);
      gt[H] = from_f32<bf16>(fg);
      gt[2 * H] = from_f32<bf16>(gg);
      gt[3 * H] = from_f32<bf16>(og);
      c_seq_out[at] = from_f32<bf16>(cp[e]);  // c_prev as stored: exact
    }
    out[at] = h;
    h_next[(size_t)b * Hp + j] = h;
    c_out[at] = from_f32<bf16>(c);
    if (h_last != nullptr) h_last[at] = h;
  }
}

// K5's launch on the tensor cores: the product of dz[t+1] (none when dz_in
// is null: dh = dh_init), then step t's element-wise adjoint (none when
// gates is null: the carry goes to dh0, dc0). w_pack is (bwd tiles *
// kTcBwdRows, 4 * Hp): row j, column g*Hp + k holds W_hh[g*H + k][j], zero
// past H.
__global__ void __cluster_dims__(kTcCluster, 1, 1)
    __launch_bounds__(BwdTile::kThreads, 1)
lstm_bwd_tc_step(const bf16* __restrict__ dz_in,    // (B, 4Hp) dz[t+1]
                 const bf16* __restrict__ w_pack,   // (., 4Hp)
                 const bf16* __restrict__ dh_init,  // (B, H)
                 const bf16* __restrict__ gates,    // (B, 4H) gates[t]
                 const bf16* __restrict__ c_prev,   // (B, H) c_prev[t]
                 const bf16* __restrict__ d_out,    // (B, H) d_out[t]
                 float* __restrict__ dc,            // (B, H) f32, in place
                 bf16* __restrict__ dz_out,         // (B, 4H) dz[t]
                 bf16* __restrict__ dz_next,        // (B, 4Hp) dz[t]
                 bf16* __restrict__ dh0,            // (B, H)
                 bf16* __restrict__ dc0,            // (B, H)
                 int B, int H, int Hp) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sums = reinterpret_cast<float*>(smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int slab = blockIdx.x;  // gate slab of the 4H sum = cluster rank
  const int j0 = blockIdx.y * kTcBwdRows, b0 = blockIdx.z * kTcBatch;
  const int nb = min(kTcBatch, B - b0);
  const int G = 4 * H;
  const size_t ldp = 4 * (size_t)Hp;
  const bool product = dz_in != nullptr;  // the same for the whole grid
  if (product) {
    tc_product<BwdTile>(w_pack + (size_t)j0 * ldp + (size_t)slab * Hp, ldp,
                        dz_in + (size_t)b0 * ldp + (size_t)slab * Hp, ldp, nb,
                        0, Hp / kTcK, reinterpret_cast<bf16*>(smem), sums);
    cluster.sync();  // every slab's partial sums are in place
  }
  // This block finishes a quarter of the batch rows for all its units,
  // kEpi (b, j) pairs a thread: every load first (the four slabs' sums
  // from the cluster's shared memory, and the residuals), then the
  // arithmetic.
  const int q = (nb + kTcCluster - 1) / kTcCluster;
  const int bq0 = slab * q, nq = max(0, min(q, nb - bq0));
  constexpr int kEpi = (kTcBatch / kTcCluster * kTcBwdRows +
                        BwdTile::kThreads - 1) / BwdTile::kThreads;
  static_assert(kTcBatch % kTcCluster == 0, "q <= kTcBatch / kTcCluster");
  float dh[kEpi], gv[kEpi][4], cp[kEpi], dov[kEpi], dcv[kEpi];
#pragma unroll
  for (int e = 0; e < kEpi; ++e) {
    const int p = threadIdx.x + e * BwdTile::kThreads;
    const int bb = bq0 + p / kTcBwdRows, j = j0 + p % kTcBwdRows;
    if (p >= nq * kTcBwdRows || j >= H) continue;
    const size_t at = (size_t)(b0 + bb) * H + j;
    if (product) {
      dh[e] = 0.0f;
#pragma unroll
      for (int r = 0; r < kTcCluster; ++r)
        dh[e] += tc_sum<BwdTile>(cluster.map_shared_rank(sums, r),
                                 bb * BwdTile::kRedLd + p % kTcBwdRows);
    } else {
      dh[e] = to_f32(dh_init[at]);
    }
    dcv[e] = dc[at];
    if (gates == nullptr) continue;
    const bf16* g = gates + (size_t)(b0 + bb) * G + j;
#pragma unroll
    for (int k = 0; k < 4; ++k) gv[e][k] = to_f32(g[k * H]);
    cp[e] = to_f32(c_prev[at]);
    dov[e] = to_f32(d_out[at]);
  }
#pragma unroll
  for (int e = 0; e < kEpi; ++e) {
    const int p = threadIdx.x + e * BwdTile::kThreads;
    const int b = b0 + bq0 + p / kTcBwdRows, j = j0 + p % kTcBwdRows;
    if (p >= nq * kTcBwdRows || j >= H) continue;
    const size_t at = (size_t)b * H + j;
    if (gates == nullptr) {  // past step 0: the carry is dh0, dc0
      dh0[at] = from_f32<bf16>(dh[e]);
      dc0[at] = from_f32<bf16>(dcv[e]);
      continue;
    }
    const float i_t = gv[e][0], f_t = gv[e][1], g_t = gv[e][2], o_t = gv[e][3];
    const float tanh_c = tanhf(f_t * cp[e] + i_t * g_t);
    const float dhv = dh[e] + dov[e];
    const float d_o = dhv * tanh_c;
    const float dcn = dcv[e] + dhv * o_t * (1.0f - tanh_c * tanh_c);
    const bf16 z[4] = {from_f32<bf16>((dcn * g_t) * i_t * (1.0f - i_t)),
                       from_f32<bf16>((dcn * cp[e]) * f_t * (1.0f - f_t)),
                       from_f32<bf16>((dcn * i_t) * (1.0f - g_t * g_t)),
                       from_f32<bf16>(d_o * o_t * (1.0f - o_t))};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      dz_out[(size_t)b * G + k * H + j] = z[k];
      dz_next[(size_t)b * ldp + k * Hp + j] = z[k];
    }
    dc[at] = dcn * f_t;
  }
  if (product) cluster.sync();  // no block leaves while its sums are read
}

// K1-K4 in bf16: n_steps launches (K2, K3: t_live). h_pad is (2, B,
// Hp), zero past H, with h0 in h_pad[0]; step t reads h_pad[t % 2] and
// writes h_pad[(t + 1) % 2], and the last step also h_T. c ping-pongs
// between c_T and c_scratch as in run().
template <class Tl, FwdKind kKind>
int run_fwd_tc(const bf16* xp, const typename Tl::Weight* w,
               const float* w_scale, const int* valid,
               bf16* h_pad, const bf16* c0, bf16* out, bf16* gates,
               bf16* c_seq, bf16* h_t, bf16* c_t, bf16* c_scratch,
               int n_steps, int B, int H, int Hp, dim3 grid,
               cudaStream_t stream) {
  const auto step = lstm_fwd_tc_step<Tl, kKind>;
  cudaError_t err = cudaFuncSetAttribute(
      step, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmem);
  if (err != cudaSuccess) return (int)err;
  const size_t BH = (size_t)B * H, BHp = (size_t)B * Hp;
  constexpr bool kK4 = kKind == FwdKind::kK4;
  auto c_after = [&](int t) {
    return ((n_steps - 1 - t) % 2 == 0) ? c_t : c_scratch;
  };
  for (int t = 0; t < n_steps; ++t) {
    step<<<grid, Tl::kThreads, Tl::kSmem, stream>>>(
        xp + (size_t)t * 4 * BH, w, w_scale, valid, t,
        h_pad + (t % 2) * BHp,
        t == 0 ? c0 : c_after(t - 1), h_pad + ((t + 1) % 2) * BHp,
        c_after(t), out + (size_t)t * BH, t == n_steps - 1 ? h_t : nullptr,
        kK4 ? gates + (size_t)t * 4 * BH : nullptr,
        kK4 ? c_seq + (size_t)t * BH : nullptr, B, H, Hp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// K1, K2 or K3 in bf16 on the tile of `batch` rows that tc_layout chose
// (K3: with its copy width).
template <FwdKind kKind, int kQCopy = 0, typename... Args>
int run_fwd_tc_tile(int batch, Args... args) {
  using Serve = Tile<kTcServeRows, kTcServeBatch, kTcServeStages,
                     kTcServeKSplit, kQCopy>;
  using Fwd = Tile<kTcFwdRows, kTcBatch, kTcStages, kTcKSplit, kQCopy>;
  if (batch == Serve::kBatch) return run_fwd_tc<Serve, kKind>(args...);
  if (batch == Fwd::kBatch) return run_fwd_tc<Fwd, kKind>(args...);
  return (int)cudaErrorInvalidValue;
}

// K5 in bf16: T + 1 launches, as run_bwd. dz_pad is (2, B, 4Hp), zero past
// H in each slab; dz[t] goes to dz_pad[t % 2] beside dz.
int run_bwd_tc(const bf16* gates, const bf16* c_seq, const bf16* d_out,
               const bf16* w_pack, const bf16* dh_t, float* dc, bf16* dz,
               bf16* dz_pad, bf16* dh0, bf16* dc0, int T_len, int B, int H,
               int Hp, dim3 grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bwd_tc_step, cudaFuncAttributeMaxDynamicSharedMemorySize,
      BwdTile::kSmem);
  if (err != cudaSuccess) return (int)err;
  const size_t BH = (size_t)B * H, BG = 4 * BH, BGp = 4 * (size_t)B * Hp;
  for (int s = T_len; s >= 0; --s) {
    const int t = s - 1;
    const bool last = s == 0;
    lstm_bwd_tc_step<<<grid, BwdTile::kThreads, BwdTile::kSmem, stream>>>(
        s == T_len ? nullptr : dz_pad + (s % 2) * BGp, w_pack, dh_t,
        last ? nullptr : gates + t * BG, last ? nullptr : c_seq + t * BH,
        last ? nullptr : d_out + t * BH, dc, last ? nullptr : dz + t * BG,
        last ? nullptr : dz_pad + (t % 2) * BGp, dh0, dc0, B, H, Hp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The bf16 tile constants that ops/fused_lstm.py lays W_hh out for and
// builds the grids from (TC_FWD_ROWS, TC_BWD_ROWS, TC_BATCH, TC_K,
// TC_CLUSTER, TC_SERVE_ROWS, TC_SERVE_BATCH); it checks them against these
// when it loads the library.
void fused_lstm_tc_config(int* out) {
  const int c[7] = {kTcFwdRows, kTcBwdRows, kTcBatch,     kTcK,
                    kTcCluster, kTcServeRows, kTcServeBatch};
  for (int i = 0; i < 7; ++i) out[i] = c[i];
}

// K1. dtype: 0 = float32, 1 = bfloat16; every tensor is a device pointer of
// that dtype, c_scratch (B, H). f32 runs the CUDA-core template on w_hh and
// h0. bf16 runs on the tensor cores and takes w_pack, h_pad (2, B, Hp) with
// h0 in its first half, Hp, the grid and the tile's batch rows, all from
// ops/fused_lstm.py::tc_layout; it reads neither w_hh nor h0. Returns a
// cudaError_t (0 on success). T = 0 is the caller's to handle.
int fused_lstm_forward(int dtype, const void* x_proj, const void* w_hh,
                       const void* w_pack, const void* h0, void* h_pad,
                       const void* c0, void* out, void* h_t, void* c_t,
                       void* c_scratch, int T, int B, int H, int Hp, int gx,
                       int gy, int batch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float, false>(x_proj, w_hh, h0, c0, out, nullptr, nullptr,
                             h_t, c_t, c_scratch, T, B, H, s);
  if (dtype == 1)
    return run_fwd_tc_tile<FwdKind::kK1>(
        batch, static_cast<const bf16*>(x_proj),
        static_cast<const bf16*>(w_pack), static_cast<const float*>(nullptr),
        static_cast<const int*>(nullptr),
        static_cast<bf16*>(h_pad), static_cast<const bf16*>(c0),
        static_cast<bf16*>(out), static_cast<bf16*>(nullptr),
        static_cast<bf16*>(nullptr), static_cast<bf16*>(h_t),
        static_cast<bf16*>(c_t), static_cast<bf16*>(c_scratch), T, B, H, Hp,
        dim3(gx, gy), s);
  return (int)cudaErrorInvalidValue;
}

// K4: K1 plus the training residuals gates (T, B, 4H) and c_seq (T, B, H),
// in the same dtype. bf16 runs on the tensor cores and also takes w_pack,
// h_pad (2, B, Hp) with h0 in its first half, Hp and the grid, all from
// ops/fused_lstm.py::tc_layout; f32 reads w_hh and h0 and ignores them.
int fused_lstm_forward_gates(int dtype, const void* x_proj, const void* w_hh,
                             const void* w_pack, const void* h0, void* h_pad,
                             const void* c0, void* out, void* gates,
                             void* c_seq, void* h_t, void* c_t,
                             void* c_scratch, int T, int B, int H, int Hp,
                             int gx, int gy, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float, true>(x_proj, w_hh, h0, c0, out, gates, c_seq, h_t,
                            c_t, c_scratch, T, B, H, s);
  if (dtype == 1)
    return run_fwd_tc<FwdTile, FwdKind::kK4>(
        static_cast<const bf16*>(x_proj), static_cast<const bf16*>(w_pack),
        nullptr, nullptr, static_cast<bf16*>(h_pad),
        static_cast<const bf16*>(c0), static_cast<bf16*>(out),
        static_cast<bf16*>(gates),
        static_cast<bf16*>(c_seq), static_cast<bf16*>(h_t),
        static_cast<bf16*>(c_t), static_cast<bf16*>(c_scratch), T, B, H, Hp,
        dim3(gx, gy), s);
  return (int)cudaErrorInvalidValue;
}

// K5. gates (T, B, 4H), c_seq, d_out (T, B, H), w_hh (4H, H), dh_t (B, H)
// and the outputs dz (T, B, 4H), dh0, dc0 (B, H) are of dtype; dc is a
// (B, H) f32 buffer that holds dc_T on entry (rounded to dtype) and is
// overwritten. bf16 runs on the tensor cores and also takes w_pack, the
// zeroed scratch dz_pad (2, B, 4Hp), Hp and the grid from tc_layout; f32
// reads w_hh and ignores them. T + 1 launches; T = 0 is the caller's.
int fused_lstm_backward(int dtype, const void* gates, const void* c_seq,
                        const void* d_out, const void* w_hh,
                        const void* w_pack, const void* dh_t, float* dc,
                        void* dz, void* dz_pad, void* dh0, void* dc0, int T,
                        int B, int H, int Hp, int gx, int gy, int gz,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_bwd<float>(gates, c_seq, d_out, w_hh, dh_t, dc, dz, dh0, dc0,
                          T, B, H, s);
  if (dtype == 1)
    return run_bwd_tc(static_cast<const bf16*>(gates),
                      static_cast<const bf16*>(c_seq),
                      static_cast<const bf16*>(d_out),
                      static_cast<const bf16*>(w_pack),
                      static_cast<const bf16*>(dh_t), dc,
                      static_cast<bf16*>(dz), static_cast<bf16*>(dz_pad),
                      static_cast<bf16*>(dh0), static_cast<bf16*>(dc0), T, B,
                      H, Hp, dim3(gx, gy, gz), s);
  return (int)cudaErrorInvalidValue;
}

// K2. dtype: 0 = float32, 1 = bfloat16, for x_proj, w_hh, h0, c0, out,
// h_t, c_t and the (B, H) scratches; valid is (B,) int32. 0 <= t_live <= T
// and t_live >= max(valid); T = 0 is the caller's to handle. f32 runs the
// CUDA-core template; bf16 runs on the tensor cores as K1 does, with
// w_pack, h_pad, Hp, the grid and the tile's batch rows, and reads neither
// w_hh nor h_scratch.
int fused_lstm_forward_ragged(int dtype, const void* x_proj, const void* w_hh,
                              const int* valid, const void* h0,
                              const void* c0, void* out, void* h_t, void* c_t,
                              void* h_scratch, void* c_scratch,
                              const void* w_pack, void* h_pad, int T,
                              int t_live, int B, int H, int Hp, int gx, int gy,
                              int batch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_ragged<float, float>(x_proj, w_hh, nullptr, valid, h0, c0, out,
                                    h_t, c_t, h_scratch, c_scratch, T, t_live,
                                    B, H, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  bool done = false;
  const cudaError_t err = ragged_prologue<bf16>(
      out, h0, c0, h_t, c_t, T, t_live, (size_t)B * H, s, &done);
  if (err != cudaSuccess || done) return (int)err;
  return run_fwd_tc_tile<FwdKind::kK2>(
      batch, static_cast<const bf16*>(x_proj),
      static_cast<const bf16*>(w_pack), static_cast<const float*>(nullptr),
      valid, static_cast<bf16*>(h_pad),
      static_cast<const bf16*>(c0), static_cast<bf16*>(out),
      static_cast<bf16*>(nullptr), static_cast<bf16*>(nullptr),
      static_cast<bf16*>(h_t), static_cast<bf16*>(c_t),
      static_cast<bf16*>(c_scratch), t_live, B, H, Hp, dim3(gx, gy), s);
}

// K3: as K2, with w_hh_q int8 (4H, H) and w_scale f32 (4H,); dtype is the
// activations' type. f32 runs the CUDA-core template. bf16 runs on the
// tensor cores as K2 does, with h_pad, Hp, the grid and the tile's batch
// rows, and no pack: it reads the codes where they lie, `copy` bytes at a
// time (16 for even H, else 1; ops/fused_lstm.py::int8_copy_bytes picks
// it), and reads no h_scratch.
int fused_lstm_forward_ragged_int8(int dtype, const void* x_proj,
                                   const void* w_hh_q, const float* w_scale,
                                   const int* valid, const void* h0,
                                   const void* c0, void* out, void* h_t,
                                   void* c_t, void* h_scratch,
                                   void* c_scratch, void* h_pad, int T,
                                   int t_live, int B, int H, int Hp, int gx,
                                   int gy, int batch, int copy,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_ragged<float, int8_t>(x_proj, w_hh_q, w_scale, valid, h0, c0,
                                     out, h_t, c_t, h_scratch, c_scratch, T,
                                     t_live, B, H, s);
  if (dtype != 1 || !(copy == 1 || (copy == 16 && H % 2 == 0)))
    return (int)cudaErrorInvalidValue;
  bool done = false;
  const cudaError_t err = ragged_prologue<bf16>(
      out, h0, c0, h_t, c_t, T, t_live, (size_t)B * H, s, &done);
  if (err != cudaSuccess || done) return (int)err;
  auto run = [&](auto width) {
    return run_fwd_tc_tile<FwdKind::kK3, decltype(width)::value>(
        batch, static_cast<const bf16*>(x_proj),
        static_cast<const int8_t*>(w_hh_q), w_scale, valid,
        static_cast<bf16*>(h_pad), static_cast<const bf16*>(c0),
        static_cast<bf16*>(out), static_cast<bf16*>(nullptr),
        static_cast<bf16*>(nullptr), static_cast<bf16*>(h_t),
        static_cast<bf16*>(c_t), static_cast<bf16*>(c_scratch), t_live, B, H,
        Hp, dim3(gx, gy), s);
  };
  if (copy == 16) return run(std::integral_constant<int, 16>());
  return run(std::integral_constant<int, 1>());
}

const char* fused_lstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

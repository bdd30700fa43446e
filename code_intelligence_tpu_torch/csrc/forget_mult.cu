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
// f, out, g and writes dz, df: 6 T*B*H elements. To stream at that rate,
// HBM needs ~3.35 TB/s x ~1.5 us of loaded latency / 132 SMs = ~38 KB in
// flight on every SM, all the time.
//
// Every kernel here walks time in order with one f32 carry per (b, h) lane
// and the unfused _rn intrinsics (fm_step), so nvcc contracts nothing into
// an FMA and each operation rounds as the plain PyTorch version's does;
// stored outputs round once to the dtype. The kernels equal their plain
// loops bit for bit. No scan in parallel over time: it would reround the
// carry. Only the way the bytes arrive differs between the two designs:
//
// K6 and K8, the ring (forget_mult_fwd_ring), for every call whose B*H
// plane is a whole number of 16-byte vectors and whose tensors start on
// 16-byte boundaries (the flagship shapes: 160,000, 520,000, 51,200 and
// 166,400 bytes a step). The flat B*H plane of a time-major tensor is
// contiguous, so one block per SM takes one contiguous run of L lanes (L =
// B*H / SMs, rounded up to 16 bytes: 608 at the slot step, 1,976 at the
// training shape in bf16), and each step's slice of z or f is one run of
// L*item bytes. A ring of S stages in shared memory holds kGroup = 8 steps
// of z and f a stage, each stage completing on one full mbarrier; S fills
// a 128 KB budget and never exceeds the window: 6 stages (48 steps) at the
// slot step, 2 (16 steps) at the training shape, the whole window at the
// ragged step. The last warp produces: lane 2k issues the TMA bulk copy
// (cp.async.bulk) of step k's z and lane 2k + 1 its f, so a stage's 16
// copies go out at once (one thread issuing them in turn was measured
// slower). Each consumer thread owns kLanes = 2 lanes (4 bytes of bf16, 8
// of f32): per stage it waits on the full barrier, reads its z and f of
// the stage's steps from shared memory, advances its carries a step at a
// time and stores each step's two outputs; its warp then arrives on the
// stage's empty barrier, which the producer waits on before it refills
// the stage. Eight steps a stage amortize the barrier round trips; two
// lanes a thread spread a step over many warps (10 at the slot step, 31
// at the training shape), which shortens each warp's chain per step. The
// grid is one wave at the flagship shapes; a plane beyond 132 runs of
// kRingWarps x 32 chunks (or of two stages' budget) takes more blocks.
// K8 on the ring: element j of a chunk is lane i + j of row (i + j) / H,
// so the length test is per element (a chunk can straddle two rows when
// H is odd). The producer issues the first stage before it reads the
// lengths, then loads only up to the longest live length among the
// block's rows (at least that stage): a block whose rows are all dead
// loads one stage and writes h0, rounded, over its outputs. Past a row's
// length every step stores its frozen carry.
// What holds the ring back on an H100 is HBM itself: it moves its bytes
// about as fast as PyTorch's vectorized elementwise add moves the same
// bytes (chip_smoke.py times both, same_bytes_ms).
//
// K6 and K8, the per-lane walk (forget_mult_fwd_lane), for the other
// shapes (B*H*item not a multiple of 16, such as (19, 3, 129), or a
// tensor off a 16-byte boundary): the C entry chooses it from the shape
// and the pointers alone. One thread per lane, consecutive threads on
// consecutive addresses, each issuing kAhead steps of loads before it
// uses any. K7 (forget_mult_bwd) is that walk in reverse time.
//
// The TPU kernels' VMEM budget (fits_stream_budget, _pick_block_b), their
// sublane and lane padding (_pad_tm, _pad_state) and the fallback to the
// associative scan have no counterpart: every shape runs its kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kAhead = 8;  // steps of loads in flight before their use

// the ring: steps a stage holds, K8's stages loaded before the lengths are
// read, shared memory for stages, their count, lanes a consumer thread
// owns, the consumer warps
constexpr int kGroup = 8;
constexpr int kSpecGroups = 1;
constexpr int kRingBytes = 128 * 1024;
constexpr int kMaxStages = 64;
constexpr int kRingHeader = 2 * kMaxStages * 8;  // full and empty mbarriers
constexpr int kLanes = 2;
constexpr int kRingWarps = 31;  // consumers; + 1 producer
static_assert(2 * kGroup <= 32, "a producer lane a copy of a stage");

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

// K6, and K8 when valid is not null, one thread per lane. lanes = B * H;
// lane i is (i / H, i % H).
template <typename T>
__global__ void __launch_bounds__(kThreads)
forget_mult_fwd_lane(const T* __restrict__ z, const T* __restrict__ f,
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

// A consumer thread's kLanes lanes as f32 and back, each output rounded
// once (_rn)
template <typename T>
struct Chunk {
  static constexpr int kN = kLanes, kBytes = kN * sizeof(T);
  static constexpr int kWords = kBytes / 4;
  struct alignas(kBytes) Raw {
    unsigned w[kWords];
  };
  __device__ static void unpack(const Raw& r, float (&v)[kN]) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      if constexpr (sizeof(T) == 4) {
        v[k] = __uint_as_float(r.w[k]);
      } else {  // the lower address is the lower half
        v[2 * k] = __uint_as_float(r.w[k] << 16);
        v[2 * k + 1] = __uint_as_float(r.w[k] & 0xffff0000u);
      }
    }
  }
  __device__ static Raw pack(const float (&v)[kN]) {
    Raw r;
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      if constexpr (sizeof(T) == 4) {
        r.w[k] = __float_as_uint(v[k]);
      } else {
        const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
        r.w[k] = *reinterpret_cast<const unsigned*>(&b);
      }
    }
    return r;
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The steps a block of K8 must load: the longest live length among the
// rows its lanes [start, start + n) touch, at least the kSpecGroups
// groups issued before the lengths are read. K6 loads all T.
template <bool kRagged>
__device__ __forceinline__ int steps_to_load(const int* __restrict__ valid,
                                             size_t start, int n, int H,
                                             int T_len) {
  if (!kRagged) return T_len;
  int most = 0;
  for (size_t r = start / H; r <= (start + n - 1) / H; ++r)
    most = max(most, min(valid[r], T_len));
  return max(most, min(kSpecGroups * kGroup, T_len));
}

// K6 (kRagged false) and K8 on the ring. Block k owns lanes [k L, k L + L)
// of the B*H plane; blockDim.x = 32 x (consumer warps + 1), the last warp
// the producer. Shared memory: the full and empty mbarriers of
// kMaxStages stages, then S stages, each kGroup steps of (z, f) runs of L
// lanes. Stage g % S holds steps [g kGroup, g kGroup + kGroup).
template <typename T, bool kRagged>
__global__ void __launch_bounds__((kRingWarps + 1) * 32)
forget_mult_fwd_ring(const T* __restrict__ z, const T* __restrict__ f,
                     const T* __restrict__ h0, const int* __restrict__ valid,
                     T* __restrict__ out, int T_len, int H, size_t lanes,
                     int L, int S) {
  using C = Chunk<T>;
  using Raw = typename C::Raw;
  constexpr int kN = C::kN;
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned full = smem_addr(smem), empty = full + 8 * kMaxStages;
  const unsigned ring = smem_addr(smem + kRingHeader);
  const unsigned run = L * sizeof(T), stage = kGroup * 2 * run;
  const size_t start = (size_t)blockIdx.x * L;
  const int n = (int)(lanes - start < (size_t)L ? lanes - start : L);
  const int consumers = blockDim.x / 32 - 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x < S) {
    mbar_init(full + 8 * threadIdx.x, 1);
    mbar_init(empty + 8 * threadIdx.x, consumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == consumers) {  // the producer warp: a lane a copy of a stage
    const unsigned bytes = n * sizeof(T);
    // group g: its steps [g kGroup, min(g kGroup + kGroup, steps))
    auto issue = [&](int g, int steps) {
      const int s = g % S, k_n = min(kGroup, steps - g * kGroup);
      if (g >= S) mbar_wait(empty + 8 * s, (g / S - 1) & 1);
      if (lane == 0) mbar_expect_tx(full + 8 * s, 2 * k_n * bytes);
      if (lane < 2 * k_n) {  // lane 2k: step k's z; lane 2k + 1: its f
        const size_t at = (size_t)(g * kGroup + lane / 2) * lanes + start;
        bulk_load(ring + s * stage + lane * run, (lane % 2 ? f : z) + at,
                  bytes, full + 8 * s);
      }
    };
    // K8: the first groups before the lengths are read, as if all ran
    int g = 0;
    for (; kRagged && g < kSpecGroups && g * kGroup < T_len; ++g)
      issue(g, T_len);
    const int steps = steps_to_load<kRagged>(valid, start, n, H, T_len);
    for (; g * kGroup < steps; ++g) issue(g, steps);
    return;
  }

  const int c = threadIdx.x;  // this thread's chunk of the block's run
  const bool mine = c * kN < n;
  const size_t i = start + (size_t)c * kN;
  float h[kN];
  int live[kN];  // steps each lane runs (K8)
  if (mine) {
    C::unpack(*reinterpret_cast<const Raw*>(h0 + i), h);
#pragma unroll
    for (int j = 0; j < kN; ++j)
      live[j] = kRagged ? max(0, min(valid[(i + j) / H], T_len)) : T_len;
  }
  const int steps = steps_to_load<kRagged>(valid, start, n, H, T_len);
  const unsigned char* zs = smem + kRingHeader + c * C::kBytes;
  for (int g = 0; g * kGroup < steps; ++g) {
    const int s = g % S, t0 = g * kGroup;
    mbar_wait(full + 8 * s, (g / S) & 1);
    if (mine) {
      Raw zr[kGroup], fr[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (t0 + k < steps) {
          const unsigned char* p = zs + s * stage + k * 2 * run;
          zr[k] = *reinterpret_cast<const Raw*>(p);
          fr[k] = *reinterpret_cast<const Raw*>(p + run);
        }
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (t0 + k < steps) {
          float zv[kN], fv[kN];
          C::unpack(zr[k], zv);
          C::unpack(fr[k], fv);
#pragma unroll
          for (int j = 0; j < kN; ++j)
            if (!kRagged || t0 + k < live[j])
              h[j] = fm_step(h[j], fv[j], zv[j]);
          *reinterpret_cast<Raw*>(out + (size_t)(t0 + k) * lanes + i) =
              C::pack(h);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }
  if (mine) {  // the frozen carries over the steps no block row reaches
    const Raw v = C::pack(h);
    for (int t = steps; t < T_len; ++t)
      *reinterpret_cast<Raw*>(out + (size_t)t * lanes + i) = v;
  }
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

// the SM count of the current device, read once per device
inline int sm_count() {
  static std::atomic<int> cached[64];
  int dev = 0;
  cudaGetDevice(&dev);
  int n = dev < 64 ? cached[dev].load() : 0;
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (dev < 64) cached[dev].store(n);
  }
  return n > 0 ? n : 1;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, bool kRagged>
int run_ring(const T* z, const T* f, const T* h0, const int* valid, T* out,
             int T_len, int H, size_t lanes, cudaStream_t stream) {
  constexpr int kN = Chunk<T>::kN, kAlign = 16 / sizeof(T);
  const size_t sms = sm_count();
  size_t L = (lanes + sms - 1) / sms;
  L = (L + kAlign - 1) / kAlign * kAlign;  // every run on a 16-byte boundary
  // at most kRingWarps x 32 chunks, and two stages within the budget
  L = std::min({L, (size_t)kRingWarps * 32 * kN,
                kRingBytes / (4 * kGroup * sizeof(T)) / kAlign * kAlign});
  const int stage = kGroup * 2 * (int)L * sizeof(T);
  const int groups = (T_len + kGroup - 1) / kGroup;
  const int S =
      std::max(1, std::min({kRingBytes / stage, kMaxStages, groups}));
  const int smem = kRingHeader + S * stage;
  const auto kernel = forget_mult_fwd_ring<T, kRagged>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int warps = ((int)L / kN + 31) / 32 + 1;
  kernel<<<(unsigned)((lanes + L - 1) / L), warps * 32, smem, stream>>>(
      z, f, h0, valid, out, T_len, H, lanes, (int)L, S);
  return (int)cudaGetLastError();
}

// The ring when the B*H plane is whole 16-byte vectors and every tensor
// starts on a 16-byte boundary; the per-lane walk otherwise.
template <typename T>
int run_fwd(const void* z, const void* f, const void* h0, const int* valid,
            void* out, int T_len, int B, int H, cudaStream_t stream) {
  const size_t lanes = (size_t)B * H;
  const T *zt = static_cast<const T*>(z), *ft = static_cast<const T*>(f),
          *h0t = static_cast<const T*>(h0);
  T* outt = static_cast<T*>(out);
  if (lanes * sizeof(T) % 16 == 0 && aligned16(z) && aligned16(f) &&
      aligned16(h0) && aligned16(out)) {
    return valid != nullptr
               ? run_ring<T, true>(zt, ft, h0t, valid, outt, T_len, H, lanes,
                                   stream)
               : run_ring<T, false>(zt, ft, h0t, valid, outt, T_len, H,
                                    lanes, stream);
  }
  forget_mult_fwd_lane<T><<<blocks(lanes), kThreads, 0, stream>>>(
      zt, ft, h0t, valid, outt, T_len, H, lanes);
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

// Window gather for Hopper (sm_90a): out[b, r, c, ch] = scene[Y, X, ch] with
// Y = clamp_wrap(y_b + r, Hp) and X = clamp_wrap(x_b + c, Wp).
//
// Replaces the TPU kernel hypelcnn_tpu/ops/window_gather.py:gather_patches_pallas
// (kernel body _gather_kernel_chunked). That kernel padded channels to 128
// lanes, kept coordinates in SMEM blocks and moved each window with a DMA into
// VMEM scratch; none of that carries over.
//
// Bound: memory. The kernel does no arithmetic on the data; it writes
// B*k*k*C*4 bytes and reads the distinct scene rows the windows touch. On the
// full-scene sweep (B = 30,480 windows per band, k = 3, C = 145) that is about
// 159 MB written and 20 MB read per band, about 54 us at 3.35 TB/s. At the
// training step's 48 windows it is 0.25 MB: there the time is one launch and
// one chain of dependent loads, and the design keeps that chain short.
//
// Design: the output is one contiguous run of n = B*k*k*C floats, cut into
// n / 4 aligned 16-byte chunks and a scalar tail of n mod 4 floats. Each
// thread owns U chunks, 256 chunks apart within its block's span, so every
// store instruction of a warp writes 512 contiguous bytes with one
// st.global.v4 a lane. U is 1 when the chunks fit one wave of the card's
// threads (a training step: a thread's time is then its chain of dependent
// loads, the shorter the better) and 4 above (more loads in flight a
// thread). Each block covers one span of 256 * U chunks and the grid as
// many spans as cover the output: on the sweep bands that measured faster
// than a grid capped at the resident blocks. A chunk's first float is split into (window, row,
// column, channel) by multiply-high division by constants the host
// precomputes (no runtime divide); the chunk's other floats follow by a
// carry into the next pixel, which handles C < 4 as well. Each float is read
// with a 4-byte read-only load (the windows overlap, so scene rows are
// re-read from L1 or L2); a thread issues all its chunks' loads before its
// first store. In-range and out-of-range windows take the same path: an
// index below 0 is wrapped once by the dimension, then clamped into
// [0, dim - 1], as JAX's gather does. Index math is 32-bit when n and the
// scene's element count are below 2^31, else 64-bit; both are compiled and
// the host picks. Outputs larger than the L2 are stored evict-first
// (__stcs), which keeps the scene rows the next windows read in the L2.

#include <cuda_runtime.h>

// The launch plan, computed by kernels/window_gather.py:launch_plan and
// passed by pointer; the ctypes.Structure _Plan there mirrors this layout.
struct GatherPlan {
  long long elements;            // n = B * k * k * C
  long long chunks;              // n / 4
  unsigned long long mul[3];     // multiply-high constants for C, k*k and k
  int shift[3];
  int tail;                      // n mod 4
  int chunks_per_thread;
  int blocks;
  int wide;                      // 64-bit index math
  int streaming;                 // evict-first stores
};

namespace {

constexpr int kThreads = 256;
constexpr int kLargeChunksPerThread = 4;  // U above one wave; U = 1 below

__device__ __forceinline__ unsigned int mul_high(unsigned int a, unsigned int b) {
  return __umulhi(a, b);
}

__device__ __forceinline__ unsigned long long mul_high(unsigned long long a,
                                                       unsigned long long b) {
  return __umul64hi(a, b);
}

// n / d for 0 <= n < 2^(bits - 1): (n * mul) >> (bits + shift), with mul = 0
// standing for d = 1 (the host's fast_divisor).
template <typename I>
struct Divisor {
  I d;
  I mul;
  int shift;
  __device__ __forceinline__ I div(I n) const { return mul ? mul_high(n, mul) >> shift : n; }
};

template <typename I>
struct Params {
  const float* scene;
  const int* coords;
  float* out;
  I chunks;
  long long hp;
  long long wp;
  Divisor<I> by_channels;
  Divisor<I> by_window;   // k * k
  Divisor<I> by_k;
  int tail;
  int streaming;
};

__device__ __forceinline__ long long clamp_wrap(long long i, long long dim) {
  if (i < 0) i += dim;
  return i < 0 ? 0 : (i >= dim ? dim - 1 : i);
}

// Offset in the scene of window pixel `pixel` = (b * k + r) * k + c.
template <typename I>
__device__ __forceinline__ I pixel_offset(const Params<I>& p, I pixel) {
  const I b = p.by_window.div(pixel);
  const I rc = pixel - b * p.by_window.d;
  const I r = p.by_k.div(rc);
  const I c = rc - r * p.by_k.d;
  const int* xy = p.coords + 2 * static_cast<unsigned long long>(b);
  const I y = static_cast<I>(clamp_wrap(static_cast<long long>(__ldg(xy + 1)) +
                                        static_cast<long long>(r), p.hp));
  const I x = static_cast<I>(clamp_wrap(static_cast<long long>(__ldg(xy)) +
                                        static_cast<long long>(c), p.wp));
  return (y * static_cast<I>(p.wp) + x) * p.by_channels.d;
}

template <typename I>
__device__ __forceinline__ float4 load_chunk(const Params<I>& p, I q) {
  const I first = q * 4;
  I pixel = p.by_channels.div(first);
  I ch = first - pixel * p.by_channels.d;
  I offset = pixel_offset(p, pixel);
  float v[4];
  v[0] = __ldg(p.scene + offset + ch);
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    if (++ch == p.by_channels.d) {  // the chunk runs into the next pixel
      ch = 0;
      offset = pixel_offset(p, ++pixel);
    }
    v[j] = __ldg(p.scene + offset + ch);
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <typename I, int U>
__global__ void __launch_bounds__(kThreads) window_gather_kernel(const Params<I> p) {
  const I base = static_cast<I>(blockIdx.x) * (static_cast<I>(kThreads) * U);
  float4* out4 = reinterpret_cast<float4*>(p.out);
  float4 v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const I q = base + static_cast<I>(u * kThreads + threadIdx.x);
    if (q < p.chunks) v[u] = load_chunk(p, q);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const I q = base + static_cast<I>(u * kThreads + threadIdx.x);
    if (q < p.chunks) {
      if (p.streaming) {
        __stcs(out4 + q, v[u]);
      } else {
        out4[q] = v[u];
      }
    }
  }
  if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < p.tail) {
    const I e = p.chunks * 4 + threadIdx.x;
    const I pixel = p.by_channels.div(e);
    p.out[e] = __ldg(p.scene + pixel_offset(p, pixel) + (e - pixel * p.by_channels.d));
  }
}

template <typename I>
Divisor<I> divisor(long long d, const GatherPlan& plan, int which) {
  return {static_cast<I>(d), static_cast<I>(plan.mul[which]), plan.shift[which]};
}

template <typename I>
int launch(const float* scene, const int* coords, float* out, int k, int hp, int wp,
           int channels, const GatherPlan& plan, cudaStream_t stream) {
  const Params<I> p{scene, coords, out, static_cast<I>(plan.chunks), hp, wp,
                    divisor<I>(channels, plan, 0),
                    divisor<I>(static_cast<long long>(k) * k, plan, 1),
                    divisor<I>(k, plan, 2), plan.tail, plan.streaming};
  if (plan.chunks_per_thread == 1) {
    window_gather_kernel<I, 1><<<plan.blocks, kThreads, 0, stream>>>(p);
  } else {
    window_gather_kernel<I, kLargeChunksPerThread><<<plan.blocks, kThreads, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller owns every buffer: scene [hp, wp, channels] float32, coords [batch, 2]
// int32 as (x, y), out [batch, k, k, channels] float32 at a 16-byte aligned
// address, all contiguous. A plan that does not fit these sizes or this
// build (its blocks must cover the chunks, one span each) returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int window_gather(const float* scene, const int* coords, float* out,
                             long long batch, int k, int hp, int wp, int channels,
                             const GatherPlan* plan, void* stream) {
  const long long elements = batch * k * k * channels;
  const long long span = static_cast<long long>(kThreads) * plan->chunks_per_thread;
  if (plan->elements != elements || plan->chunks * 4 + plan->tail != elements ||
      (plan->chunks_per_thread != 1 && plan->chunks_per_thread != kLargeChunksPerThread) ||
      plan->blocks != (elements ? (plan->chunks + span - 1) / span + (plan->chunks == 0) : 0) ||
      reinterpret_cast<unsigned long long>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (plan->blocks == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  return plan->wide ? launch<unsigned long long>(scene, coords, out, k, hp, wp, channels, *plan, s)
                    : launch<unsigned int>(scene, coords, out, k, hp, wp, channels, *plan, s);
}

// The device's SM count into *count; returns a cudaError_t (0 on success).
extern "C" int window_gather_sm_count(int device, int* count) {
  return static_cast<int>(cudaDeviceGetAttribute(count, cudaDevAttrMultiProcessorCount, device));
}

extern "C" const char* window_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

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
// 159 MB written and 20 MB read per band, about 54 us at 3.35 TB/s.
//
// Design: in a contiguous NHWC scene, one window row (k pixels x C channels)
// is one contiguous run of k*C floats starting at ((Y*Wp) + x)*C, and the
// matching output row is contiguous too. One warp copies one window row, lane
// i taking floats i, i+32, ..., so each warp instruction reads and writes 32
// consecutive floats (coalesced). No shared-memory staging: each byte is read
// once and written once. Offsets are 64-bit, since B*k*k*C and Hp*Wp*C reach
// 2^31 at larger batches. Rows whose columns leave the scene take a slower
// per-element path with the same clamping as JAX's gather: an index below 0
// is wrapped once by the dimension, then clamped into [0, dim-1].

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr long long kMaxBlocks = 1 << 20;

__device__ __forceinline__ long long clamp_wrap(long long i, long long dim) {
  if (i < 0) i += dim;
  return i < 0 ? 0 : (i >= dim ? dim - 1 : i);
}

__global__ void __launch_bounds__(kThreads)
window_gather_kernel(const float* __restrict__ scene, const int* __restrict__ coords,
                     float* __restrict__ out, long long rows, int k, int hp, int wp,
                     int channels) {
  const int lane = threadIdx.x & 31;
  const long long row_len = static_cast<long long>(k) * channels;
  const long long warp_stride = static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  for (long long row = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
       row < rows; row += warp_stride) {
    const long long b = row / k;
    const int r = static_cast<int>(row - b * k);
    const long long x = coords[2 * b];
    const long long y = coords[2 * b + 1];
    const float* src_row = scene + clamp_wrap(y + r, hp) * wp * channels;
    float* dst = out + row * row_len;
    if (x >= 0 && x + k <= wp) {
      const float* src = src_row + x * channels;
      for (long long j = lane; j < row_len; j += 32) dst[j] = src[j];
    } else {
      for (long long j = lane; j < row_len; j += 32) {
        const long long col = j / channels;
        const long long ch = j - col * channels;
        dst[j] = src_row[clamp_wrap(x + col, wp) * channels + ch];
      }
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller owns every buffer: scene [hp, wp, channels] float32, coords [batch, 2]
// int32 as (x, y), out [batch, k, k, channels] float32, all contiguous.
extern "C" int window_gather(const float* scene, const int* coords, float* out,
                             long long batch, int k, int hp, int wp, int channels,
                             void* stream) {
  const long long rows = batch * k;
  long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks > 0) {
    window_gather_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        scene, coords, out, rows, k, hp, wp, channels);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* window_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

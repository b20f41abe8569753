// Per-pixel tap gather: out[k, y, x, :] = payload[tys[k,y,x], txs[k,y,x], :].
//
// Replaces the Pallas TPU kernel tpu_restir/kernels/local_gather.py
// `_kernel` (gather_local). On the TPU a generic gather moves about one
// element per cycle, so that kernel DMAs one halo window per output tile
// into VMEM and resolves the taps there with lane gathers and masked
// selects, which needs offsets bounded by PAD = 8 and tile-aligned images.
//
// What bounds it on the H100: memory traffic. Each tap reads and writes C
// floats (96 B at the slim C = 24) and reads two int32 coordinates; the
// spatial pass's 5 taps at 1080p write 1.0 GB and read as much (0.6 ms at
// the 3.35 TB/s peak), and the reads often hit L2, since neighbouring
// pixels read rows a few pixels apart. There is no arithmetic to speak of.
//
// Design: one thread per (tap k, pixel); each copies the C contiguous
// floats of its source pixel, as float4 loads and stores when C % 4 == 0
// and the buffers are 16-byte aligned (the wrapper checks), else as
// floats. The GPU's caches play the part of the TPU's halo window, so
// there is no window: any in-range coordinate is served, at any H and W,
// and temporal reprojection taps of any length take this kernel too. A
// coordinate outside the payload traps (a device fault), as an
// out-of-range index would in the plain version.
//
// C interface (ctypes): the entry returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kVec4>
__global__ void gather_kernel(const float* __restrict__ payload,
                              const int* __restrict__ tys,
                              const int* __restrict__ txs, int eh, int w,
                              int c, long long n_taps,
                              float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_taps) return;
  const int ty = tys[i];
  const int tx = txs[i];
  if (ty < 0 || ty >= eh || tx < 0 || tx >= w) __trap();
  const long long src = ((long long)ty * w + tx) * c;
  const long long dst = i * c;
  if (kVec4) {
    const float4* s = reinterpret_cast<const float4*>(payload + src);
    float4* o = reinterpret_cast<float4*>(out + dst);
    for (int q = 0; q < c / 4; ++q) o[q] = s[q];
  } else {
    for (int q = 0; q < c; ++q) out[dst + q] = payload[src + q];
  }
}

}  // namespace

extern "C" {

int local_gather(const void* payload, const void* tys, const void* txs,
                 int eh, int w, int c, long long n_taps, int vec4, void* out,
                 void* stream) {
  const unsigned blocks = (unsigned)((n_taps + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec4)
    gather_kernel<true><<<blocks, kThreads, 0, s>>>(
        (const float*)payload, (const int*)tys, (const int*)txs, eh, w, c,
        n_taps, (float*)out);
  else
    gather_kernel<false><<<blocks, kThreads, 0, s>>>(
        (const float*)payload, (const int*)tys, (const int*)txs, eh, w, c,
        n_taps, (float*)out);
  return (int)cudaGetLastError();
}

const char* local_gather_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

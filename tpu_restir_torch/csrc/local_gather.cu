// Per-pixel tap gather: out[k, y, x, :] = payload[tys[k,y,x], txs[k,y,x], :].
//
// Replaces the Pallas TPU kernel tpu_restir/kernels/local_gather.py
// `_kernel` (gather_local). On the TPU a generic gather moves about one
// element per cycle, so that kernel DMAs one halo window per output tile
// into VMEM and resolves the taps there with lane gathers and masked
// selects, which needs offsets bounded by PAD = 8 and tile-aligned images.
//
// What bounds it on the H100: memory traffic, and nothing else (a copy).
// The spatial pass's 5 taps at 1080p and C = 24 write 1.0 GB, read the
// 0.2 GB payload and 0.08 GB of coordinates: 0.38 ms at 3.35 TB/s.
//
// Design: the output is written as one contiguous stream. A block owns
// kTaps consecutive taps of one tap slice k; it first loads their
// coordinates (coalesced), checks each once (a coordinate outside the
// payload traps, a device fault, as an out-of-range index would in the
// plain version) and keeps each tap's source offset in shared memory.
// Then consecutive threads copy consecutive 16-byte chunks of the block's
// output span: thread j copies chunk q = j mod (C/4) of tap j div (C/4),
// so a warp stores 512 contiguous bytes and loads whole 96-byte source
// rows (C = 24), and each thread has C/4 loads in flight before its
// stores. The payload is read through the read-only path; the stores are
// plain (streaming stores, __stcs, were no faster on the card). Blocks are
// numbered slice fastest, so the K blocks that read the same ~256 source
// pixels run together and the payload comes from DRAM about once, not K
// times (numbered slice-major, the gather was slower on the card).
// Other widths (the C = 3 position tap) and payloads that are not 16-byte
// aligned take the same mapping with one float per thread. There is no
// window: any in-range coordinate is served, at any H and W.
//
// C interface (ctypes): the entry returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 256;   // taps per block == threads per block

// V: float4 or float; kWidth: row width in V (0 = the runtime `width`).
template <typename V, int kWidth>
__global__ void __launch_bounds__(kTaps)
gather_kernel(const V* __restrict__ payload, const int* __restrict__ tys,
              const int* __restrict__ txs, int eh, int w, int runtime_width,
              int k, long long slice, V* __restrict__ out) {
  const int width = kWidth ? kWidth : runtime_width;
  __shared__ long long src[kTaps];
  const int kk = (int)(blockIdx.x % (unsigned)k);
  const long long first = (long long)kk * slice
      + (long long)(blockIdx.x / (unsigned)k) * kTaps;   // first tap
  const int n = (int)min((long long)kTaps,
                         (long long)(kk + 1) * slice - first);
  if (threadIdx.x < n) {
    const int ty = tys[first + threadIdx.x];
    const int tx = txs[first + threadIdx.x];
    if (ty < 0 || ty >= eh || tx < 0 || tx >= w) __trap();
    src[threadIdx.x] = ((long long)ty * w + tx) * width;
  }
  __syncthreads();
  V* dst = out + first * width;
  const int total = n * width;
  if constexpr (kWidth > 0) {
    V v[kWidth];
#pragma unroll
    for (int u = 0; u < kWidth; ++u) {
      const int j = threadIdx.x + u * kTaps;
      if (j < total) v[u] = __ldg(payload + src[j / kWidth] + j % kWidth);
    }
#pragma unroll
    for (int u = 0; u < kWidth; ++u) {
      const int j = threadIdx.x + u * kTaps;
      if (j < total) dst[j] = v[u];
    }
  } else {
#pragma unroll 4
    for (int j = threadIdx.x; j < total; j += kTaps)
      dst[j] = __ldg(payload + src[j / width] + j % width);
  }
}

template <typename V, int kWidth>
void launch(const void* payload, const void* tys, const void* txs, int eh,
            int w, int width, int k, long long slice, void* out,
            cudaStream_t s) {
  const unsigned blocks =
      (unsigned)(k * ((slice + kTaps - 1) / kTaps));
  gather_kernel<V, kWidth><<<blocks, kTaps, 0, s>>>(
      (const V*)payload, (const int*)tys, (const int*)txs, eh, w, width, k,
      slice, (V*)out);
}

}  // namespace

extern "C" {

// payload (eh, w, c) float32; tys, txs (k, slice) int32; out (k, slice, c).
// vec4: payload and out 16-byte aligned (the wrapper checks); float4 copies
// serve the payloads of the main path (C = 24 slim, 32 full), one float a
// thread every other C (the C = 3 position tap unrolled).
int local_gather(const void* payload, const void* tys, const void* txs,
                 int eh, int w, int c, int k, long long slice, int vec4,
                 void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (vec4 && c == 24)
    launch<float4, 6>(payload, tys, txs, eh, w, 6, k, slice, out, s);
  else if (vec4 && c == 32)
    launch<float4, 8>(payload, tys, txs, eh, w, 8, k, slice, out, s);
  else if (c == 3)
    launch<float, 3>(payload, tys, txs, eh, w, 3, k, slice, out, s);
  else
    launch<float, 0>(payload, tys, txs, eh, w, c, k, slice, out, s);
  return (int)cudaGetLastError();
}

const char* local_gather_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

// Transpose of the per-pixel tap gather (K4): the payload cotangent
//   gp[p, :] = sum_k sum_(sy,sx) [key[k, p-(sy,sx)] == (sy+r)(2r+1)+(sx+r)]
//                                 * g[k, p-(sy,sx), :]
// over |sy|, |sx| <= r with sy^2 + sx^2 <= disk_r2, where
// key[k, q] = (tys[k,q] - qy + r)(2r+1) + (txs[k,q] - qx + r) is the
// fused offset of tap k at source pixel q.
//
// Replaces the Pallas TPU kernel tpu_restir/kernels/local_gather.py
// `_scatter_kernel` (the custom VJP of gather_local). On the TPU a
// scatter-add moves about one element per cycle, so that kernel DMAs a
// halo window of g and of the keys per output tile into VMEM and sums,
// for every destination pixel, the taps that landed on it: a gather-form
// transpose with no write collisions.
//
// What bounds it on the H100: the key compares and the bytes. At 1080p
// with K = 5, r = 5, disk_r2 = 30 (97 of the 121 offsets) every
// destination pixel reads 485 keys (L1/L2 hits: neighbouring threads read
// neighbouring keys) and, on average, K rows of g (each source row matches
// exactly one destination). g is read once in all (1.0 GB at C = 24), the
// output written once (0.2 GB): about 0.4 ms at the 3.35 TB/s peak.
//
// Design: a first small kernel builds the (K, H, W) int32 keys and traps
// on a tap whose offset lies outside the window (|dy| or |dx| > r, or
// dy^2 + dx^2 > disk_r2): the gather (K3) has no window, so nothing else
// enforces the bound, and without the trap that tap's cotangent would be
// dropped silently. Then one thread per destination pixel walks the
// offsets in a fixed order (k, then sy, then sx), so the sum is
// deterministic and needs no atomics, and keeps the C sums in registers
// (float4 chunks, C / 4 <= 8 of them, when C % 4 == 0 and the buffers are
// 16-byte aligned; one thread per (pixel, channel) otherwise). A warp is
// 32 consecutive pixels of a row, so each key read is one coalesced
// 128-byte load shared by the whole offset loop.
//
// C interface (ctypes): each entry returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void scatter_keys_kernel(const int* __restrict__ tys,
                                    const int* __restrict__ txs, int h, int w,
                                    int r, int disk_r2, long long n,
                                    int* __restrict__ keys) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long pix = i % ((long long)h * w);
  const int y = (int)(pix / w);
  const int x = (int)(pix % w);
  const int dy = tys[i] - y;
  const int dx = txs[i] - x;
  if (dy < -r || dy > r || dx < -r || dx > r || dy * dy + dx * dx > disk_r2)
    __trap();
  keys[i] = (dy + r) * (2 * r + 1) + (dx + r);
}

template <int kNV>
__global__ void scatter_vec4_kernel(const float* __restrict__ g,
                                    const int* __restrict__ keys, int k_taps,
                                    int h, int w, int r, int disk_r2,
                                    float* __restrict__ out) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long hw = (long long)h * w;
  if (p >= hw) return;
  const int py = (int)(p / w);
  const int px = (int)(p % w);
  const int kw = 2 * r + 1;
  float4 acc[kNV];
#pragma unroll
  for (int q = 0; q < kNV; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < k_taps; ++k) {
    const int* kk = keys + k * hw;
    const float4* gk = reinterpret_cast<const float4*>(g + k * hw * 4 * kNV);
    for (int sy = -r; sy <= r; ++sy) {
      const int qy = py - sy;
      if (qy < 0 || qy >= h) continue;
      for (int sx = -r; sx <= r; ++sx) {
        if (sy * sy + sx * sx > disk_r2) continue;
        const int qx = px - sx;
        if (qx < 0 || qx >= w) continue;
        const long long q = (long long)qy * w + qx;
        if (kk[q] != (sy + r) * kw + (sx + r)) continue;
        const float4* src = gk + q * kNV;
#pragma unroll
        for (int c = 0; c < kNV; ++c) {
          const float4 v = src[c];
          acc[c].x += v.x;
          acc[c].y += v.y;
          acc[c].z += v.z;
          acc[c].w += v.w;
        }
      }
    }
  }
  float4* o = reinterpret_cast<float4*>(out) + p * kNV;
#pragma unroll
  for (int c = 0; c < kNV; ++c) o[c] = acc[c];
}

__global__ void scatter_scalar_kernel(const float* __restrict__ g,
                                      const int* __restrict__ keys,
                                      int k_taps, int h, int w, int c_ch,
                                      int r, int disk_r2,
                                      float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long hw = (long long)h * w;
  if (i >= hw * c_ch) return;
  const long long p = i / c_ch;
  const int ch = (int)(i % c_ch);
  const int py = (int)(p / w);
  const int px = (int)(p % w);
  const int kw = 2 * r + 1;
  float acc = 0.f;
  for (int k = 0; k < k_taps; ++k) {
    const int* kk = keys + k * hw;
    for (int sy = -r; sy <= r; ++sy) {
      const int qy = py - sy;
      if (qy < 0 || qy >= h) continue;
      for (int sx = -r; sx <= r; ++sx) {
        if (sy * sy + sx * sx > disk_r2) continue;
        const int qx = px - sx;
        if (qx < 0 || qx >= w) continue;
        const long long q = (long long)qy * w + qx;
        if (kk[q] != (sy + r) * kw + (sx + r)) continue;
        acc += g[(k * hw + q) * c_ch + ch];
      }
    }
  }
  out[i] = acc;
}

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// keys (K, H, W) int32 from tap coordinates tys/txs (K, H, W) int32.
int local_scatter_keys(const void* tys, const void* txs, int k_taps, int h,
                       int w, int r, int disk_r2, void* keys, void* stream) {
  const long long n = (long long)k_taps * h * w;
  scatter_keys_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)tys, (const int*)txs, h, w, r, disk_r2, n, (int*)keys);
  return (int)cudaGetLastError();
}

// out (H, W, C) float32 from g (K, H, W, C) float32 and the keys.
int local_scatter(const void* g, const void* keys, int k_taps, int h, int w,
                  int c_ch, int r, int disk_r2, int vec4, void* out,
                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long hw = (long long)h * w;
  const float* gf = (const float*)g;
  const int* kk = (const int*)keys;
  float* o = (float*)out;
  if (vec4 && c_ch % 4 == 0 && c_ch / 4 >= 1 && c_ch / 4 <= 8) {
    const unsigned b = blocks_for(hw);
    switch (c_ch / 4) {
#define K4_CASE(NV)                                                       \
  case NV:                                                                \
    scatter_vec4_kernel<NV><<<b, kThreads, 0, s>>>(gf, kk, k_taps, h, w,  \
                                                   r, disk_r2, o);        \
    break;
      K4_CASE(1) K4_CASE(2) K4_CASE(3) K4_CASE(4)
      K4_CASE(5) K4_CASE(6) K4_CASE(7) K4_CASE(8)
#undef K4_CASE
    }
  } else {
    scatter_scalar_kernel<<<blocks_for(hw * c_ch), kThreads, 0, s>>>(
        gf, kk, k_taps, h, w, c_ch, r, disk_r2, o);
  }
  return (int)cudaGetLastError();
}

const char* local_scatter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

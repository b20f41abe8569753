// Transpose of the per-pixel tap gather (K4): the payload cotangent
//   gp[p, :] = sum_k sum_(sy,sx) [tap k of source p-(sy,sx) lands on p]
//                                 * g[k, p-(sy,sx), :]
// over |sy|, |sx| <= r with sy^2 + sx^2 <= disk_r2, summed per destination
// in the order k, then sy, then sx (ascending), from 0.
//
// Replaces the Pallas TPU kernel tpu_restir/kernels/local_gather.py
// `_scatter_kernel` (the custom VJP of gather_local). On the TPU a
// scatter-add moves about one element per cycle, so that kernel DMAs a
// halo window of g and of the tap offsets per output tile into VMEM and
// sums, for every destination pixel, the taps that landed on it: a
// gather-form transpose with no write collisions.
//
// What bounds it on the H100: the bytes. At 1080p with K = 5, r = 5,
// disk_r2 = 30 each source row of g (C floats) lands on exactly one
// destination, so g is read once (1.0 GB at C = 24), the taps once and the
// output written once (0.2 GB): about 0.4 ms at the 3.35 TB/s peak. The
// rows a destination sums lie at scattered sources of its window, so what
// stands between the kernel and that bound is the latency of those loads.
//
// Design: one block of 256 threads per 32 x 8 tile of destinations, one
// thread a destination.
//   1. Masks. The block reads the tap coordinates of its halo (the tile
//      widened by r on every side; coalesced rows) and, for each source
//      whose tap lands in the tile, sets bit (dy + r)(2r + 1) + (dx + r) of
//      that destination's mask for tap k in shared memory (words of
//      consecutive destinations adjacent: no bank conflicts on reading).
//      A tap whose offset lies outside the window (|dy| or |dx| > r, or
//      dy^2 + dx^2 > disk_r2) traps: the gather (K3) has no window, so
//      nothing else enforces the bound, and without the trap that tap's
//      cotangent would be dropped silently. Up to 40 KB of masks at a
//      time; more taps run in chunks of k, in order.
//   2. Sums. Each thread walks its set bits in ascending order, k by k:
//      exactly the (k, sy, sx) order of the offsets, so the sum is the
//      same, bit for bit, as a scan of every offset (the kernel before this
//      design), and needs no atomics. Matches go into batches of kNB rows
//      in registers; each batch's row loads are issued back to back
//      (float4, C / 4 <= 8 of them a row, when C % 4 == 0 and the buffers
//      are 16-byte aligned) and added in list order, so their latencies
//      overlap. A list may hold up to K (2r + 1)^2 rows (screen clamping
//      piles the taps of edge pixels onto the edge): the batches cover any
//      length. Without float4 (C % 4 != 0), the thread sums channel by
//      channel, one bit walk each.
//
// C interface (ctypes): the entry returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kTW = 32;                 // tile width (a warp)
constexpr int kTH = 8;                  // tile height
constexpr int kThreads = kTW * kTH;
constexpr int kMaskBytes = 40 * 1024;   // shared memory of masks at a time

struct Tile {
  int y0, x0;        // tile origin
  int h, w, r, disk_r2;
  int words;         // 32-bit words of a destination's mask for one tap
};

// Step 1: the masks of taps [k0, k0 + nk) for the block's tile, laid out
// mask[(kk * words + word) * kThreads + destination].
__device__ void build_masks(const int* __restrict__ tys,
                            const int* __restrict__ txs, int k0, int nk,
                            const Tile& t, unsigned* mask) {
  for (int i = threadIdx.x; i < nk * t.words * kThreads; i += kThreads)
    mask[i] = 0u;
  __syncthreads();
  const int kw = 2 * t.r + 1;
  const int hh = kTH + 2 * t.r;
  const int ww = kTW + 2 * t.r;
  const int n_halo = nk * hh * ww;
  const long long hw = (long long)t.h * t.w;
  constexpr int kU = 4;   // halo entries a thread loads before using them
  for (int base = 0; base < n_halo; base += kU * kThreads) {
    int ty[kU], tx[kU], qy[kU], qx[kU], kk[kU];
    bool ok[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      kk[u] = i / (hh * ww);
      const int rem = i - kk[u] * hh * ww;
      qy[u] = t.y0 - t.r + rem / ww;
      qx[u] = t.x0 - t.r + rem % ww;
      ok[u] = i < n_halo && qy[u] >= 0 && qy[u] < t.h && qx[u] >= 0 &&
              qx[u] < t.w;
      if (ok[u]) {
        const long long q = (long long)(k0 + kk[u]) * hw +
                            (long long)qy[u] * t.w + qx[u];
        ty[u] = __ldg(tys + q);
        tx[u] = __ldg(txs + q);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (!ok[u]) continue;
      const int dy = ty[u] - qy[u];
      const int dx = tx[u] - qx[u];
      if (dy < -t.r || dy > t.r || dx < -t.r || dx > t.r ||
          dy * dy + dx * dx > t.disk_r2)
        __trap();
      const int ly = ty[u] - t.y0;
      const int lx = tx[u] - t.x0;
      if (ly < 0 || ly >= kTH || lx < 0 || lx >= kTW) continue;
      const int code = (dy + t.r) * kw + (dx + t.r);
      atomicOr(&mask[(kk[u] * t.words + (code >> 5)) * kThreads +
                     ly * kTW + lx],
               1u << (code & 31));
    }
  }
  __syncthreads();
}

// Taps per chunk of masks.
__host__ __device__ inline int chunk_taps(int words) {
  const int per_tap = words * kThreads * 4;
  return kMaskBytes / per_tap > 0 ? kMaskBytes / per_tap : 1;
}

// Step 2, float4 rows: load the n <= kNB rows of the batch back to back,
// then add them in list order.
template <int kNV, int kNB>
__device__ __forceinline__ void add_rows(const float4* __restrict__ g4,
                                         const long long (&src)[kNB], int n,
                                         float4 (&acc)[kNV]) {
  float4 v[kNB][kNV];
#pragma unroll
  for (int b = 0; b < kNB; ++b)
    if (b < n) {
#pragma unroll
      for (int c = 0; c < kNV; ++c) v[b][c] = __ldg(g4 + src[b] + c);
    }
#pragma unroll
  for (int b = 0; b < kNB; ++b)
    if (b < n) {
#pragma unroll
      for (int c = 0; c < kNV; ++c) {
        acc[c].x += v[b][c].x;
        acc[c].y += v[b][c].y;
        acc[c].z += v[b][c].z;
        acc[c].w += v[b][c].w;
      }
    }
}

template <int kNV>
__global__ void __launch_bounds__(kThreads, 2)
    scatter_vec4_kernel(const float* __restrict__ g,
                        const int* __restrict__ tys,
                        const int* __restrict__ txs, int k_taps, Tile t,
                        float* __restrict__ out) {
  // batch rows: about 8 float4 loads in flight a thread, so that two
  // blocks fit an SM (128 registers)
  constexpr int kNB = 8 / kNV > 1 ? 8 / kNV : 1;
  extern __shared__ unsigned mask[];
  t.y0 = blockIdx.y * kTH;
  t.x0 = blockIdx.x * kTW;
  const int py = t.y0 + threadIdx.x / kTW;
  const int px = t.x0 + threadIdx.x % kTW;
  const bool inside = py < t.h && px < t.w;
  const int kw = 2 * t.r + 1;
  const long long hw = (long long)t.h * t.w;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4 acc[kNV];
#pragma unroll
  for (int c = 0; c < kNV; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int chunk = chunk_taps(t.words);
  for (int k0 = 0; k0 < k_taps; k0 += chunk) {
    const int nk = min(chunk, k_taps - k0);
    build_masks(tys, txs, k0, nk, t, mask);
    if (inside) {
      long long src[kNB];
      int n = 0;
      for (int kk = 0; kk < nk; ++kk)
        for (int wd = 0; wd < t.words; ++wd) {
          unsigned bits = mask[(kk * t.words + wd) * kThreads + threadIdx.x];
          while (bits) {
            const int code = wd * 32 + __ffs(bits) - 1;
            bits &= bits - 1;
            const int sy = code / kw - t.r;
            const int sx = code % kw - t.r;
            const long long row = (long long)(k0 + kk) * hw +
                                  (long long)(py - sy) * t.w + (px - sx);
            // src[n] = row * kNV, without a dynamic register index
#pragma unroll
            for (int b = 0; b < kNB; ++b)
              if (b == n) src[b] = row * kNV;
            if (++n == kNB) {
              add_rows<kNV, kNB>(g4, src, n, acc);
              n = 0;
            }
          }
        }
      add_rows<kNV, kNB>(g4, src, n, acc);
    }
    __syncthreads();   // every thread has read the masks of this chunk
  }
  if (inside) {
    float4* o = reinterpret_cast<float4*>(out) + ((long long)py * t.w + px) *
                                                     kNV;
#pragma unroll
    for (int c = 0; c < kNV; ++c) o[c] = acc[c];
  }
}

__global__ void __launch_bounds__(kThreads)
    scatter_scalar_kernel(const float* __restrict__ g,
                          const int* __restrict__ tys,
                          const int* __restrict__ txs, int k_taps, int c_ch,
                          Tile t, float* __restrict__ out) {
  extern __shared__ unsigned mask[];
  t.y0 = blockIdx.y * kTH;
  t.x0 = blockIdx.x * kTW;
  const int py = t.y0 + threadIdx.x / kTW;
  const int px = t.x0 + threadIdx.x % kTW;
  const bool inside = py < t.h && px < t.w;
  const int kw = 2 * t.r + 1;
  const long long hw = (long long)t.h * t.w;
  float* o = out + ((long long)py * t.w + px) * c_ch;
  if (inside)
    for (int ch = 0; ch < c_ch; ++ch) o[ch] = 0.f;
  const int chunk = chunk_taps(t.words);
  for (int k0 = 0; k0 < k_taps; k0 += chunk) {
    const int nk = min(chunk, k_taps - k0);
    build_masks(tys, txs, k0, nk, t, mask);
    if (inside)
      for (int ch = 0; ch < c_ch; ++ch) {
        float acc = o[ch];
        for (int kk = 0; kk < nk; ++kk)
          for (int wd = 0; wd < t.words; ++wd) {
            unsigned bits =
                mask[(kk * t.words + wd) * kThreads + threadIdx.x];
            while (bits) {
              const int code = wd * 32 + __ffs(bits) - 1;
              bits &= bits - 1;
              const int sy = code / kw - t.r;
              const int sx = code % kw - t.r;
              const long long row = (long long)(k0 + kk) * hw +
                                    (long long)(py - sy) * t.w + (px - sx);
              acc += __ldg(g + row * c_ch + ch);
            }
          }
        o[ch] = acc;
      }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// out (H, W, C) float32 from g (K, H, W, C) float32 and the tap coordinates
// tys/txs (K, H, W) int32; r <= 8 (the gather's window bound).
int local_scatter(const void* g, const void* tys, const void* txs, int k_taps,
                  int h, int w, int c_ch, int r, int disk_r2, int vec4,
                  void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Tile t;
  t.y0 = t.x0 = 0;
  t.h = h;
  t.w = w;
  t.r = r;
  t.disk_r2 = disk_r2;
  t.words = ((2 * r + 1) * (2 * r + 1) + 31) / 32;
  const int chunk = chunk_taps(t.words);
  const size_t smem = (size_t)(k_taps < chunk ? k_taps : chunk) * t.words *
                      kThreads * sizeof(unsigned);
  const dim3 grid((w + kTW - 1) / kTW, (h + kTH - 1) / kTH);
  const float* gf = (const float*)g;
  const int* ty = (const int*)tys;
  const int* tx = (const int*)txs;
  float* o = (float*)out;
  if (vec4 && c_ch % 4 == 0 && c_ch / 4 >= 1 && c_ch / 4 <= 8) {
    switch (c_ch / 4) {
#define K4_CASE(NV)                                                    \
  case NV:                                                             \
    scatter_vec4_kernel<NV><<<grid, kThreads, smem, s>>>(gf, ty, tx,   \
                                                         k_taps, t, o); \
    break;
      K4_CASE(1) K4_CASE(2) K4_CASE(3) K4_CASE(4)
      K4_CASE(5) K4_CASE(6) K4_CASE(7) K4_CASE(8)
#undef K4_CASE
    }
  } else {
    scatter_scalar_kernel<<<grid, kThreads, smem, s>>>(gf, ty, tx, k_taps,
                                                       c_ch, t, o);
  }
  return (int)cudaGetLastError();
}

const char* local_scatter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

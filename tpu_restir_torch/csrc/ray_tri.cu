// Ray x triangle queries for small scenes: closest hit (K1) and any hit
// (K2) by the Woop affine test, every ray against every triangle.
//
// Replaces the Pallas TPU kernels tpu_restir/kernels/ray_tri.py
// `_closest_kernel` (closest_hit) and `_any_kernel` (any_hit). The TPU
// versions tile 8192 rays channels-first per grid step and hold the
// triangles' Woop rows in SMEM as scalars.
//
// What bounds it on the H100: instruction issue. One test is 40 float32
// operations, each its own instruction under --fmad=false, plus an IEEE
// division (~15 instructions with its range check and branch), the
// compares and the delivery of the triangle's 12 coefficients; against 33
// bytes of ray data read once per ray, so memory is no limit. A scheduler
// issues one warp instruction a clock, so the instruction count per test,
// not the float32 lanes, sets the time.
//
// Design. The triangles' Woop rows are staged in shared memory in tiles of
// at most 512 rows (24 KB); every thread of a warp reads the same row at
// once, a broadcast without bank conflicts. Tail threads (past the last
// ray) still take part in the tile barriers.
// K1 (closest hit): one thread per ray; ray and running result in
// registers; twelve 4-byte loads a row. (Three float4 loads, as K2's, made
// it slower on the card: 44 registers against 37, five blocks an SM
// against six.)
// K2 (any hit), with fewer instructions a test than K1's loop:
// - each thread holds kAnyRays adjacent rays and reads a row as three
//   16-byte broadcasts (not twelve 4-byte loads), so one fetch serves two
//   tests and their divisions are independent work in flight;
// - a ray's [tnear, tfar] is folded once (fold_range), so that the two
//   range compares also reject t = +-inf and NaN (no isfinite), and a dead
//   ray (tnear > tfar or NaN) gets an empty range;
// - per row, t = -ow/dw comes first; where no lane of the warp has a t in
//   range (and |dw| > 1e-18), the warp skips u, v and their compares,
//   which cannot change a mask: the range is a conjunct of the test (a
//   wall's plane lies beyond the ends of every segment inside the room);
// - rows go in unrolled groups of kAnyRows, their t halves first, and the
//   warp leaves once all its rays are occluded or dead (one vote a group);
// - per-ray state is a bit mask, not bools (no byte shuffling);
// - blocks of 128 threads, not 256: a finer last wave.
// Kept out, slower on the card in exploratory runs: the rows in
// __constant__ memory (indexed by the warp-uniform row), one wave of
// persistent blocks with equal shares (the shadow query's dead rays make
// the shares unequal), 1, 3 or 4 rays a thread.
//
// Rounding: the test keeps the operation order of `_woop_tuvok`, and this
// file is compiled with --fmad=false, so every product and sum rounds on
// its own as in the plain PyTorch version (kernels/ray_tri.py); contracted
// multiply-adds would flip hit ids and occlusion on rays that graze shared
// edges. The division is IEEE (no fast math).
//
// C interface (ctypes): every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kTileRows = 512;   // Woop rows per shared-memory tile
constexpr int kThreads = 256;    // closest-hit kernel: threads per block
constexpr int kAnyRays = 2;      // any-hit kernel: rays per thread,
constexpr int kAnyRows = 4;      // rows per group,
constexpr int kAnyThreads = 128; // threads per block
constexpr float kBaryEps = 1e-5f;
constexpr float kBaryMax = (float)(1.0 + 1e-5);
constexpr float kMinDw = 1e-18f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, tn, tf;
};

__device__ __forceinline__ Ray load_ray(const float* o, const float* d,
                                        const float* tnear, const float* tfar,
                                        long long i) {
  Ray r;
  r.ox = o[3 * i]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
  r.dx = d[3 * i]; r.dy = d[3 * i + 1]; r.dz = d[3 * i + 2];
  r.tn = tnear[i]; r.tf = tfar[i];
  return r;
}

// K2's row p = (x, y, z, c) of the Woop map: its affine value at the ray
// origin and its linear part along the direction, in _woop_tuvok's order.
__device__ __forceinline__ float aff(const Ray& r, float4 p) {
  return r.ox * p.x + r.oy * p.y + r.oz * p.z + p.w;
}
__device__ __forceinline__ float lin(const Ray& r, float4 p) {
  return r.dx * p.x + r.dy * p.y + r.dz * p.z;
}

// One triangle's (t, u, v, ok); w points at its 12 Woop floats (rows
// u, v, w of the 3x4 map). The order of operations is _woop_tuvok's.
__device__ __forceinline__ bool woop_test(const Ray& r, const float* w,
                                          float& t, float& u, float& v) {
  float ow = r.ox * w[8] + r.oy * w[9] + r.oz * w[10] + w[11];
  float dw = r.dx * w[8] + r.dy * w[9] + r.dz * w[10];
  t = fabsf(dw) > kMinDw ? -ow / dw : INFINITY;
  u = (r.ox * w[0] + r.oy * w[1] + r.oz * w[2] + w[3])
      + t * (r.dx * w[0] + r.dy * w[1] + r.dz * w[2]);
  v = (r.ox * w[4] + r.oy * w[5] + r.oz * w[6] + w[7])
      + t * (r.dx * w[4] + r.dy * w[5] + r.dz * w[6]);
  return (u >= -kBaryEps) && (v >= -kBaryEps) && (u + v <= kBaryMax) &&
         isfinite(t) && (t >= r.tn) && (t <= r.tf);
}

// Stage rows [base, base + n) of the (T, 12) table into shared memory.
__device__ __forceinline__ void stage_tile(float* tile, const float* woop,
                                           int base, int n) {
  for (int k = threadIdx.x; k < n * 12; k += blockDim.x)
    tile[k] = woop[base * 12 + k];
}

__global__ void closest_kernel(const float* __restrict__ o,
                               const float* __restrict__ d,
                               const float* __restrict__ tnear,
                               const float* __restrict__ tfar,
                               const float* __restrict__ woop, long long n_rays,
                               int n_tris, float* __restrict__ t_out,
                               float* __restrict__ u_out,
                               float* __restrict__ v_out,
                               int* __restrict__ tri_out) {
  __shared__ float tile[kTileRows * 12];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n_rays;
  Ray r = {};
  if (live) r = load_ray(o, d, tnear, tfar, i);
  float bt = INFINITY, bu = 0.f, bv = 0.f;
  int btri = -1;
  for (int base = 0; base < n_tris; base += kTileRows) {
    const int n = min(kTileRows, n_tris - base);
    __syncthreads();
    stage_tile(tile, woop, base, n);
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      float t, u, v;
      // strictly closer only: a tie keeps the lowest triangle index
      if (woop_test(r, tile + 12 * j, t, u, v) && t < bt) {
        bt = t; bu = u; bv = v; btri = base + j;
      }
    }
  }
  if (live) {
    t_out[i] = btri >= 0 ? bt : INFINITY;
    u_out[i] = bu;
    v_out[i] = bv;
    tri_out[i] = btri;
  }
}

// Fold [tn, tf] so that tn <= t <= tf alone gives the test's
// isfinite(t) && t >= tnear && t <= tfar: for tnear <= tfar (no NaN),
// clamping the bounds to the finite range rejects t = +-inf and changes no
// verdict on a finite t; a NaN t fails every compare. A ray with
// tnear > tfar, or a NaN bound, can satisfy no t: it gets [inf, -inf].
__device__ __forceinline__ void fold_range(Ray& r) {
  if (r.tn <= r.tf) {
    r.tn = fmaxf(r.tn, -FLT_MAX);
    r.tf = fminf(r.tf, FLT_MAX);
  } else {
    r.tn = INFINITY;
    r.tf = -INFINITY;
  }
}

// G Woop rows against a thread's rays: clears bit q of `open` where ray q
// is occluded. The t halves of the G rows come first (independent work
// in flight); each row's u, v half then runs only where some lane of the
// warp has a t in range (warp-uniform; all lanes call this together).
template <int G>
__device__ __forceinline__ void any_rows(const Ray (&r)[kAnyRays],
                                         const float4* rows, unsigned& open) {
  float t[G][kAnyRays];
  unsigned in_range[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float4 c = rows[3 * g + 2];
    in_range[g] = 0;
#pragma unroll
    for (int q = 0; q < kAnyRays; ++q) {
      const float dw = lin(r[q], c);
      const bool ok_dw = fabsf(dw) > kMinDw;
      // |dw| <= 1e-18 fails the test whatever t is (the plain version's
      // t = inf); divide by 1 there, off the division's slow path
      t[g][q] = -aff(r[q], c) / (ok_dw ? dw : 1.f);
      if (ok_dw & (t[g][q] >= r[q].tn) & (t[g][q] <= r[q].tf))
        in_range[g] |= 1u << q;
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const unsigned test = in_range[g] & open;
    if (!__any_sync(0xffffffffu, test)) continue;
    const float4 a = rows[3 * g], b = rows[3 * g + 1];
    unsigned hit = 0;
#pragma unroll
    for (int q = 0; q < kAnyRays; ++q) {
      const float u = aff(r[q], a) + t[g][q] * lin(r[q], a);
      const float v = aff(r[q], b) + t[g][q] * lin(r[q], b);
      if ((u >= -kBaryEps) & (v >= -kBaryEps) & (u + v <= kBaryMax))
        hit |= 1u << q;
    }
    open &= ~(hit & test);
  }
}

// kAnyRays adjacent rays a thread; bit q of a mask stands for ray q. Rows
// go in groups of kAnyRows (any_rows), the warp's exit test once a group.
__global__ void __launch_bounds__(kAnyThreads)
any_kernel(const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ tnear, const float* __restrict__ tfar,
           const float* __restrict__ woop, long long n_rays, int n_tris,
           bool* __restrict__ occ_out) {
  __shared__ float4 tile[kTileRows * 3];
  const long long first =
      ((long long)blockIdx.x * kAnyThreads + threadIdx.x) * kAnyRays;
  Ray r[kAnyRays];
  unsigned live = 0;   // in the query with a non-empty range
#pragma unroll
  for (int q = 0; q < kAnyRays; ++q) {
    r[q] = first + q < n_rays ? load_ray(o, d, tnear, tfar, first + q)
                              : Ray{0, 0, 0, 0, 0, 0, 1.f, 0.f};
    fold_range(r[q]);
    if (r[q].tn <= r[q].tf) live |= 1u << q;
  }
  unsigned open = live;   // live and not yet found occluded
  for (int base = 0; base < n_tris; base += kTileRows) {
    const int n = min(kTileRows, n_tris - base);
    __syncthreads();
    stage_tile(reinterpret_cast<float*>(tile), woop, base, n);
    __syncthreads();
    int j = 0;
    for (; j + kAnyRows <= n; j += kAnyRows) {
      if (!__any_sync(0xffffffffu, open)) break;   // warp-uniform
      any_rows<kAnyRows>(r, tile + 3 * j, open);
    }
    for (; j < n && __any_sync(0xffffffffu, open); ++j)
      any_rows<1>(r, tile + 3 * j, open);
  }
#pragma unroll
  for (int q = 0; q < kAnyRays; ++q)
    if (first + q < n_rays) occ_out[first + q] = (live & ~open) >> q & 1u;
}

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int ray_tri_closest(const void* o, const void* d, const void* tnear,
                    const void* tfar, const void* woop, long long n_rays,
                    int n_tris, void* t, void* u, void* v, void* tri,
                    void* stream) {
  closest_kernel<<<blocks_for(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)o, (const float*)d, (const float*)tnear,
      (const float*)tfar, (const float*)woop, n_rays, n_tris, (float*)t,
      (float*)u, (float*)v, (int*)tri);
  return (int)cudaGetLastError();
}

int ray_tri_any(const void* o, const void* d, const void* tnear,
                const void* tfar, const void* woop, long long n_rays, int n_tris,
                void* occ, void* stream) {
  const long long per_block = (long long)kAnyThreads * kAnyRays;
  any_kernel<<<(unsigned)((n_rays + per_block - 1) / per_block), kAnyThreads,
               0, (cudaStream_t)stream>>>(
      (const float*)o, (const float*)d, (const float*)tnear,
      (const float*)tfar, (const float*)woop, n_rays, n_tris, (bool*)occ);
  return (int)cudaGetLastError();
}

const char* ray_tri_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

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
// division (~10 instructions with its range check and branch), the
// compares and the delivery of the triangle's 12 coefficients; against 33
// bytes of ray data read once per ray, so memory is no limit. A scheduler
// issues one warp instruction a clock, so the instruction count per test,
// not the float32 lanes, sets the time.
//
// Design. The triangles' Woop rows are staged in shared memory in tiles of
// at most 512 rows (24 KB); every thread of a warp reads the same row at
// once, as three 16-byte broadcasts without bank conflicts. Tail threads
// (past the last ray) still take part in the tile barriers. Both kernels
// cut the instructions a test issues the same ways:
// - a ray's [tnear, tfar] is folded once (fold_range), so that the two
//   range compares also reject t = +-inf and NaN (no isfinite), and a dead
//   ray (tnear > tfar or NaN) gets an empty range;
// - per row, t = -ow/dw comes first; where no lane of the warp has a t in
//   range (and |dw| > 1e-18; for closest hit also below the ray's best t),
//   the warp skips u, v and their compares, which cannot change a result:
//   these are conjuncts of the test (K2: a wall's plane lies beyond the
//   ends of every segment inside the room; K1: the planes behind the
//   camera and behind the nearest wall found so far);
// - rows go in unrolled groups of four, their t halves first, so that
//   four divisions are independent work in flight;
// - blocks of 128 threads, not 256: a finer last wave.
// K1 (closest hit): one ray a thread, its running (t, u, v, id) in
// registers; only the scene's rows are staged (dynamic shared memory: 36
// rows, 1.7 KB, on the Cornell box), in triangle order, so that a tie
// keeps the lowest id by the strict <. After t, u comes, and where no lane
// with a t in range has u in [-1e-5, 1.001], which every hit needs, the
// warp skips v. Two rays a thread were slower on the card (58 registers
// against 36), and so were 256-thread blocks and groups of two or eight
// rows.
// K2 (any hit): two adjacent rays a thread, so one row fetch serves two
// tests; it leaves the row loop once all rays of the warp are occluded or
// dead (one vote a group) and keeps per-ray state as a bit mask, not bools
// (no byte shuffling). Kept out of K2, slower on the card in exploratory
// runs: the rows in __constant__ memory (indexed by the warp-uniform row),
// one wave of persistent blocks with equal shares (the shadow query's dead
// rays make the shares unequal), 1, 3 or 4 rays a thread.
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
constexpr int kThreads = 128;    // threads per block (both kernels)
constexpr int kRows = 4;         // rows per group (both kernels)
constexpr int kAnyRays = 2;      // K2: rays per thread (K1: one)
constexpr float kBaryEps = 1e-5f;
constexpr float kBaryMax = (float)(1.0 + 1e-5);
constexpr float kMinDw = 1e-18f;
// A hit needs u <= kUMax (K1's u-first skip): with v >= -1e-5,
// fl(u + v) >= fl(u - 1e-5) > 1.0009 > kBaryMax once u > 1.001, as
// rounding is monotone.
constexpr float kUMax = 1.001f;
constexpr unsigned kFull = 0xffffffffu;

struct Ray {
  float ox, oy, oz, dx, dy, dz, tn, tf;
};

struct Best {
  float t, u, v;
  int tri;
};

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

// Ray i, folded; a ray past n_rays is dead.
__device__ __forceinline__ Ray load_ray(const float* o, const float* d,
                                        const float* tnear, const float* tfar,
                                        long long n_rays, long long i) {
  Ray r{0, 0, 0, 0, 0, 0, 1.f, 0.f};
  if (i < n_rays) {
    r.ox = o[3 * i]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
    r.dx = d[3 * i]; r.dy = d[3 * i + 1]; r.dz = d[3 * i + 2];
    r.tn = tnear[i]; r.tf = tfar[i];
  }
  fold_range(r);
  return r;
}

// A Woop row p = (x, y, z, c): its affine value at the ray origin and its
// linear part along the direction, in _woop_tuvok's order.
__device__ __forceinline__ float aff(const Ray& r, float4 p) {
  return r.ox * p.x + r.oy * p.y + r.oz * p.z + p.w;
}
__device__ __forceinline__ float lin(const Ray& r, float4 p) {
  return r.dx * p.x + r.dy * p.y + r.dz * p.z;
}

// The t half of a triangle's Woop map (row c, the w component): t =
// -ow/dw, and whether t can belong to a hit: |dw| > 1e-18 and t in the
// folded range.
__device__ __forceinline__ bool t_in_range(const Ray& r, float4 c, float& t) {
  const float dw = lin(r, c);
  const bool ok_dw = fabsf(dw) > kMinDw;
  // |dw| <= 1e-18 fails the test whatever t is (the plain version's
  // t = inf); divide by 1 there, off the division's slow path
  t = -aff(r, c) / (ok_dw ? dw : 1.f);
  return ok_dw & (t >= r.tn) & (t <= r.tf);
}

// u (row a of the map) or v (row b) at t.
__device__ __forceinline__ float at(const Ray& r, float4 p, float t) {
  return aff(r, p) + t * lin(r, p);
}

// The barycentric test.
__device__ __forceinline__ bool bary_ok(float u, float v) {
  return (u >= -kBaryEps) & (v >= -kBaryEps) & (u + v <= kBaryMax);
}

// Stage rows [base, base + n) of the (T, 12) table into shared memory.
__device__ __forceinline__ void stage_tile(float* tile, const float* woop,
                                           int base, int n) {
  for (int k = threadIdx.x; k < n * 12; k += blockDim.x)
    tile[k] = woop[base * 12 + k];
}

// G Woop rows, triangles id0, id0 + 1, ..., against the thread's ray,
// folded into b in row order. The t halves of the G rows come first; a
// row's u then runs only where some lane of the warp has a t in range and
// below its ray's best t, and its v only where some such lane also has u
// in [-1e-5, kUMax]: conjuncts of the replacement, so no result can change
// (warp-uniform; all lanes call this together).
template <int G>
__device__ __forceinline__ void closest_rows(const Ray& r, const float4* rows,
                                             int id0, Best& b) {
  float t[G];
  bool in_range[G];
#pragma unroll
  for (int g = 0; g < G; ++g)
    in_range[g] = t_in_range(r, rows[3 * g + 2], t[g]);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const bool test = in_range[g] && t[g] < b.t;
    if (!__any_sync(kFull, test)) continue;
    // u first: the test asks u >= -1e-5, v >= -1e-5 and fl(u + v) <=
    // kBaryMax, so a hit needs -1e-5 <= u <= kUMax (a NaN u fails both)
    const float u = at(r, rows[3 * g], t[g]);
    const bool cand = test & (u >= -kBaryEps) & (u <= kUMax);
    if (!__any_sync(kFull, cand)) continue;
    const float v = at(r, rows[3 * g + 1], t[g]);
    // strictly closer only: a tie keeps the lowest triangle index
    if (cand && bary_ok(u, v)) b = Best{t[g], u, v, id0 + g};
  }
}

// K1: one ray a thread; the scene's rows in tiles of tile_rows =
// min(T, kTileRows) rows (dynamic shared memory), in groups of kRows.
__global__ void __launch_bounds__(kThreads)
closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ tnear,
               const float* __restrict__ tfar,
               const float* __restrict__ woop, long long n_rays, int n_tris,
               int tile_rows, float* __restrict__ t_out,
               float* __restrict__ u_out, float* __restrict__ v_out,
               int* __restrict__ tri_out) {
  extern __shared__ float4 scene_rows[];
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const Ray r = load_ray(o, d, tnear, tfar, n_rays, i);
  Best b{INFINITY, 0.f, 0.f, -1};
  for (int base = 0; base < n_tris; base += tile_rows) {
    const int n = min(tile_rows, n_tris - base);
    __syncthreads();
    stage_tile(reinterpret_cast<float*>(scene_rows), woop, base, n);
    __syncthreads();
    int j = 0;
    for (; j + kRows <= n; j += kRows)
      closest_rows<kRows>(r, scene_rows + 3 * j, base + j, b);
    for (; j < n; ++j) closest_rows<1>(r, scene_rows + 3 * j, base + j, b);
  }
  if (i < n_rays) {
    t_out[i] = b.t;
    u_out[i] = b.u;
    v_out[i] = b.v;
    tri_out[i] = b.tri;
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
    for (int q = 0; q < kAnyRays; ++q)
      if (t_in_range(r[q], c, t[g][q])) in_range[g] |= 1u << q;
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const unsigned test = in_range[g] & open;
    if (!__any_sync(kFull, test)) continue;
    const float4 a = rows[3 * g], b = rows[3 * g + 1];
    unsigned hit = 0;
#pragma unroll
    for (int q = 0; q < kAnyRays; ++q)
      if (bary_ok(at(r[q], a, t[g][q]), at(r[q], b, t[g][q])))
        hit |= 1u << q;
    open &= ~(hit & test);
  }
}

// K2: kAnyRays adjacent rays a thread; bit q of a mask stands for ray q.
// Rows go in groups of kRows (any_rows), the warp's exit test once a
// group.
__global__ void __launch_bounds__(kThreads)
any_kernel(const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ tnear, const float* __restrict__ tfar,
           const float* __restrict__ woop, long long n_rays, int n_tris,
           bool* __restrict__ occ_out) {
  __shared__ float4 tile[kTileRows * 3];
  const long long first =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kAnyRays;
  Ray r[kAnyRays];
  unsigned live = 0;   // in the query with a non-empty range
#pragma unroll
  for (int q = 0; q < kAnyRays; ++q) {
    r[q] = load_ray(o, d, tnear, tfar, n_rays, first + q);
    if (r[q].tn <= r[q].tf) live |= 1u << q;
  }
  unsigned open = live;   // live and not yet found occluded
  for (int base = 0; base < n_tris; base += kTileRows) {
    const int n = min(kTileRows, n_tris - base);
    __syncthreads();
    stage_tile(reinterpret_cast<float*>(tile), woop, base, n);
    __syncthreads();
    int j = 0;
    for (; j + kRows <= n; j += kRows) {
      if (!__any_sync(kFull, open)) break;   // warp-uniform
      any_rows<kRows>(r, tile + 3 * j, open);
    }
    for (; j < n && __any_sync(kFull, open); ++j)
      any_rows<1>(r, tile + 3 * j, open);
  }
#pragma unroll
  for (int q = 0; q < kAnyRays; ++q)
    if (first + q < n_rays) occ_out[first + q] = (live & ~open) >> q & 1u;
}

inline unsigned blocks_for(long long n_rays, int rays_per_thread) {
  const long long per_block = (long long)kThreads * rays_per_thread;
  return (unsigned)((n_rays + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

int ray_tri_closest(const void* o, const void* d, const void* tnear,
                    const void* tfar, const void* woop, long long n_rays,
                    int n_tris, void* t, void* u, void* v, void* tri,
                    void* stream) {
  const int tile_rows = n_tris < kTileRows ? n_tris : kTileRows;
  closest_kernel<<<blocks_for(n_rays, 1), kThreads,
                   tile_rows * 12 * sizeof(float), (cudaStream_t)stream>>>(
      (const float*)o, (const float*)d, (const float*)tnear,
      (const float*)tfar, (const float*)woop, n_rays, n_tris, tile_rows,
      (float*)t, (float*)u, (float*)v, (int*)tri);
  return (int)cudaGetLastError();
}

int ray_tri_any(const void* o, const void* d, const void* tnear,
                const void* tfar, const void* woop, long long n_rays, int n_tris,
                void* occ, void* stream) {
  any_kernel<<<blocks_for(n_rays, kAnyRays), kThreads, 0,
               (cudaStream_t)stream>>>(
      (const float*)o, (const float*)d, (const float*)tnear,
      (const float*)tfar, (const float*)woop, n_rays, n_tris, (bool*)occ);
  return (int)cudaGetLastError();
}

const char* ray_tri_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

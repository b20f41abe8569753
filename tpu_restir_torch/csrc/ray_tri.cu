// Ray x triangle queries for small scenes: closest hit and any hit by
// the Woop affine test, every ray against every triangle.
//
// Replaces the Pallas TPU kernels tpu_restir/kernels/ray_tri.py
// `_closest_kernel` (closest_hit) and `_any_kernel` (any_hit). The TPU
// versions tile 8192 rays channels-first per grid step and hold the
// triangles' Woop rows in SMEM as scalars.
//
// What bounds it on the H100: arithmetic. Each (ray, triangle) pair costs
// about 35 float32 operations against 40 bytes of ray data read once per
// ray; at 36 triangles and 2M rays that is ~2.5 GFLOP per query and
// ~80 MB of traffic, so the card's fp32 rate and not its memory bandwidth
// is the limit once enough rays are in flight.
//
// Design: one thread per ray, which keeps the ray and the running result
// in registers. The triangles' 12-float Woop rows are staged in shared
// memory in tiles of at most 512 rows (24 KB); every thread of a warp
// reads the same row at once, a broadcast without bank conflicts. No
// padding of the ray count: the tail is masked, and tail threads still
// take part in the tile barriers.
//
// Rounding: the test keeps the operation order of `_woop_tuvok`, and this
// file is compiled with --fmad=false, so every product and sum rounds on
// its own as in the plain PyTorch version (kernels/ray_tri.py); contracted
// multiply-adds would flip hit ids and occlusion on rays that graze shared
// edges. The division is IEEE (no fast math).
//
// C interface (ctypes): every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileRows = 512;   // Woop rows per shared-memory tile
constexpr int kThreads = 256;
constexpr float kBaryEps = 1e-5f;
constexpr float kBaryMax = (float)(1.0 + 1e-5);

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

// One triangle's (t, u, v, ok); w points at its 12 Woop floats (rows
// u, v, w of the 3x4 map). The order of operations is _woop_tuvok's.
__device__ __forceinline__ bool woop_test(const Ray& r, const float* w,
                                          float& t, float& u, float& v) {
  float ow = r.ox * w[8] + r.oy * w[9] + r.oz * w[10] + w[11];
  float dw = r.dx * w[8] + r.dy * w[9] + r.dz * w[10];
  t = fabsf(dw) > 1e-18f ? -ow / dw : INFINITY;
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

__global__ void any_kernel(const float* __restrict__ o,
                           const float* __restrict__ d,
                           const float* __restrict__ tnear,
                           const float* __restrict__ tfar,
                           const float* __restrict__ woop, long long n_rays,
                           int n_tris, bool* __restrict__ occ_out) {
  __shared__ float tile[kTileRows * 12];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n_rays;
  Ray r = {};
  if (live) r = load_ray(o, d, tnear, tfar, i);
  bool occ = false;
  for (int base = 0; base < n_tris; base += kTileRows) {
    const int n = min(kTileRows, n_tris - base);
    __syncthreads();
    stage_tile(tile, woop, base, n);
    __syncthreads();
    if (!live || occ) continue;
    for (int j = 0; j < n; ++j) {
      float t, u, v;
      if (woop_test(r, tile + 12 * j, t, u, v)) {
        occ = true;  // an OR: the first occluder decides
        break;
      }
    }
  }
  if (live) occ_out[i] = occ;
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
  any_kernel<<<blocks_for(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)o, (const float*)d, (const float*)tnear,
      (const float*)tfar, (const float*)woop, n_rays, n_tris, (bool*)occ);
  return (int)cudaGetLastError();
}

const char* ray_tri_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

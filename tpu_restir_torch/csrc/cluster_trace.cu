// Packet-shortlist cluster traversal for large scenes: K5 closest hit and
// K6 any hit of packets of 256 rays over their own front-to-back cluster
// shortlists (phase 1, `build_shortlists` in kernels/cluster_trace.py), by
// fused Moller-Trumbore, and their Woop variant K7/K8 (`ptrace_mxu`), the
// same traversal with K1's Woop test at factor 1.
//
// Replaces the Pallas TPU kernels tpu_restir/kernels/cluster_trace.py
// `_closest_kernel` (K5), `_any_kernel` (K6), `_closest_kernel_mxu` (K7)
// and `_any_kernel_mxu` (K8). The TPU versions loop over 8 or 32 packets
// per grid step, read shortlists and a packed (8, NB) box table from SMEM
// by scalar prefetch, DMA rounds of cluster blocks into VMEM double
// buffers and carry the mode-5 cull flags one round ahead; K7/K8 compute
// the Woop test of a round as two (256, 4) x (4, 3 * 128 * 2) matrix
// products on the MXU, then a lowest-lane argmin, and clamp the last slot
// to n - 1. None of that is needed here, and none of it changes a result.
//
// What bounds it on the H100: instruction issue. Each (ray, triangle) pair
// is a fused Moller-Trumbore test of ~46 float32 operations (K5/K6) or six
// 3- or 4-term dot products and the hit test, ~40 (K7/K8), and this file
// is compiled with --fmad=false, so they issue as separate multiplies and
// adds, beside the IEEE reciprocal, the compares, the fold and the loads
// of the triangle. The Woop products stay on the CUDA cores in float32:
// the TPU kernel asks for Precision.HIGHEST because bf16 products gave
// false hits, and TF32 keeps about as few mantissa bits, so the tensor
// cores would need a 3xTF32 split to be exact enough (a later redesign). A
// cluster block is 64 x 9 floats (2.3 KB), a Woop block 4 x 384 (6 KB); a
// 100k-triangle scene's blocks (3.6 or 4.8 MB) stay in the 50 MB L2, so
// device memory is not the limit. The other cost is divergence between
// packets: the work of a packet is its shortlist, from a few clusters to
// over a thousand.
//
// Design: one thread block per packet, one thread per ray; the block reads
// its own count, shortlist and entries. Per shortlist slot (an entry of a
// supercluster expands into F cluster slots) the block
//   1. votes on the early-out: closest hit stops once no ray's
//      min(best_t, tfar) reaches the slot's entry distance
//      (__syncthreads_or, the TPU kernel's packet watermark); any hit stops
//      once every ray is occluded or dead, tfar < tnear (__syncthreads_and,
//      its all-occluded exit);
//   2. in mode 5 (K6 above 64 clusters, K5 once superclusters expand;
//      never K7/K8, as on the TPU) votes on the per-ray slab test of the
//      slot's box with the TPU kernel's slack, and skips the slot only if
//      no ray is live, so every ray of a tested slot is tested, as on the
//      TPU;
//   3. stages the cluster's block in shared memory (a Moller-Trumbore row
//      padded to 12 floats, read as three 16-byte broadcasts; a Woop block
//      by float4 loads); each thread tests its ray against every row.
// The vote barriers also fence the tile: no thread overwrites it before
// every thread has finished the previous slot.
// K5 (closest hit, Moller-Trumbore) also works at the warp's grain inside
// the slot, where K6-K8 test every row:
//   - a warp none of whose rays can improve in the slot skips its rows
//     (the block vote's condition, per warp; K7 too);
//   - per row, u comes first (p, det, its reciprocal, tv and u: 24 of the
//     46 operations); a warp with no live ray whose u is in [0, 1] skips
//     q, v, t and the compares (why that is exact: closest_rows_mt);
//   - the reciprocal directions of the slab test only in mode 5.
// Kept out, slower on the card: two adjacent rays a thread (128-thread
// blocks; 72 registers against 48). Not tried: overlapping a slot's
// staging with the previous slot's tests (cp.async), since staging every
// block twice cost K5 no measurable time.
// The early-outs, the skips and the cull only skip work that cannot change
// a result, so the kernels must equal the plain versions
// `trace_closest_ref` / `trace_any_ref` (and `_mxu_ref`), which test every
// listed slot.
//
// Rounding: the tests keep `_mt_cluster`'s operation order, or K1's
// (`_woop_tuvok`: ((o_x w_0 + o_y w_1) + o_z w_2) + w_3; the direction
// without the translation), the division is IEEE and nothing contracts
// (--fmad=false), so t, u, v and the ids are bit-identical to the plain
// PyTorch versions. The running minimum replaces only on a strictly
// smaller t, in shortlist order and then row order: a tie goes to the
// earlier-listed cluster, then the lower row.
//
// C interface (ctypes): every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kP = 256;     // rays per packet == threads per block
constexpr int kMtRow = 12;  // floats per staged Moller-Trumbore row (9 + 3)
constexpr int kWoopB = 128;            // triangles per Woop block
constexpr int kWoopRow = 3 * kWoopB;   // floats per coefficient row (u|v|w)
constexpr int kWoopFloats = 4 * kWoopRow;
constexpr float kBaryEps = 1e-5f;
constexpr float kBaryMax = (float)(1.0 + 1e-5);
constexpr unsigned kFull = 0xffffffffu;

struct Ray {
  float ox, oy, oz, dx, dy, dz, tn, tf;
};

struct Best {
  float t, u, v;
  int tri;
};

struct Args {
  const float* o;          // (Rp*P, 3)
  const float* d;          // (Rp*P, 3)
  const float* tnear;      // (Rp*P,)
  const float* tfar;       // (Rp*P,)
  const int* count;        // (Rp,) shortlist entries per packet
  const int* shortlist;    // (Rp, S) (super)cluster ids, front to back
  const float* entry;      // (Rp, S) entry distances, ascending
  int n_super;             // S
  const float* bmin;       // (NB, 3) slab-cull boxes
  const float* bmax;
  int box_per_cluster;     // boxes per cluster (1) or per supercluster (0)
  const float* ctris;      // (C, B, 9) v0, e1, e2, or (C, 4, 384) Woop
  int n_clusters;          // C
  int block;               // B
  int factor;              // F
  int skip;                // 0: no cull, 5: per-ray slab cull
};

__device__ __forceinline__ Ray load_ray(const Args& a, long long i) {
  Ray r;
  r.ox = a.o[3 * i]; r.oy = a.o[3 * i + 1]; r.oz = a.o[3 * i + 2];
  r.dx = a.d[3 * i]; r.dy = a.d[3 * i + 1]; r.dz = a.d[3 * i + 2];
  r.tn = a.tnear[i]; r.tf = a.tfar[i];
  return r;
}

// The first half of `_mt_cluster` for one (ray, triangle) pair: p = d x e2,
// det, its reciprocal, tv = o - v0 and u. A staged row is x = (v0, e1.x),
// y = (e1.y, e1.z, e2.x, e2.y), z = (e2.z, padding).
struct MtHalf {
  float tvx, tvy, tvz, inv, u;
  bool ok_det;
};

__device__ __forceinline__ MtHalf mt_u(const Ray& r, float4 x, float4 y,
                                       float4 z) {
  const float px = r.dy * z.x - r.dz * y.w;
  const float py = r.dz * y.z - r.dx * z.x;
  const float pz = r.dx * y.w - r.dy * y.z;
  const float det = x.w * px + y.x * py + y.y * pz;
  MtHalf m;
  m.ok_det = fabsf(det) > 1e-18f;
  // |det| <= 1e-18 fails the test whatever u is (inv = 0, as in the plain
  // version); the reciprocal of 1 there keeps off the division's slow path
  const float inv = 1.0f / (m.ok_det ? det : 1.0f);
  m.inv = m.ok_det ? inv : 0.0f;
  m.tvx = r.ox - x.x;
  m.tvy = r.oy - x.y;
  m.tvz = r.oz - x.z;
  m.u = (m.tvx * px + m.tvy * py + m.tvz * pz) * m.inv;
  return m;
}

// The second half: q = tv x e1, v and t.
__device__ __forceinline__ void mt_vt(const Ray& r, const MtHalf& m,
                                      float4 x, float4 y, float4 z, float& v,
                                      float& t) {
  const float qx = m.tvy * y.y - m.tvz * y.x;
  const float qy = m.tvz * x.w - m.tvx * y.y;
  const float qz = m.tvx * y.x - m.tvy * x.w;
  v = (r.dx * qx + r.dy * qy + r.dz * qz) * m.inv;
  t = (y.z * qx + y.w * qy + z.x * qz) * m.inv;
}

// The whole fused Moller-Trumbore test of `_mt_cluster`.
__device__ __forceinline__ bool mt(const Ray& r, float4 x, float4 y,
                                   float4 z) {
  const MtHalf m = mt_u(r, x, y, z);
  float v, t;
  mt_vt(r, m, x, y, z, v, t);
  return m.ok_det && m.u >= 0.f && v >= 0.f && m.u + v <= 1.f &&
         t >= r.tn && t <= r.tf;
}

// Coefficient row k (x, y, z, translation) of component c (u, v, w) of lane
// j of a Woop block: w[k * kWoopRow + c * kWoopB + j].
__device__ __forceinline__ float aff(const Ray& r, const float* w) {
  return r.ox * w[0] + r.oy * w[kWoopRow] + r.oz * w[2 * kWoopRow] +
         w[3 * kWoopRow];
}

__device__ __forceinline__ float lin(const Ray& r, const float* w) {
  return r.dx * w[0] + r.dy * w[kWoopRow] + r.dz * w[2 * kWoopRow];
}

// The Woop test of lane j of a staged Woop block; the order is
// _woop_tuvok's.
__device__ __forceinline__ bool woop_test(const Ray& r, const float* tile,
                                          int j, float& t, float& u,
                                          float& v) {
  const float* wu = tile + j;
  const float* wv = tile + kWoopB + j;
  const float* ww = tile + 2 * kWoopB + j;
  const float ow = aff(r, ww);
  const float dw = lin(r, ww);
  t = fabsf(dw) > 1e-18f ? -ow / dw : INFINITY;
  u = aff(r, wu) + t * lin(r, wu);
  v = aff(r, wv) + t * lin(r, wv);
  return (u >= -kBaryEps) && (v >= -kBaryEps) && (u + v <= kBaryMax) &&
         isfinite(t) && (t >= r.tn) && (t <= r.tf);
}

// K5's rows: the thread's ray against the `rows` staged rows of cluster c,
// folded into b; `live` is false for a dead ray (tfar < tnear).
__device__ __forceinline__ void closest_rows_mt(const Ray& r, bool live,
                                                const float4* tile, int rows,
                                                int c, Best& b) {
  for (int j = 0; j < rows; ++j) {
    const float4 x = tile[3 * j], y = tile[3 * j + 1], z = tile[3 * j + 2];
    const MtHalf m = mt_u(r, x, y, z);
    const bool cand = live & m.ok_det & (m.u >= 0.f) & (m.u <= 1.f);
    // u first. The test asks ok_det, u >= 0, v >= 0 and fl(u + v) <= 1.
    // With v >= 0, fl(u + v) >= u, because rounding is monotone and
    // fl(u) = u; so a hit needs u <= 1 (and a NaN u fails u >= 0). A dead
    // ray (tfar < tnear) fails the t range. So where no lane has a live
    // ray with ok_det and 0 <= u <= 1, no ray of the warp hits this row,
    // and skipping q, v, t and the compares changes nothing.
    if (!__any_sync(kFull, cand)) continue;
    float v, t;
    mt_vt(r, m, x, y, z, v, t);
    if (cand && v >= 0.f && m.u + v <= 1.f && t >= r.tn && t <= r.tf &&
        t < b.t)
      b = Best{t, m.u, v, c * rows + j};
  }
}

// Safe reciprocal direction of `_ray_inv`: near-zero components become
// +-1e20 with the component's sign.
__device__ __forceinline__ float safe_inv(float c) {
  return fabsf(c) > 1e-20f ? 1.0f / c : (c >= 0.f ? 1e20f : -1e20f);
}

// `_slab_entry_exit` + `_slab_live`: can this ray enter box k before
// `upper`? Relative and absolute slack, so rounding cannot cull a graze.
__device__ __forceinline__ bool slab_live(const Ray& r, float ix, float iy,
                                          float iz, const float* bmin,
                                          const float* bmax, int k,
                                          float upper) {
  const float t1x = (bmin[3 * k] - r.ox) * ix;
  const float t2x = (bmax[3 * k] - r.ox) * ix;
  const float t1y = (bmin[3 * k + 1] - r.oy) * iy;
  const float t2y = (bmax[3 * k + 1] - r.oy) * iy;
  const float t1z = (bmin[3 * k + 2] - r.oz) * iz;
  const float t2z = (bmax[3 * k + 2] - r.oz) * iz;
  const float tent = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                           fmaxf(fminf(t1z, t2z), r.tn));
  const float texit = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                            fmaxf(t1z, t2z));
  const float slack = 1e-4f * (fabsf(tent) + fabsf(texit)) + 1e-5f;
  return tent <= texit + slack && tent - slack <= upper;
}

// One block per packet, one ray a thread.
template <bool kClosest, bool kWoop>
__global__ void __launch_bounds__(kP)
    trace_kernel(Args a, float* __restrict__ t_out, float* __restrict__ u_out,
                 float* __restrict__ v_out, int* __restrict__ tri_out,
                 bool* __restrict__ occ_out) {
  extern __shared__ float4 tile[];   // B rows of 3 float4, or a Woop block
  const int p = blockIdx.x;
  const long long i = (long long)p * kP + threadIdx.x;
  const Ray r = load_ray(a, i);
  const bool live = !(r.tf < r.tn);
  float ix = 0.f, iy = 0.f, iz = 0.f;
  if (!kWoop && a.skip == 5) {
    ix = safe_inv(r.dx);
    iy = safe_inv(r.dy);
    iz = safe_inv(r.dz);
  }
  const int* sl = a.shortlist + (long long)p * a.n_super;
  const float* ent = a.entry + (long long)p * a.n_super;
  const int n_slots = a.count[p] * a.factor;
  const int rows = kWoop ? kWoopB : a.block;

  Best b{INFINITY, 0.f, 0.f, -1};
  bool occ = false;
  for (int s = 0; s < n_slots; ++s) {
    const int q = min(s / a.factor, a.n_super - 1);
    // closest hit: can the ray still improve in this slot?
    bool act = false;
    if (kClosest) {
      // front-to-back order: no ray can improve once the next entry
      // passes min(best_t, tfar) of every ray
      act = ent[q] <= fminf(b.t, r.tf);
      if (!__syncthreads_or(act)) break;
    } else {
      if (__syncthreads_and(occ || !live)) break;
    }
    const int sc = sl[q];
    const int c = a.factor == 1 ? sc
                                : min(sc * a.factor + s % a.factor,
                                      a.n_clusters - 1);
    if (!kWoop && a.skip == 5) {
      const float upper = kClosest ? fminf(b.t, r.tf) : r.tf;
      const bool slab = (kClosest || !occ) &&
                        slab_live(r, ix, iy, iz, a.bmin, a.bmax,
                                  a.box_per_cluster ? c : sc, upper);
      if (!__syncthreads_or(slab)) continue;
    }
    if (kWoop) {   // 16-byte aligned (the wrapper checks)
      const float4* src = (const float4*)a.ctris + (long long)c *
                          (kWoopFloats / 4);
      for (int k = threadIdx.x; k < kWoopFloats / 4; k += kP) tile[k] = src[k];
    } else {       // coalesced reads; row j at tile[3 j]
      const float* src = a.ctris + (long long)c * a.block * 9;
      float* dst = reinterpret_cast<float*>(tile);
      for (int k = threadIdx.x; k < a.block * 9; k += kP)
        dst[k / 9 * kMtRow + k % 9] = src[k];
    }
    __syncthreads();
    if (kClosest) {
      // the block vote's condition per warp: the entry distance bounds
      // from below every hit in the slot of every ray of the packet
      if (!__any_sync(kFull, act)) continue;
      if (kWoop) {
        for (int j = 0; j < rows; ++j) {
          float t, u, v;
          if (woop_test(r, reinterpret_cast<const float*>(tile), j, t, u,
                        v) &&
              t < b.t)
            b = Best{t, u, v, c * rows + j};
        }
      } else {
        closest_rows_mt(r, live, tile, rows, c, b);
      }
    } else if (!occ) {
      for (int j = 0; j < rows; ++j) {
        float t, u, v;
        if (kWoop ? woop_test(r, reinterpret_cast<const float*>(tile), j, t,
                              u, v)
                  : mt(r, tile[3 * j], tile[3 * j + 1], tile[3 * j + 2])) {
          occ = true;   // an OR: the first occluder decides
          break;
        }
      }
    }
  }
  if (kClosest) {
    t_out[i] = b.t;
    u_out[i] = b.u;
    v_out[i] = b.v;
    tri_out[i] = b.tri;
  } else {
    occ_out[i] = occ;
  }
}

Args make_args(const void* o, const void* d, const void* tnear,
               const void* tfar, const void* count, const void* shortlist,
               const void* entry, int n_super, const void* bmin,
               const void* bmax, int box_per_cluster, const void* ctris,
               int n_clusters, int block, int factor, int skip) {
  Args a;
  a.o = (const float*)o; a.d = (const float*)d;
  a.tnear = (const float*)tnear; a.tfar = (const float*)tfar;
  a.count = (const int*)count; a.shortlist = (const int*)shortlist;
  a.entry = (const float*)entry; a.n_super = n_super;
  a.bmin = (const float*)bmin; a.bmax = (const float*)bmax;
  a.box_per_cluster = box_per_cluster; a.ctris = (const float*)ctris;
  a.n_clusters = n_clusters; a.block = block; a.factor = factor;
  a.skip = skip;
  return a;
}

template <bool kClosest>
int launch(const Args& a, int n_packets, int woop, void* stream, float* t,
           float* u, float* v, int* tri, bool* occ) {
  if (woop)
    trace_kernel<kClosest, true><<<n_packets, kP, kWoopFloats * sizeof(float),
                                   (cudaStream_t)stream>>>(a, t, u, v, tri,
                                                           occ);
  else
    trace_kernel<kClosest, false><<<n_packets, kP,
                                    a.block * kMtRow * sizeof(float),
                                    (cudaStream_t)stream>>>(a, t, u, v, tri,
                                                            occ);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Inputs: packed rays (n_packets * 256), count/shortlist/entry of phase 1,
// the slab-cull boxes, the cluster blocks and woop: 0 for the (C, B, 9)
// blocks of K5/K6, 1 for the (C, 4, 384) Woop blocks of K7/K8 (block 128,
// factor 1, skip 0). Outputs t, u, v (float32) and tri (int32), each
// n_packets * 256.
int cluster_trace_closest(const void* o, const void* d, const void* tnear,
                          const void* tfar, const void* count,
                          const void* shortlist, const void* entry,
                          int n_packets, int n_super, const void* bmin,
                          const void* bmax, int box_per_cluster,
                          const void* ctris, int n_clusters, int block,
                          int factor, int skip, int woop, void* t, void* u,
                          void* v, void* tri, void* stream) {
  const Args a = make_args(o, d, tnear, tfar, count, shortlist, entry,
                           n_super, bmin, bmax, box_per_cluster, ctris,
                           n_clusters, block, factor, skip);
  return launch<true>(a, n_packets, woop, stream, (float*)t, (float*)u,
                      (float*)v, (int*)tri, nullptr);
}

// As cluster_trace_closest; output occ (bool), n_packets * 256.
int cluster_trace_any(const void* o, const void* d, const void* tnear,
                      const void* tfar, const void* count,
                      const void* shortlist, const void* entry, int n_packets,
                      int n_super, const void* bmin, const void* bmax,
                      int box_per_cluster, const void* ctris, int n_clusters,
                      int block, int factor, int skip, int woop, void* occ,
                      void* stream) {
  const Args a = make_args(o, d, tnear, tfar, count, shortlist, entry,
                           n_super, bmin, bmax, box_per_cluster, ctris,
                           n_clusters, block, factor, skip);
  return launch<false>(a, n_packets, woop, stream, nullptr, nullptr, nullptr,
                       nullptr, (bool*)occ);
}

const char* cluster_trace_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

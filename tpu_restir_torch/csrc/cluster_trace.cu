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
// adds, beside the IEEE division, the compares, the fold and the loads
// of the triangle. The Woop products stay on the CUDA cores in float32:
// the TPU kernel asks for Precision.HIGHEST because bf16 products gave
// false hits, TF32 keeps about as few mantissa bits, and a 3xTF32 split
// does not round like the plain version's separate products and sums,
// which the kernels must equal bit for bit. A cluster block is 64 x 9
// floats (2.3 KB), a Woop block 4 x 384 (6 KB); a 100k-triangle scene's
// blocks (3.6 or 4.8 MB) stay in the 50 MB L2, so device memory is not
// the limit. The other cost is divergence between packets: the work of a
// packet is its shortlist, from a few clusters to over a thousand.
//
// Design: one thread block per packet, one thread per ray; the block reads
// its own count, shortlist and entries. Per shortlist slot (an entry of a
// supercluster expands into F cluster slots) the block
//   1. votes on the early-out: closest hit stops once no ray's
//      min(best_t, tfar) reaches the slot's entry distance
//      (__syncthreads_or, the TPU kernel's packet watermark); any hit stops
//      once every ray is occluded or dead, tfar < tnear (__syncthreads_and,
//      its all-occluded exit);
//   2. in mode 5 (K6 and K8 above 64 clusters, K5 once superclusters
//      expand; never K7, as on the TPU, where K8 has no cull either) votes
//      on the per-ray slab test of the slot's box with the TPU kernel's
//      slack (and an exit that a clamped direction component cannot
//      shorten: slab_exit), and skips the slot only if no live ray passes
//      it. K8 grows each cluster box by the Woop test's reach as it reads
//      it (cull_box, `woop_cull_boxes` in kernels/cluster_trace.py): the
//      test's slack of 1e-5 in u, v and 1 - u - v lets a hit lie just
//      outside its triangle;
//   3. stages the cluster's block in shared memory, a row as three 16-byte
//      broadcasts: a Moller-Trumbore row padded to 12 floats; a Woop row
//      as its w, u and v coefficient rows (x, y, z, translation), each
//      gathered from the (4, 384) block by coalesced scalar reads (a warp
//      reads 32 consecutive floats of one coefficient row) and stored as
//      one float4 (eight consecutive rows cover the 32 banks); each thread
//      tests its ray against the rows.
// The vote barriers also fence the tile: no thread overwrites it before
// every thread has finished the previous slot.
// Inside the slot all four work at the warp's grain:
//   - a warp none of whose rays can change its result in the slot skips
//     its rows: K5 and K7 where the entry distance passes every ray's
//     min(best_t, tfar), the block vote's condition per warp; K6 and K8
//     where no ray is live, unoccluded and (mode 5) slab-live, and a
//     slab-dead ray is no candidate in the rows either;
//   - Moller-Trumbore rows (K5/K6): u comes first (p, det, tv and u: 24
//     of the 46 operations); a warp with no candidate lane whose u can lie
//     in [0, 1] skips q, v, t and the compares (why that is exact:
//     closest_rows_mt); K6 decides that from u's numerator and det
//     without the division (u_may_pass), which it then runs only for the
//     rows some lane passes;
//   - Woop rows (K7/K8), K1's design: each ray's [tnear, tfar] is folded
//     once (fold_range), so that two compares also reject an infinite or
//     NaN t; t = -ow/dw comes first (13 of the 40 operations), and a warp
//     with no candidate lane whose t is in range (K7: and below its best
//     t) skips u and v, and then v where no such lane has u in [-1e-5,
//     1.001], which every hit needs; rows go in unrolled groups of 4,
//     their t halves first, so that the divisions of a group overlap;
//   - occluded lanes (K6/K8) leave the candidates, and a warp leaves the
//     rows once none is left (the TPU kernel's all-occluded exit, per
//     warp);
//   - the reciprocal directions of the slab test only in mode 5.
// Kept out, slower or no faster on the card (PERF.md): two adjacent rays
// a thread for K5 (72 registers against 48); for K6, two rows a vote, and
// packing a slot's wanting rays into the fewest warps (5% faster for three
// more barriers a slot and 10 KB of shared memory); for K7/K8, row groups
// of 1 or 2 (K7 the same within 2%, K8 3-11% slower), K8 without the
// u-first skip (14% slower), and a ring of two tiles filled by cp.async
// for the next slot while this one runs (the TPU kernel's DMA ring: 5-6%
// slower; it adds a wait and a barrier a slot, transposes by 4-byte
// copies, and fetches blocks that an early exit never reads).
// The early-outs, the skips and the cull only skip work that cannot change
// a result (tests/test_torch_closest_skips.py and test_torch_any_skips.py
// hold the facts they rest on), so the kernels must equal the plain versions
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
#include <float.h>
#include <math.h>

namespace {

constexpr int kP = 256;     // rays per packet == threads per block
constexpr int kMtRow = 12;  // floats per staged Moller-Trumbore row (9 + 3)
constexpr int kWoopB = 128;            // triangles per Woop block
constexpr int kWoopRow = 3 * kWoopB;   // floats per coefficient row (u|v|w)
constexpr int kWoopGroup = 4;          // K7/K8: Woop rows per unrolled group
constexpr float kBaryEps = 1e-5f;
constexpr float kBaryMax = (float)(1.0 + 1e-5);
constexpr float kMinDw = 1e-18f;
// K8's cull boxes: WOOP_BOX_REL and WOOP_BOX_ABS of kernels/cluster_trace.py
constexpr float kWoopBoxRel = 4e-5f;
constexpr float kWoopBoxAbs = 4e-6f;
// A Woop hit needs u <= kUMax: with v >= -1e-5, fl(u + v) >= fl(u - 1e-5)
// > 1.0009 > kBaryMax once u > 1.001, as rounding is monotone (K1's bound,
// csrc/ray_tri.cu).
constexpr float kUMax = 1.001f;
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

// K7/K8: fold [tn, tf] so that tn <= t <= tf alone gives the Woop test's
// isfinite(t) && t >= tnear && t <= tfar: for tnear <= tfar (no NaN),
// clamping the bounds to the finite range rejects t = +-inf and changes no
// verdict on a finite t; a NaN t fails every compare. A ray with
// tnear > tfar, or a NaN bound, can satisfy no t: it gets [inf, -inf]
// (K1's fold_range, csrc/ray_tri.cu). Nothing else reads the bounds in a
// way the fold changes: the slab test's entry and limit are finite, and a
// dead ray hits nothing.
__device__ __forceinline__ void fold_range(Ray& r) {
  if (r.tn <= r.tf) {
    r.tn = fmaxf(r.tn, -FLT_MAX);
    r.tf = fminf(r.tf, FLT_MAX);
  } else {
    r.tn = INFINITY;
    r.tf = -INFINITY;
  }
}

// A staged Woop coefficient row p = (x, y, z, translation): its affine
// value at the ray origin and its linear part along the direction, in
// _woop_tuvok's order.
__device__ __forceinline__ float woop_aff(const Ray& r, float4 p) {
  return r.ox * p.x + r.oy * p.y + r.oz * p.z + p.w;
}
__device__ __forceinline__ float woop_lin(const Ray& r, float4 p) {
  return r.dx * p.x + r.dy * p.y + r.dz * p.z;
}

// The t half of a Woop row (w, its first float4): t = -ow/dw, and whether
// t can belong to a hit: |dw| > 1e-18 and t in the folded range.
__device__ __forceinline__ bool woop_t(const Ray& r, float4 w, float& t) {
  const float dw = woop_lin(r, w);
  const bool ok_dw = fabsf(dw) > kMinDw;
  // |dw| <= 1e-18 fails the test whatever t is (the plain version's
  // t = inf); divide by 1 there, off the division's slow path
  t = -woop_aff(r, w) / (ok_dw ? dw : 1.f);
  return ok_dw & (t >= r.tn) & (t <= r.tf);
}

// u (the second float4) or v (the third) at t.
__device__ __forceinline__ float woop_at(const Ray& r, float4 p, float t) {
  return woop_aff(r, p) + t * woop_lin(r, p);
}

__device__ __forceinline__ bool bary_ok(float u, float v) {
  return (u >= -kBaryEps) & (v >= -kBaryEps) & (u + v <= kBaryMax);
}

// Stage Woop block blk, (4, 384) floats [k][comp * 128 + j] (comp: u, v,
// w), as 128 rows of three float4: row j at tile[3 j] is w's coefficients
// (x, y, z, translation), then u's, then v's. Consecutive threads read
// consecutive floats of each coefficient row and store 16 bytes 48 apart,
// which a quarter warp spreads over all 32 banks.
__device__ __forceinline__ void stage_woop(float4* tile, const float* blk) {
  for (int q = threadIdx.x; q < kWoopRow; q += kP) {
    const int comp = q / kWoopB, j = q % kWoopB;
    tile[3 * j + (comp == 2 ? 0 : comp + 1)] =
        make_float4(blk[q], blk[kWoopRow + q], blk[2 * kWoopRow + q],
                    blk[3 * kWoopRow + q]);
  }
}

// K7's rows: G staged Woop rows, triangles id0, id0 + 1, ..., against the
// thread's ray, folded into b in row order (K1's closest_rows). The t
// halves of the G rows come first; a row's u then runs only where some
// lane of the warp has a t in range and below its ray's best t, and its v
// only where some such lane also has u in [-1e-5, kUMax]: conjuncts of the
// replacement, so no result can change (warp-uniform; all lanes call this
// together).
template <int G>
__device__ __forceinline__ void closest_rows_woop(const Ray& r,
                                                  const float4* rows,
                                                  int id0, Best& b) {
  float t[G];
  bool in_range[G];
#pragma unroll
  for (int g = 0; g < G; ++g) in_range[g] = woop_t(r, rows[3 * g], t[g]);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const bool test = in_range[g] && t[g] < b.t;
    if (!__any_sync(kFull, test)) continue;
    const float u = woop_at(r, rows[3 * g + 1], t[g]);
    const bool cand = test & (u >= -kBaryEps) & (u <= kUMax);
    if (!__any_sync(kFull, cand)) continue;
    const float v = woop_at(r, rows[3 * g + 2], t[g]);
    // strictly closer only: a tie keeps the earlier slot, then the lower row
    if (cand && bary_ok(u, v)) b = Best{t[g], u, v, id0 + g};
  }
}

// K8's rows: G staged Woop rows against the thread's ray; `want`: the ray
// is live, unoccluded and (mode 5) slab-live. The t halves come first; a
// row's u runs only where some wanting lane of the warp has a t in range,
// and its v only where some such lane also has u in [-1e-5, kUMax]. A hit
// clears `want` and sets `occ` (an OR: the first occluder decides).
template <int G>
__device__ __forceinline__ void any_rows_woop(const Ray& r, const float4* rows,
                                              bool& want, bool& occ) {
  float t[G];
  bool in_range[G];
#pragma unroll
  for (int g = 0; g < G; ++g) in_range[g] = woop_t(r, rows[3 * g], t[g]);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const bool test = want && in_range[g];
    if (!__any_sync(kFull, test)) continue;
    const float u = woop_at(r, rows[3 * g + 1], t[g]);
    const bool cand = test & (u >= -kBaryEps) & (u <= kUMax);
    if (!__any_sync(kFull, cand)) continue;
    const float v = woop_at(r, rows[3 * g + 2], t[g]);
    if (cand && bary_ok(u, v)) {
      occ = true;
      want = false;
    }
  }
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

// The exit of one slab: +inf on an axis whose component safe_inv clamped,
// unless the ray lies beyond the slab (hi < 0). The clamp shortens the
// exit: a ray lying in the plane of a box's max face would leave at t = 0
// and miss the triangle edges in that plane, which it can hit (the JAX
// kernel's `_slab_entry_exit` has that fault).
__device__ __forceinline__ float slab_exit(float c, float t1, float t2) {
  const float hi = fmaxf(t1, t2);
  return !(fabsf(c) > 1e-20f) && hi >= 0.f ? INFINITY : hi;
}

struct Box {
  float lx, ly, lz, hx, hy, hz;
};

// Box k of the slab cull: K6's as given; K8's grown by the Woop test's
// reach, in the float32 operations of `woop_cull_boxes` in
// kernels/cluster_trace.py, so the same box (the plain version that the
// tests hold the cull to).
template <bool kWoop>
__device__ __forceinline__ Box cull_box(const float* bmin, const float* bmax,
                                        int k) {
  Box b{bmin[3 * k], bmin[3 * k + 1], bmin[3 * k + 2],
        bmax[3 * k], bmax[3 * k + 1], bmax[3 * k + 2]};
  if (kWoop) {
    const float big = fmaxf(fmaxf(fmaxf(fabsf(b.lx), fabsf(b.hx)),
                                  fmaxf(fabsf(b.ly), fabsf(b.hy))),
                            fmaxf(fabsf(b.lz), fabsf(b.hz)));
    const float mb = kWoopBoxAbs * big;
    const float mx = kWoopBoxRel * (b.hx - b.lx) + mb;
    const float my = kWoopBoxRel * (b.hy - b.ly) + mb;
    const float mz = kWoopBoxRel * (b.hz - b.lz) + mb;
    b = Box{b.lx - mx, b.ly - my, b.lz - mz, b.hx + mx, b.hy + my, b.hz + mz};
  }
  return b;
}

// `_slab_entry_exit` + `_slab_live`, with the exit above: can this ray
// enter box b before `upper`? Relative and absolute slack, so rounding
// cannot cull a graze. `slab_live_ref` in kernels/cluster_trace.py is the
// plain version; tests/test_torch_any_skips.py holds that a ray it calls
// dead has no hit in the box.
__device__ __forceinline__ bool slab_live(const Ray& r, float ix, float iy,
                                          float iz, const Box& b,
                                          float upper) {
  const float t1x = (b.lx - r.ox) * ix;
  const float t2x = (b.hx - r.ox) * ix;
  const float t1y = (b.ly - r.oy) * iy;
  const float t2y = (b.hy - r.oy) * iy;
  const float t1z = (b.lz - r.oz) * iz;
  const float t2z = (b.hz - r.oz) * iz;
  const float tent = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                           fmaxf(fminf(t1z, t2z), r.tn));
  const float texit = fminf(fminf(slab_exit(r.dx, t1x, t2x),
                                  slab_exit(r.dy, t1y, t2y)),
                            slab_exit(r.dz, t1z, t2z));
  const float slack = 1e-4f * (fabsf(tent) + fabsf(texit)) + 1e-5f;
  return tent <= texit + slack && tent - slack <= upper;
}

// Whether u = fl(un * fl(1 / det)) can lie in [0, 1], from its numerator
// un (mt_u's sum) and det alone, without the division: with a = |det| >
// 1e-18 and s = un signed by det, 0 <= u <= 1 needs -1e-6 a <= s <= (1 +
// 2^-20) a. Rounding moves u from un / det by two relative errors of
// 2^-24 at most, so u <= 1 needs |un| <= (1 + 2^-22.9) a, below the
// rounded (1 + 2^-20) a; u >= 0 needs s >= 0, or a product that rounds to
// -0, where |un| < 2^-149 a. A NaN fails both. Held on the CPU against
// the exact test (tests/test_torch_any_skips.py).
__device__ __forceinline__ bool u_may_pass(float un, float det) {
  const float a = fabsf(det);
  const float s = det > 0.f ? un : -un;
  return a > 1e-18f && s >= -1e-6f * a && s <= 1.000001f * a;
}

// p, det, tv and u's numerator of a row, as mt_u computes them.
struct MtNum {
  float tvx, tvy, tvz, det, un;
};

__device__ __forceinline__ MtNum mt_num(const Ray& r, float4 x, float4 y,
                                        float4 z) {
  const float px = r.dy * z.x - r.dz * y.w;
  const float py = r.dz * y.z - r.dx * z.x;
  const float pz = r.dx * y.w - r.dy * y.z;
  MtNum a;
  a.det = x.w * px + y.x * py + y.y * pz;
  a.tvx = r.ox - x.x;
  a.tvy = r.oy - x.y;
  a.tvz = r.oz - x.z;
  a.un = a.tvx * px + a.tvy * py + a.tvz * pz;
  return a;
}

// The rest of the whole test from mt_num's parts: the reciprocal, u, v, t
// and the compares, as `_mt_cluster`.
__device__ __forceinline__ bool mt_rest(const Ray& r, const MtNum& a,
                                        float4 x, float4 y, float4 z) {
  MtHalf m;
  m.ok_det = fabsf(a.det) > 1e-18f;
  const float inv = 1.0f / (m.ok_det ? a.det : 1.0f);
  m.inv = m.ok_det ? inv : 0.0f;
  m.tvx = a.tvx;
  m.tvy = a.tvy;
  m.tvz = a.tvz;
  m.u = a.un * m.inv;
  float v, t;
  mt_vt(r, m, x, y, z, v, t);
  return m.ok_det && m.u >= 0.f && v >= 0.f && m.u + v <= 1.f &&
         t >= r.tn && t <= r.tf;
}

// K6's rows: the thread's ray against the `rows` staged rows of a slot;
// `want`: the ray is live, unoccluded and (mode 5) slab-live there. Per
// row, p, det, tv and u's numerator come first; a warp none of whose
// wanting lanes passes u_may_pass skips the division, q, v, t and the
// compares (22 of the test's 46 operations and the margin's 2 run).
// Occluded lanes leave the
// candidate mask, and the warp leaves the loop once no lane wants a hit
// (an OR: the first occluder decides).
__device__ __forceinline__ void any_rows_mt(const Ray& r, bool want,
                                            const float4* tile, int rows,
                                            bool& occ) {
  for (int j = 0; j < rows; ++j) {
    const float4 x = tile[3 * j], y = tile[3 * j + 1], z = tile[3 * j + 2];
    const MtNum a = mt_num(r, x, y, z);
    if (!__any_sync(kFull, want && u_may_pass(a.un, a.det))) continue;
    if (want && mt_rest(r, a, x, y, z)) {
      occ = true;
      want = false;
    }
    if (!__any_sync(kFull, want)) return;
  }
}

// One block per packet, one ray a thread.
template <bool kClosest, bool kWoop>
__global__ void __launch_bounds__(kP)
    trace_kernel(Args a, float* __restrict__ t_out, float* __restrict__ u_out,
                 float* __restrict__ v_out, int* __restrict__ tri_out,
                 bool* __restrict__ occ_out) {
  extern __shared__ float4 tile[];   // B rows of 3 float4
  const int p = blockIdx.x;
  const long long i = (long long)p * kP + threadIdx.x;
  Ray r = load_ray(a, i);
  if (kWoop) fold_range(r);
  const bool live = !(r.tf < r.tn);
  float ix = 0.f, iy = 0.f, iz = 0.f;
  if (a.skip == 5) {
    ix = safe_inv(r.dx);
    iy = safe_inv(r.dy);
    iz = safe_inv(r.dz);
  }
  const int* sl = a.shortlist + (long long)p * a.n_super;
  const float* ent = a.entry + (long long)p * a.n_super;
  const int n_slots = a.count[p] * a.factor;
  const int rows = a.block;

  Best b{INFINITY, 0.f, 0.f, -1};
  bool occ = false;
  bool slab = true;   // mode 5: the ray is live and reaches the slot's box
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
    if (a.skip == 5) {
      const float upper = kClosest ? fminf(b.t, r.tf) : r.tf;
      slab = live && (kClosest || !occ) &&
             slab_live(r, ix, iy, iz,
                       cull_box<kWoop>(a.bmin, a.bmax,
                                       a.box_per_cluster ? c : sc),
                       upper);
      if (!__syncthreads_or(slab)) continue;
    }
    if (kWoop) {
      stage_woop(tile, a.ctris + (long long)c * 4 * kWoopRow);
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
        for (int j = 0; j < rows; j += kWoopGroup)
          closest_rows_woop<kWoopGroup>(r, tile + 3 * j, c * rows + j, b);
      } else {
        closest_rows_mt(r, live, tile, rows, c, b);
      }
    } else {
      // a warp none of whose rays is live, unoccluded and (mode 5)
      // slab-live skips the slot's rows
      bool want = live && !occ && slab;
      if (!__any_sync(kFull, want)) continue;
      if (kWoop) {
        // the warp leaves the rows once none of its lanes wants a hit
        for (int j = 0; j < rows && __any_sync(kFull, want); j += kWoopGroup)
          any_rows_woop<kWoopGroup>(r, tile + 3 * j, want, occ);
      } else {
        any_rows_mt(r, want, tile, rows, occ);
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
    trace_kernel<kClosest, true><<<n_packets, kP,
                                   kWoopB * kMtRow * sizeof(float),
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
// factor 1; skip 0, or 5 for K8 with the cluster boxes, which it grows).
// Outputs t, u, v (float32) and tri (int32), each n_packets * 256.
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

// Packet-shortlist cluster traversal for large scenes: K5 closest hit and
// K6 any hit of packets of 256 rays over their own front-to-back cluster
// shortlists (phase 1, `build_shortlists` in kernels/cluster_trace.py), by
// fused Moller-Trumbore, and their Woop variant K7/K8 (`ptrace_mxu`), the
// same traversal with K1's Woop test at factor 1. And K9, phase 1's sort
// keys before its sort (`shortlist_keys`; its own notes at the end).
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
//   2. in mode 5 (above 64 clusters: K6 and K8, and K5 wherever it culls
//      on per-cluster boxes, factor 1 or at most BOX_MAX clusters; never
//      K7, as on the TPU, where K8 has no cull either) votes on the
//      per-ray slab test of the slot's box with the TPU kernel's slack
//      (and an exit that a clamped direction component cannot shorten:
//      slab_exit), and skips the slot only if no ray passes it that could
//      still change its result there (K5: a live ray, tested up to
//      min(best_t, tfar); K6/K8: a live unoccluded ray, up to tfar). On
//      incoherent packets (path-tracer bounces: ~1,000 clusters listed a
//      packet on a 100k-triangle terrain) this is where K5's time goes: a
//      slot costs a 64-row stage and a barrier, and few of the listed
//      boxes lie on any ray of the packet. K8 grows each cluster box by the Woop test's reach as it
//      reads it (cull_box, `woop_cull_boxes` in kernels/cluster_trace.py):
//      the test's slack of 1e-5 in u, v and 1 - u - v lets a hit lie just
//      outside its triangle;
//   3. stages the cluster's block in shared memory, a row as three 16-byte
//      broadcasts: a Moller-Trumbore row padded to 12 floats; a Woop row
//      as its w, u and v coefficient rows (x, y, z, translation), each
//      gathered from the (4, 384) block by coalesced scalar reads (a warp
//      reads 32 consecutive floats of one coefficient row) and stored as
//      one float4 (eight consecutive rows cover the 32 banks); each thread
//      tests its ray against the rows. Closest hit writes the number of
//      slots a packet staged (`staged`, one store a block), which the
//      wrapper hands to the counter `phase2.staged` unread.
// The vote barriers also fence the tile: no thread overwrites it before
// every thread has finished the previous slot.
// Inside the slot all four work at the warp's grain:
//   - a warp none of whose rays can change its result in the slot skips
//     its rows: K5 and K7 where the entry distance passes every live
//     ray's min(best_t, tfar) (within_reach), or (mode 5) no ray is live and slab-live: the
//     block votes' conditions per warp; K6 and K8 where no ray is live,
//     unoccluded and (mode 5) slab-live; in K5, K6 and K8 a slab-dead lane
//     is no candidate in the rows either;
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
  int* staged;             // (Rp,) slots staged a packet (closest hit)
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
// folded into b; `want` is false for a ray that cannot improve in the
// slot: dead (tfar < tnear), or (mode 5) slab-dead for the slot's box up
// to min(best_t, tfar).
__device__ __forceinline__ void closest_rows_mt(const Ray& r, bool want,
                                                const float4* tile, int rows,
                                                int c, Best& b) {
  for (int j = 0; j < rows; ++j) {
    const float4 x = tile[3 * j], y = tile[3 * j + 1], z = tile[3 * j + 2];
    const MtHalf m = mt_u(r, x, y, z);
    const bool cand = want & m.ok_det & (m.u >= 0.f) & (m.u <= 1.f);
    // u first. The test asks ok_det, u >= 0, v >= 0 and fl(u + v) <= 1.
    // With v >= 0, fl(u + v) >= u, because rounding is monotone and
    // fl(u) = u; so a hit needs u <= 1 (and a NaN u fails u >= 0). A dead
    // ray (tfar < tnear) fails the t range; a slab-dead ray has no hit
    // up to min(best_t, tfar), so none that the strict fold would take.
    // So where no lane wants the slot and has
    // ok_det and 0 <= u <= 1, no result of the warp changes in this row,
    // and skipping q, v, t and the compares changes nothing.
    if (!__any_sync(kFull, cand)) continue;
    float v, t;
    mt_vt(r, m, x, y, z, v, t);
    if (cand && v >= 0.f && m.u + v <= 1.f && t >= r.tn && t <= r.tf &&
        t < b.t)
      b = Best{t, m.u, v, c * rows + j};
  }
}

// The closest-hit early exits: can a slot whose entry distance is `ent`
// hold a hit of a live ray up to `reach` = min(best_t, tfar)? `ent`
// bounds the packet hull's entry into the slot's box, but a float32 hit
// can lie just outside its cluster's box, and the plain versions take it:
// Moller-Trumbore by rounding (terrain1M's G-buffer query: v rounded to 0
// on an edge that the ray misses by 3e-3 of the triangle, 1.8e-4 before
// the box's entry and before the hit the ray really has in an earlier
// slot), the Woop test by its slack of 1e-5 in u, v and 1 - u - v. So the
// compare carries the slab test's slack (slab_live). A dead ray is asked
// nothing: K7's folded range gives it tfar = -inf, whose slack is
// infinite.
__device__ __forceinline__ bool within_reach(float ent, float reach) {
  return ent - (1e-4f * (fabsf(ent) + fabsf(reach)) + 1e-5f) <= reach;
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
  int n_staged = 0;   // slots the block staged (block-uniform)
  for (int s = 0; s < n_slots; ++s) {
    const int q = min(s / a.factor, a.n_super - 1);
    // closest hit: can the ray still improve in this slot?
    bool act = false;
    if (kClosest) {
      // front-to-back order: no ray can improve once the next entry
      // passes min(best_t, tfar) of every live ray, beyond the slack of
      // within_reach
      act = live && within_reach(ent[q], fminf(b.t, r.tf));
      if (!__syncthreads_or(act)) break;
    } else {
      if (__syncthreads_and(occ || !live)) break;
    }
    const int sc = sl[q];
    const int c = a.factor == 1 ? sc
                                : min(sc * a.factor + s % a.factor,
                                      a.n_clusters - 1);
    if (a.skip == 5) {
      // closest hit: only a hit up to min(best_t, tfar) improves the ray
      const float upper = kClosest ? fminf(b.t, r.tf) : r.tf;
      slab = live && (kClosest || !occ) &&
             slab_live(r, ix, iy, iz,
                       cull_box<kWoop>(a.bmin, a.bmax,
                                       a.box_per_cluster ? c : sc),
                       upper);
      if (!__syncthreads_or(slab)) continue;
    }
    ++n_staged;
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
      // the block votes' conditions per warp: the entry distance passes
      // every ray's min(best_t, tfar), or no ray is live and (mode 5)
      // slab-live; and per lane the second alone: a slab-dead ray has no
      // hit in the slot's box up to min(best_t, tfar), the test's slack
      // covering its rounding. `act` stays per warp: the per-ray slab
      // test is the sharper bound
      const bool want = live && slab;
      if (!__any_sync(kFull, act) || !__any_sync(kFull, want)) continue;
      if (kWoop) {
        for (int j = 0; j < rows; j += kWoopGroup)
          closest_rows_woop<kWoopGroup>(r, tile + 3 * j, c * rows + j, b);
      } else {
        closest_rows_mt(r, want, tile, rows, c, b);
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
    if (a.staged && threadIdx.x == 0) a.staged[p] = n_staged;
  } else {
    occ_out[i] = occ;
  }
}

Args make_args(const void* o, const void* d, const void* tnear,
               const void* tfar, const void* count, const void* shortlist,
               const void* entry, int n_super, const void* bmin,
               const void* bmax, int box_per_cluster, const void* ctris,
               int n_clusters, int block, int factor, int skip,
               int* staged) {
  Args a;
  a.o = (const float*)o; a.d = (const float*)d;
  a.tnear = (const float*)tnear; a.tfar = (const float*)tfar;
  a.count = (const int*)count; a.shortlist = (const int*)shortlist;
  a.entry = (const float*)entry; a.n_super = n_super;
  a.bmin = (const float*)bmin; a.bmax = (const float*)bmax;
  a.box_per_cluster = box_per_cluster; a.ctris = (const float*)ctris;
  a.n_clusters = n_clusters; a.block = block; a.factor = factor;
  a.skip = skip;
  a.staged = staged;
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

// ---------------------------------------------------------------------------
// K9: phase 1's sort keys, `shortlist_keys` of kernels/cluster_trace.py
// ---------------------------------------------------------------------------
//
// It replaces no TPU kernel: the JAX package's phase 1 is XLA code, and the
// port's plain version ran it as ~210 eager launches a query over dense
// (packets, clusters) grids, each written to device memory and read back.
// K9 does in one launch what precedes the sort: each packet's interval
// summary (`_packet_bounds`: the origin, direction and t bounds of its live
// rays, the hulls of their 9 t-slice points, whether every live ray is
// bounded), then for each (super)cluster box the interval pass with its
// entry distance (`_interval_pass_entry`), the swept sub-box cull
// (`box_overlap` under the `bounded` mask), the key (the entry distance,
// at least the packet's least tnear, where both pass; +inf elsewhere) and
// the count of passing boxes.
//
// What bounds it on the H100: the key writes (4 bytes a pair) and the
// operations, ~30 an axis of the interval test, 6 a slice box, and ~150 a
// live ray for its points and their folds; device memory sees each ray
// once and each key once.
//
// Design: one block per packet, one ray a thread. Each thread loads its
// ray once and computes `live` and its 9 points; the packet's 68 minima
// and maxima fold across each warp (two transposing butterflies, 31
// shuffles for 32 values each, and four plain folds), then across the 8
// warps in shared memory; three threads derive each axis's clamped
// reciprocal interval, 24 the slice boxes. Then the threads sweep the
// boxes, thread t boxes t, t + 256, ... (the boxes stay in L1 and L2: each
// block reads each box once): the interval test axis by axis, stopping at
// the first axis after which the pair fails (entry only grows and exit
// only shrinks, and a NaN stays, so no later axis can pass it), and the
// slice boxes only for a passing pair of a bounded packet, stopping at the
// first that overlaps (an OR). A warp's key writes are consecutive floats
// of the packet's row; a block sum gives the count.
//
// Rounding: the plain version's operations in its order, the division
// IEEE and nothing contracted (--fmad=false), so key and count are
// bit-identical to `shortlist_keys` on CUDA tensors. Minima and maxima
// propagate NaN as torch.minimum, maximum, amin, amax and clamp do (fminf
// and fmaxf drop it, and a dead packet's plane distances are inf * 0), and
// take -0 below +0, as torch.minimum and maximum do on the card. amin and
// amax instead keep the operand their reduction order meets first among
// equal values: a packet whose live rays hold both +0 and -0 in one origin
// component, or in tnear, can get the other zero there (K9 takes -0 for
// the least, +0 for the greatest); it changes a key only where a box
// face lies at -0 with the origins on it, or where that zero is the key.

constexpr int kWarps = kP / 32;
constexpr int kSlices = 8;        // swept sub-boxes a packet (_N_SLICES)
// A packet's summary, in a table of minima and one of maxima of its live
// rays' values (slots): the 9 t-slice points (slot 3 s + axis), the
// origin (27-29), the direction (30-32) and tnear (minima) or tfar
// (maxima) (33). Slots 0-31 of each table fold across a warp by a
// transposing butterfly (31 shuffles for the 32 slots, lane l ending
// with slot l), the other two by plain warp folds.
constexpr int kSlots = 34;
constexpr int kOrigin = 27, kDir = 30, kT = 33;
constexpr float kBig = 3.0e38f;        // _BIG of the interval pass
constexpr float kSpan0 = 1e-12f;       // a direction interval near zero
constexpr float kRecipMax = 1e12f;     // the reciprocal bounds' clamp

// min and max that propagate NaN (one instruction on sm_80 and later)
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
template <bool kMin>
__device__ __forceinline__ float nan_fold(float a, float b) {
  return kMin ? nan_min(a, b) : nan_max(a, b);
}

// A ray's value of summary slot k, +inf (minima) or -inf (maxima) for a
// ray that is not live. Point s is o + d (tnear + (tfar - tnear) s / 8),
// `_packet_bounds`' order (linspace(0, 1, 9) is exact).
template <bool kMin>
__device__ __forceinline__ float ray_slot(int k, const float (&ro)[3],
                                          const float (&rd)[3], float tn,
                                          float tf, bool live) {
  float x;
  if (k < kOrigin)
    x = ro[k % 3] + rd[k % 3] * (tn + (tf - tn) * (0.125f * (k / 3)));
  else if (k < kDir)
    x = ro[k - kOrigin];
  else if (k < kT)
    x = rd[k - kDir];
  else
    x = kMin ? tn : tf;
  return live ? x : (kMin ? INFINITY : -INFINITY);
}

// A step of the transposing butterfly: the lane keeps half of its O * 2
// slots, sends its partner (lane ^ O) the half it gives up and folds in
// the partner's copy of the half it keeps.
template <bool kMin, int O>
__device__ __forceinline__ void butterfly(float (&v)[32], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int j = 0; j < O; ++j) {
    const float send = upper ? v[j] : v[j + O];
    const float keep = upper ? v[j + O] : v[j];
    v[j] = nan_fold<kMin>(keep, __shfl_xor_sync(kFull, send, O));
  }
}

// Fold the ray's summary slots over its warp into the warp's row of part
// (kMin: the minima).
template <bool kMin>
__device__ __forceinline__ void fold_summary(float (*part)[kSlots],
                                             const float (&ro)[3],
                                             const float (&rd)[3], float tn,
                                             float tf, bool live) {
  const int lane = threadIdx.x & 31;
  float v[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) v[k] = ray_slot<kMin>(k, ro, rd, tn, tf, live);
  butterfly<kMin, 16>(v, lane);
  butterfly<kMin, 8>(v, lane);
  butterfly<kMin, 4>(v, lane);
  butterfly<kMin, 2>(v, lane);
  butterfly<kMin, 1>(v, lane);
  float* row = part[2 * (threadIdx.x >> 5) + (kMin ? 0 : 1)];
  row[lane] = v[0];
#pragma unroll
  for (int k = 32; k < kSlots; ++k) {
    float x = ray_slot<kMin>(k, ro, rd, tn, tf, live);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x = nan_fold<kMin>(x, __shfl_xor_sync(kFull, x, off));
    if (lane == 0) row[k] = x;
  }
}

// An axis of the packet's interval summary: its origin bounds and the
// clamped reciprocal bounds of its direction interval, unless that spans
// zero (spans0: the axis constrains nothing).
struct KeyAxis {
  float omin, omax, rlo, rhi;
  bool spans0;
};

// The plane distances of one box bound b on the axis: the least and the
// greatest of the four corner products.
__device__ __forceinline__ void plane_span(float b, const KeyAxis& x,
                                           float& lo, float& hi) {
  const float blo_n = b - x.omax;
  const float bhi_n = b - x.omin;
  const float q1 = blo_n * x.rlo;
  const float q2 = blo_n * x.rhi;
  const float q3 = bhi_n * x.rlo;
  const float q4 = bhi_n * x.rhi;
  lo = nan_min(nan_min(q1, q2), nan_min(q3, q4));
  hi = nan_max(nan_max(q1, q2), nan_max(q3, q4));
}

// One axis of the interval pass, folded into the pair's entry and exit
// bounds; whether the pair still passes: entry_lo <= exit_hi, exit_hi >=
// tn, entry_lo <= tf.
__device__ __forceinline__ bool interval_axis(const KeyAxis& x, float blo,
                                              float bhi, float tn, float tf,
                                              float& entry_lo,
                                              float& exit_hi) {
  float a_entry = -kBig, a_exit = kBig;
  if (!x.spans0) {
    float t1lo, t1hi, t2lo, t2hi;
    plane_span(blo, x, t1lo, t1hi);
    plane_span(bhi, x, t2lo, t2hi);
    a_entry = nan_min(t1lo, t2lo);
    a_exit = nan_max(t1hi, t2hi);
  }
  entry_lo = nan_max(entry_lo, a_entry);
  exit_hi = nan_min(exit_hi, a_exit);
  return entry_lo <= exit_hi && exit_hi >= tn && entry_lo <= tf;
}

// One block per packet, one ray a thread.
__global__ void __launch_bounds__(kP)
    shortlist_keys_kernel(const float* __restrict__ o,
                          const float* __restrict__ d,
                          const float* __restrict__ tnear,
                          const float* __restrict__ tfar,
                          const float* __restrict__ cmin,
                          const float* __restrict__ cmax, int n_clusters,
                          float* __restrict__ key, int* __restrict__ count) {
  __shared__ float part[2 * kWarps][kSlots];   // per warp: minima, maxima
  __shared__ float smin[kSlots], smax[kSlots];
  __shared__ KeyAxis axes[3];
  __shared__ float emin[kSlices][3], emax[kSlices][3];
  __shared__ int warp_pass[kWarps];
  const int p = blockIdx.x;
  const long long i = (long long)p * kP + threadIdx.x;

  // the packet summary (`_packet_bounds`): dead rays (tfar < tnear) and
  // rays with a non-finite origin or direction stay out
  float ro[3], rd[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    ro[a] = o[3 * i + a];
    rd[a] = d[3 * i + a];
  }
  const float tn = tnear[i], tf = tfar[i];
  const bool live = tf >= tn && isfinite(ro[0]) && isfinite(ro[1]) &&
                    isfinite(ro[2]) && isfinite(rd[0]) && isfinite(rd[1]) &&
                    isfinite(rd[2]);
  fold_summary<true>(part, ro, rd, tn, tf, live);
  fold_summary<false>(part, ro, rd, tn, tf, live);
  const bool bounded = __syncthreads_and(!live || isfinite(tf));
  if (threadIdx.x < 2 * kSlots) {
    const bool is_min = threadIdx.x < kSlots;
    const int k = is_min ? threadIdx.x : threadIdx.x - kSlots;
    float v = part[is_min ? 0 : 1][k];
    for (int w = 1; w < kWarps; ++w)
      v = is_min ? nan_min(v, part[2 * w][k])
                 : nan_max(v, part[2 * w + 1][k]);
    (is_min ? smin : smax)[k] = v;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    const int a = threadIdx.x;
    const float dlo = smin[kDir + a], dhi = smax[kDir + a];
    KeyAxis x;
    x.spans0 = dlo <= kSpan0 && dhi >= -kSpan0;
    const float ilo = 1.0f / (x.spans0 ? 1.0f : dlo);
    const float ihi = 1.0f / (x.spans0 ? 1.0f : dhi);
    // torch.clamp: NaN stays
    x.rlo = nan_min(nan_max(nan_min(ilo, ihi), -kRecipMax), kRecipMax);
    x.rhi = nan_min(nan_max(nan_max(ilo, ihi), -kRecipMax), kRecipMax);
    x.omin = smin[kOrigin + a];
    x.omax = smax[kOrigin + a];
    axes[a] = x;
  } else if (threadIdx.x >= 32 && threadIdx.x < 32 + 3 * kSlices) {
    // slice s: the hull of points s and s + 1
    const int k = threadIdx.x - 32;
    emin[k / 3][k % 3] = nan_min(smin[k], smin[k + 3]);
    emax[k / 3][k % 3] = nan_max(smax[k], smax[k + 3]);
  }
  __syncthreads();

  // the sweep over the boxes
  const KeyAxis x0 = axes[0], x1 = axes[1], x2 = axes[2];
  const float ptn = smin[kT], ptf = smax[kT];
  float* row = key + (long long)p * n_clusters;
  int n_pass = 0;
  for (int c = threadIdx.x; c < n_clusters; c += kP) {
    const float lx = cmin[3 * c], ly = cmin[3 * c + 1], lz = cmin[3 * c + 2];
    const float hx = cmax[3 * c], hy = cmax[3 * c + 1], hz = cmax[3 * c + 2];
    float entry_lo = -kBig, exit_hi = kBig;
    bool pass = interval_axis(x0, lx, hx, ptn, ptf, entry_lo, exit_hi) &&
                interval_axis(x1, ly, hy, ptn, ptf, entry_lo, exit_hi) &&
                interval_axis(x2, lz, hz, ptn, ptf, entry_lo, exit_hi);
    if (pass && bounded) {
      pass = false;
      for (int s = 0; s < kSlices && !pass; ++s)
        pass = emin[s][0] <= hx && emin[s][1] <= hy && emin[s][2] <= hz &&
               emax[s][0] >= lx && emax[s][1] >= ly && emax[s][2] >= lz;
    }
    row[c] = pass ? nan_max(entry_lo, ptn) : INFINITY;
    n_pass += pass;
  }
  n_pass = __reduce_add_sync(kFull, n_pass);
  if ((threadIdx.x & 31) == 0) warp_pass[threadIdx.x >> 5] = n_pass;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_pass[w];
    count[p] = total;
  }
}

}  // namespace

extern "C" {

// Inputs: packed rays (n_packets * 256), count/shortlist/entry of phase 1,
// the slab-cull boxes, the cluster blocks and woop: 0 for the (C, B, 9)
// blocks of K5/K6, 1 for the (C, 4, 384) Woop blocks of K7/K8 (block 128,
// factor 1; skip 0, or 5 for K8 with the cluster boxes, which it grows).
// Outputs t, u, v (float32) and tri (int32), each n_packets * 256, and
// staged (int32, n_packets, or null): the slots each packet staged.
int cluster_trace_closest(const void* o, const void* d, const void* tnear,
                          const void* tfar, const void* count,
                          const void* shortlist, const void* entry,
                          int n_packets, int n_super, const void* bmin,
                          const void* bmax, int box_per_cluster,
                          const void* ctris, int n_clusters, int block,
                          int factor, int skip, int woop, void* t, void* u,
                          void* v, void* tri, void* staged, void* stream) {
  const Args a = make_args(o, d, tnear, tfar, count, shortlist, entry,
                           n_super, bmin, bmax, box_per_cluster, ctris,
                           n_clusters, block, factor, skip, (int*)staged);
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
                           n_clusters, block, factor, skip, nullptr);
  return launch<false>(a, n_packets, woop, stream, nullptr, nullptr, nullptr,
                       nullptr, (bool*)occ);
}

// K9: packed rays (n_packets * 256; o, d (., 3), tnear, tfar), the
// (super)cluster boxes cmin, cmax (n_clusters, 3) -> key (n_packets,
// n_clusters) float32 and count (n_packets,) int32.
int cluster_shortlist_keys(const void* o, const void* d, const void* tnear,
                           const void* tfar, int n_packets, const void* cmin,
                           const void* cmax, int n_clusters, void* key,
                           void* count, void* stream) {
  if (n_packets > 0)
    shortlist_keys_kernel<<<n_packets, kP, 0, (cudaStream_t)stream>>>(
        (const float*)o, (const float*)d, (const float*)tnear,
        (const float*)tfar, (const float*)cmin, (const float*)cmax,
        n_clusters, (float*)key, (int*)count);
  return (int)cudaGetLastError();
}

const char* cluster_trace_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

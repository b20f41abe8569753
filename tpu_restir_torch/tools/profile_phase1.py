"""Alternatives for phase 1 of the clustered traversal, timed on one GPU
(counterpart of the repository's `tools/profile_phase1.py`).

    python -m tpu_restir_torch.tools.profile_phase1 [--device cuda]
        [--tris 100000] [--size 1920x1080] [--reps 5]

On the closest query of `profile_ptrace.primary_rays` (terrain_scene(tris),
the terrain camera, 8x32-pixel packets), with the port's own phase-1
functions (`accel/fcluster.py` `_packet_bounds`, `_clamp_tfar_bbox`;
`kernels/cluster_trace.py` `_interval_pass_entry`, `box_overlap`,
`shortlist_keys`, `build_shortlists`), it times:
  * the key build: the clamp, the bounds, the interval pass and the swept
    sub-box cull, to the (Rp, C) sort keys (`shortlist_keys`, the eager
    plain version), and the clamp and the same keys by K9 (`packet_keys`,
    phase 1's own on the card; on the CPU the plain version again), with
    the keys and counts in which the two differ (0 expected);
  * the full stable sort of the (Rp, C) keys, phase 1's own;
  * `torch.topk` of the k = 32 and 64 least keys, then a small stable sort
    of the k;
  * the 32-slot reduction compaction: the first 32 passing clusters of
    each packet in cluster order, one masked max a slot (unsorted);
  * the interval pass alone and the sub-box cull alone, on bounds
    computed beforehand, and the bounds alone (reduced to a sum).
Each alternative that defines some of phase 1's slots says how far they
agree with `build_shortlists`: the full sort every listed slot (0
mismatches expected); top-k the slots below min(k, count), where a
mismatch whose key equals phase 1's key there is a tie that topk, which
is not stable, may order otherwise (counted, not required to be 0), and
the packets whose count passes k are truncated; the compaction the set of
listed clusters of each packet of at most 32 (the order differs).

Times are medians over `reps` runs, each ending in a synchronize (CUDA
events on the card; the host clock on the CPU, where a run is a test of
the tool). Prints the JAX tool's lines, then one JSON line. The default
device is cuda, which must be there: there is no fallback to the CPU.
"""

from __future__ import annotations

import argparse
import json

import torch

from tpu_restir_torch import bench
from tpu_restir_torch.accel.fcluster import _clamp_tfar_bbox, _packet_bounds
from tpu_restir_torch.kernels import cluster_trace as ct
from tpu_restir_torch.tools.profile_ptrace import (median_ms, parse_size,
                                                   primary_rays)

TOPK = (32, 64)
COMPACT = 32


def topk_slots(key, k: int):
    """The k least keys of each row, then a small stable sort of them ->
    (entries (Rp, k), clusters (Rp, k) int64)."""
    vals, idx = torch.topk(key, k, dim=1, largest=False, sorted=False)
    ent, order = torch.sort(vals, dim=1, stable=True)
    return ent, idx.gather(1, order)


def compact_slots(key, slots: int):
    """The first `slots` passing clusters (finite key) of each row in
    cluster order, one masked max over the row a slot -> (clusters (Rp,
    slots), -1 past the row's passing count; their keys)."""
    passes = torch.isfinite(key)
    rank = torch.cumsum(passes.to(torch.int32), dim=1) - passes.to(torch.int32)
    iota = torch.arange(key.shape[1], device=key.device)[None]
    sl = torch.stack([torch.where(passes & (rank == r), iota, -1).amax(1)
                      for r in range(slots)], 1)
    return sl, key.gather(1, sl.clamp(min=0))


def measure(device, n_tris: int = 100_000, width: int = 1920,
            height: int = 1080, reps: int = 5, scene=None) -> dict:
    """Times and slot agreement of the phase-1 alternatives -> dict."""
    from tpu_restir_torch.scene.procedural import terrain_scene
    device = torch.device(device)
    if scene is None:
        scene = terrain_scene(device, n_tris)
    o, d, tn, tf = primary_rays(width, height, device)
    factor = ct.pick_factor(scene.cluster_tris.shape[0])
    cmin, cmax = ct._super_boxes(scene.cluster_min, scene.cluster_max,
                                 factor)
    lo, hi = cmin.amin(0), cmax.amax(0)

    def keys():
        tfc = _clamp_tfar_bbox(o, d, tn, tf, lo, hi)
        return ct.shortlist_keys(o, d, tn, tfc, cmin, cmax)

    def keys_k9():
        tfc = _clamp_tfar_bbox(o, d, tn, tf, lo, hi)
        return ct.packet_keys(o, d, tn, tfc, cmin, cmax)

    out = {"device": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "triangles": scene.num_tris,
           "clusters": scene.cluster_tris.shape[0],
           "factor": factor, "rays": o.shape[0], "reps": reps}
    out["key_build_ms"], (key, cnt) = median_ms(keys, reps, device)
    out["key_build_k9_ms"], (k9_key, k9_cnt) = median_ms(keys_k9, reps,
                                                         device)
    out["key_build_k9_mismatches"] = int(
        (k9_key.view(torch.int32) != key.view(torch.int32)).sum()
        + (k9_cnt != cnt).sum())
    tfc = _clamp_tfar_bbox(o, d, tn, tf, lo, hi)
    _cnt, ref_sl, ref_ent = ct.build_shortlists(o, d, tn, tfc, cmin, cmax)
    rp, c = key.shape
    cnt = cnt.long()
    out["key_shape"] = [rp, c]
    pos = torch.arange(c, device=device)[None]

    out["full_sort_ms"], (ent, sl) = median_ms(
        lambda: torch.sort(key, dim=1, stable=True), reps, device)
    listed = pos < cnt[:, None]
    out["full_sort_mismatches"] = int(((sl != ref_sl) & listed).sum())

    for k in TOPK:
        if k > c:
            continue
        ms, (ent, sl) = median_ms(lambda k=k: topk_slots(key, k), reps,
                                  device)
        defined = pos[:, :k] < cnt[:, None]
        wrong = (sl != ref_sl[:, :k]) & defined
        out[f"topk{k}"] = {
            "ms": ms, "slots": int(defined.sum()),
            "mismatches": int(wrong.sum()),
            "tie_mismatches": int((wrong & (ent == ref_ent[:, :k])).sum()),
            "truncated_packets": int((cnt > k).sum())}

    k = min(COMPACT, c)
    ms, (sl, _ent) = median_ms(lambda: compact_slots(key, k), reps, device)
    small = cnt <= k
    mine = torch.where(sl >= 0, sl, c).sort(1).values
    theirs = torch.where(pos[:, :k] < cnt[:, None], ref_sl[:, :k].long(),
                         c).sort(1).values
    out[f"compact{COMPACT}"] = {
        "ms": ms, "packets_within": int(small.sum()),
        "set_equal": int(((mine == theirs).all(1) & small).sum()),
        "truncated_packets": int((~small).sum())}

    bounds = _packet_bounds(o, d, tn, tfc, ct.P)
    omin, omax, dmin, dmax, tnp, tfp, _bounded, emin, emax = bounds
    out["interval_ms"], _ = median_ms(
        lambda: ct._interval_pass_entry(omin, omax, dmin, dmax, tnp, tfp,
                                        cmin, cmax), reps, device)
    out["box_ok_ms"], _ = median_ms(
        lambda: ct.box_overlap(emin, emax, cmin, cmax), reps, device)

    def bounds_only():
        b = _packet_bounds(o, d, tn, _clamp_tfar_bbox(o, d, tn, tf, lo, hi),
                           ct.P)
        return sum(x.float().sum() for x in b)

    out["bounds_ms"], _ = median_ms(bounds_only, reps, device)
    return out


def report(r: dict) -> str:
    """The JAX tool's lines, with the slot agreement beside each."""
    rp, c = r["key_shape"]
    lines = [f"key build (bounds+interval+box): {r['key_build_ms']:.1f} ms",
             f"key build by K9: {r['key_build_k9_ms']:.3f} ms (keys and "
             f"counts differing {r['key_build_k9_mismatches']})",
             f"full sort ({rp}x{c}): {r['full_sort_ms']:.1f} ms "
             f"(slot mismatches against build_shortlists "
             f"{r['full_sort_mismatches']})"]
    for k in TOPK:
        if f"topk{k}" in r:
            e = r[f"topk{k}"]
            lines.append(
                f"top_k({k}) + small sort: {e['ms']:.1f} ms (of "
                f"{e['slots']} slots below min(k, count), {e['mismatches']} "
                f"differ, {e['tie_mismatches']} of them equal-key ties; "
                f"{e['truncated_packets']} packets list more than {k})")
    e = r[f"compact{COMPACT}"]
    lines += [
        f"reduction compact ({COMPACT}): {e['ms']:.1f} ms (index order, "
        f"unsorted; {e['set_equal']} of the {e['packets_within']} packets "
        f"of at most {COMPACT} list the same clusters; "
        f"{e['truncated_packets']} packets list more)",
        f"interval pass alone: {r['interval_ms']:.1f} ms",
        f"box_ok alone: {r['box_ok_ms']:.1f} ms",
        f"bounds alone (reduced): {r['bounds_ms']:.1f} ms"]
    return "\n".join(lines)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tris", type=int, default=100_000)
    ap.add_argument("--size", default="1920x1080")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    w, h = parse_size(args.size)
    r = measure(args.device, args.tris, w, h, args.reps)
    if torch.device(args.device).type == "cuda":
        r["gpu"] = bench.gpu_line()
    print(report(r), flush=True)
    print(json.dumps(r), flush=True)
    return r


if __name__ == "__main__":
    main()

"""The port's counterparts of the JAX system's profiling and scaling tools
(`tpu_restir_torch/tools/profile_ptrace.py`, `profile_phase1.py`,
`scaling_bench.py`), run on the CPU at small sizes.

Each tool runs through its `main` and prints its lines and one JSON line
with its keys. profile_ptrace's shortlist counts and effective rounds
equal a numpy recount from the JAX package's `build_shortlists` and
`trace_closest` (its Pallas kernel in the interpreter) on the same rays;
profile_phase1's alternatives agree with `build_shortlists` where they
define its slots (top-k only up to ties); scaling_bench's halo width is
the JAX package's `halo_width` and its ranks send bytes. No time is
asserted: on the CPU, under the suite's parallel workers, the ranks and
the single device share cores with other tests, so a bound on t1 / tN
(tests/test_scaling.py's 2x) would make the pass count depend on the
machine's load.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np

from tpu_restir.accel.fcluster import _clamp_tfar_bbox as j_clamp
from tpu_restir.dist.halo import halo_width as j_halo_width
from tpu_restir.kernels import cluster_trace as jct
from tpu_restir.scene.procedural import terrain_scene as j_terrain
from tpu_restir_torch.tools import (profile_phase1, profile_ptrace,
                                    scaling_bench)

SIZE = ("64", "32")
JAX_KEYS = ("n_devices", "res", "frames", "t1_ms", "tN_ms", "overhead_pct",
            "scaling_eff", "halo_rows", "halo_bytes_per_frame_per_device")


def _run(tool, argv, capsys):
    """tool.main(argv) -> (its result, its printed lines); the last line is
    the JSON of the result."""
    r = tool.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == json.loads(json.dumps(r))
    return r, lines


def test_profile_ptrace_counts_and_rounds_match_jax(capsys, monkeypatch):
    r, lines = _run(profile_ptrace, ["--device", "cpu", "--tris", "2000",
                                     "--size", "x".join(SIZE), "--reps", "1"],
                    capsys)
    assert lines[0].startswith("phase1: ") and "count mean=" in lines[0]
    assert lines[1].startswith("closest full: ")
    assert lines[2].startswith("effective rounds (ordered, final watermark)")
    assert "(sort ~" in lines[4]
    assert {"phase1_ms", "closest_ms", "kernel_ms", "bounds_ms",
            "bounds_interval_ms", "sort_ms", "count", "rounds"} <= set(r)
    assert (r["clusters"], r["factor"], r["rays"]) == (33, 1, 64 * 32)

    monkeypatch.setattr(jct, "INTERPRET", True)
    scene = j_terrain(2_000)
    o, d, tn, tf = (np.asarray(x) for x in profile_ptrace.primary_rays(
        int(SIZE[0]), int(SIZE[1]), "cpu"))
    cmin, cmax = scene.cluster_min, scene.cluster_max
    tfc = j_clamp(o, d, tn, tf, jnp.min(cmin, 0), jnp.max(cmax, 0))
    cnt, _sl, ent = jct.build_shortlists(o, d, tn, tfc, cmin, cmax)
    t = jax.jit(lambda *a: jct.trace_closest(scene.cluster_tris, cmin, cmax,
                                             *a)[0])(o, d, tn, tf)
    cnt, ent = np.asarray(cnt), np.asarray(ent)
    maxt = np.minimum(np.asarray(t), np.asarray(tfc)).reshape(
        -1, jct.P).max(axis=1)
    rounds = np.minimum((ent <= maxt[:, None]).sum(axis=1), cnt)
    assert r["count"] == profile_ptrace.stats(cnt)
    assert r["count"]["max"] > 1
    want = profile_ptrace.stats(rounds)
    assert r["rounds"] == {"mean": want["mean"], "p95": want["p95"],
                           "max": want["max"], "total": int(rounds.sum())}


def test_profile_phase1_alternatives_agree_with_the_shortlists(capsys):
    r, lines = _run(profile_phase1, ["--device", "cpu", "--tris", "5000",
                                     "--size", "x".join(SIZE), "--reps", "1"],
                    capsys)
    for head in ("key build", "key build by K9", "full sort (8x79)",
                 "top_k(32)", "top_k(64)", "reduction compact (32)",
                 "interval pass alone", "box_ok alone", "bounds alone"):
        assert any(ln.startswith(head) for ln in lines), head
    assert r["full_sort_mismatches"] == 0
    assert r["key_build_k9_mismatches"] == 0
    for k in (32, 64):
        e = r[f"topk{k}"]
        assert e["slots"] > 0 and e["mismatches"] == e["tie_mismatches"]
    assert r["topk32"]["truncated_packets"] > 0      # counts above 32
    e = r["compact32"]
    assert e["set_equal"] == e["packets_within"] > 0
    assert e["packets_within"] + e["truncated_packets"] == 8


def test_scaling_bench_keys_and_halo(capsys):
    radius = 4.0
    r, lines = _run(scaling_bench, ["--device", "cpu", "--res", "32",
                                    "--frames", "2", "--devices", "2",
                                    "--radius", str(radius), "--reps", "1"],
                    capsys)
    assert len(lines) == 1
    assert set(JAX_KEYS) <= set(r)
    assert (r["n_devices"], r["res"], r["frames"]) == (2, 32, 2)
    assert r["halo_rows"] == j_halo_width(radius) == 3
    assert r["halo_bytes_per_frame_per_device"] == 2 * 2 * 3 * 32 * 32 * 4
    assert r["halo_bytes_measured_per_frame_per_device"] > 0
    assert r["staged_bytes_per_frame_per_device"] == 0   # no card
    assert r["backend"] == "gloo" and len(r["rank_ms"]) == 2
    assert r["t1_ms"] > 0 and r["tN_ms"] > 0

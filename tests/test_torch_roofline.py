"""The port's roofline.py: the JAX module's API on the H100's ceilings.

`summarize_query_log` equals the JAX package's on the same log; the
ceilings that `chip_smoke.bound` divides by are roofline.py's (patched
there, the bound follows); no constant of `tpu_restir/roofline.py` (the
TPU's rates and its cost model) appears in the port's module.
"""

import ast
import inspect

import pytest

import chip_smoke
from tpu_restir import roofline as jroofline
from tpu_restir_torch import roofline


def _public(mod):
    return {n for n in vars(mod) if not n.startswith("_")
            and (inspect.isfunction(getattr(mod, n))
                 or inspect.isclass(getattr(mod, n)))
            and getattr(getattr(mod, n), "__module__", "") == mod.__name__}


def test_same_api_as_jax():
    assert _public(jroofline) <= _public(roofline)


def test_summarize_query_log_matches_jax():
    log = [{"kind": "closest", "backend": "fused", "rays": 2_073_600},
           {"kind": "any", "backend": "fused", "rays": 2_073_600},
           {"kind": "any", "backend": "ptrace", "rays": 10},
           {"kind": "closest", "backend": "fcluster", "rays": 7}]
    assert roofline.summarize_query_log(log) \
        == jroofline.summarize_query_log(log)
    assert roofline.summarize_query_log([]) \
        == jroofline.summarize_query_log([])


def test_chip_smoke_bound_takes_the_ceilings_of_roofline(monkeypatch):
    assert chip_smoke.bound(roofline.HBM_BYTES_PER_S * 1e-3, 0) \
        == pytest.approx((1.0, "bytes"))
    assert chip_smoke.bound(0, roofline.FP32_OPS_PER_S * 1e-3) \
        == pytest.approx((1.0, "operations"))
    for b, o in ((1e6, 1e12), (1e9, 1e9), (123.0, 0.0)):
        ms, by = chip_smoke.bound(b, o)
        t_b = b / roofline.HBM_BYTES_PER_S * 1e3
        t_o = o / roofline.FP32_OPS_PER_S * 1e3
        assert ms == pytest.approx(max(t_b, t_o))
        assert by == ("operations" if t_o > t_b else "bytes")
    monkeypatch.setattr(roofline, "HBM_BYTES_PER_S", 1e12)
    assert chip_smoke.bound(1e9, 0)[0] == pytest.approx(1.0)
    assert (roofline.WOOP_OPS, roofline.MT_OPS, roofline.SLAB_OPS) \
        == (chip_smoke.WOOP_OPS, chip_smoke.MT_OPS, chip_smoke.SLAB_OPS) \
        == (40, 46, 28)


def _constants(mod):
    """{NAME: value} of the module-level upper-case assignments."""
    tree = ast.parse(inspect.getsource(mod))
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id.isupper():
            out[node.targets[0].id] = ast.literal_eval(node.value)
    return out


def test_no_tpu_constant_in_the_port():
    tpu = _constants(jroofline)
    rates = ("HBM_GBPS", "MXU_BF16_TFLOPS", "VPU_F32_TOPS_EST",
             "TAKE_TILE_OPS_PER_S")
    assert set(rates) <= set(tpu)
    port = _constants(roofline)
    assert not set(tpu) & set(port)
    assert not {tpu[k] for k in rates} & set(port.values())
    assert (port["HBM_BYTES_PER_S"], port["FP32_OPS_PER_S"]) \
        == (3.35e12, 33.5e12)


def test_specs_on_the_card_ceilings():
    q = roofline.fused_query_spec("k1", 2_073_600, 36)
    assert q.flops == 2_073_600 * 36 * roofline.WOOP_OPS
    assert q.bound == "operations"
    assert q.sol_time_s() == pytest.approx(q.flops / 33.5e12)
    g = roofline.gather_spec("k3", 1920 * 1080, 5, 24, 30)
    n = 1920 * 1080
    # chip_smoke.check_gather's bytes: payload, two coordinates a tap, taps
    assert g.bytes_hbm == 4 * (n * 24 + 2 * 5 * n + 5 * n * 24)
    assert g.flops == 0 and g.bound == "bytes"
    p = roofline.ptrace_query_spec("k5", 2_073_600, 100_000, 64)
    assert p.flops == 100_000 * 64 * 256 * roofline.MT_OPS
    frame = roofline.FrameModel()
    for spec in (q, g, p):
        frame.add(spec)
    assert frame.total_sol_s() == pytest.approx(
        q.sol_time_s() + g.sol_time_s() + p.sol_time_s())
    assert "frame bound" in frame.report(0.2)

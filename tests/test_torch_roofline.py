"""The port's roofline arithmetic against the reference's (counterpart of
``tests/test_launch_roofline.py``): ``SHAPES``, ``model_flops`` and the
attention and HBM-byte models bit for bit on all ten archs and four cells,
the roofline terms on the H100's peaks, the dry run's input specs, the
data pipeline's loader batch, and each kernel cost function against the
bound PERF.md's kernel table prints at that row's shape."""

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.registry import get_config as ref_config
from repro.data import pipeline as ref_pipeline
from repro.launch import inputs as ref_inputs
from repro.launch import roofline as RR
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.data import pipeline
from repro_torch.kernels.elevator_scan import decode as ED
from repro_torch.kernels.elevator_scan import kernel as EK
from repro_torch.kernels.local_attention import kernel as FA
from repro_torch.kernels.matmul_fwd import kernel as MM
from repro_torch.kernels.stencil2d import kernel as ST
from repro_torch.kernels.token_shift import kernel as TS
from repro_torch.kernels.wkv import bwd as WB
from repro_torch.kernels.wkv import decode as WD
from repro_torch.kernels.wkv import kernel as WK
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import roofline as R
from repro_torch.launch.dryrun import _mode_for
from repro_torch.launch.inputs import batch_specs, cell_is_applicable, decode_specs

jax.config.update("jax_platform_name", "cpu")

ARCHS = list(list_archs())
BF, F32 = torch.bfloat16, torch.float32


def test_shapes_equal_the_reference():
    assert list(SHAPES) == list(REF_SHAPES)
    for name, s in SHAPES.items():
        r = REF_SHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == (
            r.name, r.seq_len, r.global_batch, r.kind)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_bytes_bit_equal(arch, shape):
    cfg, ref = get_config(arch), ref_config(arch)
    s, rs = SHAPES[shape], REF_SHAPES[shape]
    assert R.model_flops(cfg, s) == RR.model_flops(ref, rs)
    assert R._attention_flops(cfg, s.seq_len, s.global_batch) == RR._attention_flops(
        ref, rs.seq_len, rs.global_batch)
    assert R._decode_attention_flops(cfg, s.seq_len, s.global_batch) == \
        RR._decode_attention_flops(ref, rs.seq_len, rs.global_batch)
    mode = _mode_for(shape, s.kind)
    assert R.analytic_hbm_bytes(cfg, s, 256, mode, tp=16) == RR.analytic_hbm_bytes(
        ref, rs, 256, mode)


class TestRooflineTerms:
    def test_terms_and_dominant(self):
        t = R.roofline_terms(
            {"flops": 989e12, "bytes accessed": 3.35e12 * 2}, {"total_bytes": 0})
        assert t.compute_s == pytest.approx(1.0)
        assert t.memory_s == pytest.approx(2.0)
        assert t.collective_s == 0.0          # one card: no collectives
        assert t.dominant == "memory"
        assert t.bound_time_s == pytest.approx(2.0)

    def test_compute_sums_each_class_over_its_peak(self):
        t = R.roofline_terms({"flops": 989e12 + 67e12, "bytes accessed": 0.0,
                              "flops_by_class": {"bf16": 989e12, "f32": 67e12}}, {})
        assert t.compute_s == pytest.approx(2.0)
        assert t.flops == 989e12 + 67e12
        assert t.dominant == "compute"

    def test_h100_constants(self):
        assert mesh_mod.PEAK_FLOPS == {"bf16": 989e12, "f32": 67e12}
        assert mesh_mod.HBM_BW == 3.35e12
        assert mesh_mod.HBM_BYTES == 80 * 2**30

    def test_decode_flops_scale_with_active_params(self):
        moe = get_config("qwen3-moe-235b-a22b")
        f = R.model_flops(moe, SHAPES["decode_32k"])
        want = 2.0 * moe.active_param_count() * 128 + R._decode_attention_flops(moe, 32768, 128)
        assert f == pytest.approx(want, rel=1e-12)
        assert f < 2.0 * moe.param_count() * 128

    def test_local_window_caps_decode_kv_bytes(self):
        g = get_config("gemma3-1b")
        bg = R.analytic_hbm_bytes(g, SHAPES["long_500k"], 1, "decode", tp=1)
        full = 26 * SHAPES["long_500k"].seq_len * g.num_kv_heads * g.head_dim * 2 * 2
        assert bg < full


class TestInputs:
    def test_applicability_skips(self):
        ok, why = cell_is_applicable(get_config("minitron-8b"), "long_500k")
        ref_ok, ref_why = ref_inputs.cell_is_applicable(ref_config("minitron-8b"), "long_500k")
        assert not ok and (ok, why) == (ref_ok, ref_why)
        assert cell_is_applicable(get_config("rwkv6-1.6b"), "long_500k")[0]
        assert cell_is_applicable(get_config("minitron-8b"), "train_4k")[0]

    def test_batch_specs_no_allocation(self):
        specs, axes = batch_specs(get_config("qwen2-vl-7b"), SHAPES["train_4k"])
        assert all(x.is_meta for x in specs.values())
        assert specs["tokens"].shape == (256, 4096)
        assert specs["frontend_embeds"].shape == (256, 1024, 3584)
        assert specs["positions"].shape == (3, 256, 4096)
        assert set(axes) == set(specs)

    def test_seamless_batch_and_decode_extras(self):
        cfg = get_config("seamless-m4t-large-v2")
        specs, _ = batch_specs(cfg, SHAPES["prefill_32k"])
        assert specs["enc_embeds"].shape == (32, 32768, cfg.d_model)
        _, _, _, extras, axes = decode_specs(cfg, SHAPES["decode_32k"])
        assert extras["enc_out"].shape == (128, 32768, cfg.d_model)
        assert axes["enc_out"] == ("batch", "kv_seq", "act_embed")

    def test_decode_specs_state_structure(self):
        state, tok, ln, _, _ = decode_specs(get_config("gemma3-1b"), SHAPES["decode_32k"])
        assert tok.shape == (128, 1) and ln.shape == () and ln.dtype == torch.int32
        leaves = [x for node in state["scanned"] for x in node]
        seq_lens = {x.shape[3] for x in leaves if x.ndim == 5}
        assert 1024 in seq_lens and 32768 in seq_lens
        assert all(x.is_meta for x in leaves)


def test_data_batch_specs_and_host_batch_equal_the_reference():
    cfg = pipeline.DataConfig(vocab_size=1000, seq_len=24, global_batch=3, seed=5)
    ref = ref_pipeline.DataConfig(vocab_size=1000, seq_len=24, global_batch=3, seed=5)
    specs = pipeline.batch_specs(cfg)
    assert {k: tuple(v.shape) for k, v in specs.items()} == {
        k: tuple(v.shape) for k, v in ref_pipeline.batch_specs(ref).items()}
    for step in (0, 7):
        got, want = pipeline.host_batch_numpy(cfg, step), ref_pipeline.host_batch_numpy(ref, step)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def _visible_pairs_loop(t, s, causal, window):
    off, total = s - t, 0
    for i in range(t):
        if causal:
            hi = min(s, i + off + 1)
            lo = max(0, i + off - window + 1) if window else 0
        else:
            hi = min(s, i + window) if window else s
            lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


@pytest.mark.parametrize("t,s,causal,window", [
    (64, 64, True, None), (64, 64, True, 16), (1, 300, True, None), (8, 300, True, 32),
    (40, 30, True, None), (50, 70, False, None), (50, 70, False, 9), (1, 1, True, 1)])
def test_visible_pairs_equal_the_loop(t, s, causal, window):
    assert FA.visible_pairs(t, s, causal, window) == _visible_pairs_loop(t, s, causal, window)


#: PERF.md's kernel table: (row, cost, bound in µs as the row prints it,
#: what bounds it).
BOUNDS = [
    ("1", lambda: WK.chunked_cost(4, 32, 256, 16, BF), "9.48", "operations"),
    ("2", lambda: WD.decode_cost(4, 32, 1, BF), "1.28", "bytes"),
    ("3", lambda: WD.decode_cost(4, 32, 32, BF), "2.04", "bytes"),
    ("3 K=64", lambda: WD.decode_cost(4, 32, 64, BF), "2.82", "bytes"),
    ("4", lambda: WK.chunked_cost(4, 32, 256, 16, BF, hist=True), "17.53", "bytes"),
    ("5", lambda: WB.bwd_cost(4, 32, 256, 16, BF), "22.55", "bytes"),
    ("5b", lambda: WB.bwd_cost(1, 32, 512, 16, BF), "10.96", "bytes"),
    ("6", lambda: WK.chunked_cost(1, 32, 1024, 16, BF, summary=True), "9.48", "operations"),
    ("7", lambda: WK.chunked_cost(1, 32, 512, 16, BF, hist=True, summary=True), "8.45",
     "bytes"),
    ("8", lambda: EK.scan_cost(1, 4096, 2560, F32), "37.56", "bytes"),
    ("9", lambda: ED.window_cost(4, 1, 2560, F32), "0.06", "bytes"),
    ("10", lambda: TS.shift_cost(1, 4096, 2560, 4, BF), "12.53", "bytes"),
    ("11", lambda: FA.flash_cost(1, 10, 1, 4096, 4096, 256, BF, window=2048), "65.15",
     "operations"),
    ("11b", lambda: FA.flash_cost(1, 4, 1, 4096, 4096, 256, BF, window=1024), "15.20",
     "operations"),
    ("11c", lambda: FA.flash_cost(1, 4, 1, 4096, 4096, 256, BF), "34.75", "operations"),
    ("11d", lambda: FA.flash_cost(1, 14, 2, 4096, 4096, 64, BF), "30.41", "operations"),
    ("11e", lambda: FA.flash_cost(1, 32, 8, 4096, 4096, 128, BF), "139.00", "operations"),
    ("11f", lambda: FA.flash_cost(1, 48, 8, 4096, 4096, 128, BF), "208.50", "operations"),
    ("11g", lambda: FA.flash_cost(1, 28, 4, 4096, 4096, 128, BF), "121.63", "operations"),
    ("11h", lambda: FA.flash_cost(1, 64, 4, 1024, 1024, 128, BF), "17.39", "operations"),
    ("11i", lambda: FA.flash_cost(1, 16, 16, 4096, 4096, 64, BF, causal=False), "69.48",
     "operations"),
    ("11j", lambda: FA.flash_cost(1, 16, 16, 1024, 4096, 64, BF, causal=False), "17.37",
     "operations"),
    ("11k", lambda: FA.flash_cost(4, 16, 16, 1, 1024, 64, BF, causal=False), "5.01", "bytes"),
    ("12 256^3 f32", lambda: MM.matmul_cost(256, 256, 256, F32, split=8), "0.50",
     "operations"),
    ("12 4096^3 bf16", lambda: MM.matmul_cost(4096, 4096, 4096, BF), "138.97", "operations"),
    ("12 4096^3 f32", lambda: MM.matmul_cost(4096, 4096, 4096, F32), "2051.33", "operations"),
    ("13", lambda: ST.stencil_cost(256, 512, F32), "0.31", "bytes"),
    ("13 8192^2", lambda: ST.stencil_cost(8192, 8192, F32), "160.26", "bytes"),
    ("B1", lambda: FA.flash_bwd_cost(4, 4, 1, 2048, 2048, 256, BF), "86.90", "operations"),
    ("B1 W=1024", lambda: FA.flash_bwd_cost(4, 4, 1, 2048, 2048, 256, BF, window=1024),
     "65.16", "operations"),
    ("B1b", lambda: FA.flash_bwd_cost(2, 10, 1, 1024, 1024, 256, BF, window=2048), "27.17",
     "operations"),
    ("B2", lambda: EK.scan_bwd_cost(1, 4096, 2560), "62.61", "bytes"),
    ("B3", lambda: TS.shift_bwd_cost(1, 4096, 2560, 4, BF), "18.79", "bytes"),
    ("B3b", lambda: TS.shift_bwd_cost(2, 1024, 2560, 4, BF), "9.40", "bytes"),
]


@pytest.mark.parametrize("row,cost,printed,bound_by", BOUNDS, ids=[b[0] for b in BOUNDS])
def test_kernel_cost_reproduces_perf_bound(row, cost, printed, bound_by):
    c = cost()
    digits = len(printed.split(".")[1])
    assert f"{c.bound_s() * 1e6:.{digits}f}" == printed
    assert c.bound_by() == bound_by


def test_split_k_partials_are_scratch_bytes():
    one, split = MM.matmul_cost(256, 256, 256, F32), MM.matmul_cost(256, 256, 256, F32, split=8)
    assert one.bytes == split.bytes and one.scratch_bytes == 0
    assert split.scratch_bytes == 2 * 8 * 256 * 256 * 4
    assert split.hbm_bytes == split.bytes + split.scratch_bytes

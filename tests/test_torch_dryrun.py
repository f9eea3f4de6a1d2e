"""The one-card dry run on the CPU: the abstract states against the
reference's ``ShapeDtypeStruct`` trees, the counting context against
``FlopCounterMode``, each kernel's meta twin against its plain version's
shapes, every reduced arch's forward, decode step and train step traced on
the meta device against the same run on the CPU, and the CLI."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs.registry import get_config as ref_config
from repro.model import model as JM
from repro.train import step as JT
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.core.lowering import cost_counting, kernel_scope, record_launch
from repro_torch.kernels import common
from repro_torch.kernels.elevator_scan import decode as ED
from repro_torch.kernels.elevator_scan import kernel as EK
from repro_torch.kernels.elevator_scan.ops import elevator_scan
from repro_torch.kernels.local_attention import kernel as FA
from repro_torch.kernels.local_attention.ops import flash_attention
from repro_torch.kernels.matmul_fwd import kernel as MM
from repro_torch.kernels.matmul_fwd.ops import matmul_fwd
from repro_torch.kernels.stencil2d import kernel as ST
from repro_torch.kernels.stencil2d.ops import stencil2d
from repro_torch.kernels.token_shift import kernel as TS
from repro_torch.kernels.token_shift.ops import token_shift
from repro_torch.kernels.wkv import bwd as WB
from repro_torch.kernels.wkv import decode as WD
from repro_torch.kernels.wkv import kernel as WK
from repro_torch.kernels.wkv.ops import wkv_fused, wkv_fused_summary
from repro_torch.launch import dryrun
from repro_torch.model import model as M
from repro_torch.optim import adamw
from repro_torch.serve.engine import make_decode_step, make_prefill_step
from repro_torch.train import step as T
from repro_torch.tree import tree_leaves

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list(list_archs())


# --------------------------------------------------------------------------
# The abstract states against the reference's
# --------------------------------------------------------------------------

def _walk(tree, path=()):
    """path -> (shape, dtype name) of every leaf of a dict / list /
    NamedTuple tree (a reference ShapeDtypeStruct or a port tensor)."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_walk(v, path + (k,)))
        return out
    if hasattr(tree, "_fields"):
        out = {}
        for f in tree._fields:
            out.update(_walk(getattr(tree, f), path + (f,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_walk(v, path + (i,)))
        return out
    dtype = str(tree.dtype).replace("torch.", "")
    return {path: (tuple(tree.shape), dtype)}


def _same_tree(got, want):
    g, w = _walk(got), _walk(want)
    assert g == w
    assert all(x.is_meta for x in tree_leaves(got) if isinstance(x, torch.Tensor))
    nbytes = sum(torch.Size(s).numel() * torch.empty((), dtype=getattr(torch, d)).element_size()
                 for s, d in g.values())
    assert dryrun.tree_bytes(got)[0] == nbytes


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_reference(arch):
    _same_tree(M.abstract_params(get_config(arch)), JM.abstract_params(ref_config(arch)))


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_train_state_matches_reference(arch):
    got = T.abstract_train_state(get_config(arch), compress=True)
    want = JT.abstract_train_state(ref_config(arch), compress=True)
    _same_tree(got, want)
    assert all(p.requires_grad for p in tree_leaves(got.params))


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_decode_state_matches_reference(arch):
    s = SHAPES["decode_32k"]
    got = M.abstract_decode_state(get_config(arch), s.global_batch, s.seq_len)
    want = JM.abstract_decode_state(ref_config(arch), s.global_batch, s.seq_len)
    _same_tree(got, want)


def test_init_params_on_meta_is_abstract():
    cfg = get_config("gemma3-1b").reduced()
    assert _walk(M.init_params(cfg, device="meta")) == _walk(M.abstract_params(cfg))
    with pytest.raises(ValueError, match="abstract_params"):
        M.init_mk(None, torch.float32, torch.device("meta"))
    st = adamw.abstract_state(M.abstract_params(cfg))
    assert st.step.shape == () and st.step.dtype == torch.int32
    assert all(m.dtype == torch.float32 and m.is_meta for m in tree_leaves(st.mu))


# --------------------------------------------------------------------------
# The counting context
# --------------------------------------------------------------------------

def _mlp(x, w1, w2, b):
    h = torch.nn.functional.gelu(x @ w1 + b)
    return torch.einsum("btf,fd->btd", h, w2).softmax(-1)


def _mlp_args(device, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    args = [torch.randn(s, generator=g) for s in ((2, 8, 16), (16, 32), (32, 16), (32,))]
    return [a.to(device=device, dtype=dtype) for a in args]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_aten_flops_equal_flop_counter_mode(dtype):
    with FlopCounterMode(display=False) as fc:
        _mlp(*_mlp_args("cpu", dtype))
    with cost_counting() as c:
        out = _mlp(*_mlp_args("meta", dtype))
    assert out.is_meta and out.shape == (2, 8, 16)
    cls = "bf16" if dtype == torch.bfloat16 else "f32"
    assert c.aten_flops[cls] == fc.get_total_flops() > 0
    assert sum(c.aten_flops.values()) == fc.get_total_flops()
    assert c.launches() == {}


def test_bytes_and_live_peak_by_storage():
    x = torch.empty((256, 256), device="meta")                 # 256 KiB, before the trace
    with cost_counting() as c:
        y = x * 2                                                 # new: +256 KiB
        v = y.view(-1)[:1024]                                     # a view: no bytes, no storage
        z = v + 1                                                 # new: +4 KiB
        del y                                                     # the view keeps y's storage
        live_before = c.live
        del v
        after = c.live
        w = z.clone()
    assert c.peak_live == 256 * 1024 + 4096
    assert live_before == 256 * 1024 + 4096 and after == 4096
    # x*2 reads and writes 256 KiB; v+1 reads 4 KiB of y and writes 4 KiB;
    # the clone reads and writes 4 KiB; the view moves nothing.
    assert c.aten_bytes == 2 * 256 * 1024 + 2 * 4096 + 2 * 4096
    del w, z


def test_kernel_scope_counts_live_not_aten():
    with cost_counting() as c:
        with kernel_scope():
            out = torch.empty((1024,), device="meta")
        record_launch("k", WD.decode_cost(1, 1, 1, torch.float32))
    assert c.aten_ops == 0 and c.aten_bytes == 0 and c.peak_live == 4096
    assert c.launches() == {"k": 1}
    del out


# --------------------------------------------------------------------------
# Each kernel's meta twin
# --------------------------------------------------------------------------

def _wkv(dev, b=2, h=2, t=16, dtype=torch.float32):
    g = torch.Generator().manual_seed(1)
    r, k, v = (torch.randn((b, h, t, 64), generator=g).to(dtype) for _ in range(3))
    w = torch.rand((b, h, t, 64), generator=g).clamp(0.1, 0.9).to(dtype)
    u = torch.randn((h, 64), generator=g).to(dtype)
    h0 = torch.randn((b, h, 64, 64), generator=g)
    return [a.to(dev) for a in (r, k, v, w, u, h0)]


def _meta_ops():
    """(name, fn(device) -> outputs, kernel, expected cost)."""
    f32, bf = torch.float32, torch.bfloat16

    def scan(dev, t):
        g = torch.Generator().manual_seed(2)
        a, x = torch.rand((2, t, 32), generator=g), torch.randn((2, t, 32), generator=g)
        h0 = torch.randn((2, 32), generator=g)
        return elevator_scan(a.to(dev), x.to(dev), h0.to(dev), decode=t <= 8)

    def attn(dev, t, s, causal, window):
        g = torch.Generator().manual_seed(3)
        q = torch.randn((1, 4, t, 64), generator=g).to(bf).to(dev)
        k, v = (torch.randn((1, 2, s, 64), generator=g).to(bf).to(dev) for _ in range(2))
        return flash_attention(q, k, v, causal=causal, window=window)

    def shift(dev):
        g = torch.Generator().manual_seed(4)
        x, w = torch.randn((2, 12, 48), generator=g), torch.randn((4, 48), generator=g)
        return token_shift(x.to(bf).to(dev), w.to(bf).to(dev))

    def mm(dev):
        g = torch.Generator().manual_seed(5)
        return matmul_fwd(torch.randn((64, 32), generator=g).to(dev),
                          torch.randn((32, 48), generator=g).to(dev))

    def stencil(dev):
        g = torch.Generator().manual_seed(6)
        return stencil2d(torch.randn((16, 24), generator=g).to(dev),
                         torch.tensor([0.5, 0.1, 0.1, 0.1, 0.2], device=dev))

    return [
        ("wkv chunked", lambda d: wkv_fused(*_wkv(d), chunk=8), "wkv_cuda",
         WK.chunked_cost(2, 2, 16, 8, f32)),
        ("wkv decode", lambda d: wkv_fused(*_wkv(d, t=1), decode=True), "wkv_decode_cuda",
         WD.decode_cost(2, 2, 1, f32)),
        ("wkv window", lambda d: wkv_fused(*_wkv(d, t=5), decode=True),
         "wkv_decode_window_cuda", WD.decode_cost(2, 2, 5, f32)),
        ("wkv summary", lambda d: wkv_fused_summary(*_wkv(d), chunk=8), "wkv_summary_cuda",
         WK.chunked_cost(2, 2, 16, 8, f32, summary=True)),
        ("scan", lambda d: scan(d, 16), "elevator_scan_cuda", EK.scan_cost(2, 16, 32, f32)),
        ("scan window", lambda d: scan(d, 4), "elevator_decode_window_cuda",
         ED.window_cost(2, 4, 32, f32)),
        ("token shift", shift, "token_shift_cuda", TS.shift_cost(2, 12, 48, 4, bf)),
        ("flash causal", lambda d: attn(d, 24, 24, True, None), "flash_attention_cuda",
         FA.flash_cost(1, 4, 2, 24, 24, 64, bf)),
        ("flash window", lambda d: attn(d, 24, 24, True, 5), "flash_attention_cuda",
         FA.flash_cost(1, 4, 2, 24, 24, 64, bf, window=5)),
        ("flash cross T=1", lambda d: attn(d, 1, 24, False, None), "flash_attention_cuda",
         FA.flash_cost(1, 4, 2, 1, 24, 64, bf, causal=False)),
        ("matmul", mm, "matmul_fwd_cuda",
         MM.matmul_cost(64, 48, 32, f32, MM.plan(64, 48, 32, f32, common.H100_SMS)[3])),
        ("stencil", stencil, "stencil2d_cuda", ST.stencil_cost(16, 24, f32)),
    ]


def _shapes(out):
    return [(tuple(x.shape), x.dtype) for x in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("name,fn,kernel,cost", _meta_ops(), ids=[o[0] for o in _meta_ops()])
def test_meta_twin_shapes_and_cost(name, fn, kernel, cost):
    with cost_counting() as c:
        cpu = fn("cpu")
    assert c.launches() == {}                     # a CPU tensor never takes a meta branch
    with cost_counting() as c:
        meta = fn("meta")
    assert _shapes(meta) == _shapes(cpu)
    assert c.launches() == {kernel: 1}
    tally = c.kernels[kernel]
    assert tally.bytes == cost.hbm_bytes
    assert {k: v for k, v in tally.flops.items() if v} == {k: v for k, v in cost.flops}


def _grad_ops():
    """(name, fn(device) -> loss inputs and the forward), the Functions'."""
    def wkv(dev, t):
        a = [x.requires_grad_(True) for x in _wkv(dev, t=t)]
        return a, wkv_fused(*a, chunk=8, decode=t <= 8)[0]

    def scan(dev):
        g = torch.Generator().manual_seed(7)
        a, x = (torch.rand((2, 16, 32), generator=g).to(dev).requires_grad_(True)
                for _ in range(2))
        return [a, x], elevator_scan(a, x)

    def shift(dev):
        g = torch.Generator().manual_seed(8)
        x, w = (torch.randn(s, generator=g).to(torch.bfloat16).to(dev).requires_grad_(True)
                for s in ((2, 12, 48), (4, 48)))
        return [x, w], token_shift(x, w)

    def attn(dev):
        g = torch.Generator().manual_seed(9)
        q, k, v = (torch.randn(s, generator=g).to(torch.bfloat16).to(dev).requires_grad_(True)
                   for s in ((1, 4, 24, 64), (1, 2, 24, 64), (1, 2, 24, 64)))
        return [q, k, v], flash_attention(q, k, v, causal=True, window=7)

    return [("wkv", lambda d: wkv(d, 16), {"wkv_train_cuda": 1, "wkv_bwd_cuda": 1}),
            ("wkv window", lambda d: wkv(d, 4),
             {"wkv_decode_window_cuda": 1, "wkv_train_cuda": 1, "wkv_bwd_cuda": 1}),
            ("scan", scan, {"elevator_scan_cuda": 1, "elevator_scan_bwd_cuda": 1}),
            ("token shift", shift, {"token_shift_cuda": 1, "token_shift_bwd_cuda": 1}),
            ("flash", attn, {"flash_attention_cuda": 1, "flash_attention_bwd_cuda": 1})]


@pytest.mark.parametrize("name,fn,launches", _grad_ops(), ids=[o[0] for o in _grad_ops()])
def test_function_meta_branches_forward_and_backward(name, fn, launches):
    ins, out = fn("cpu")
    want = [(tuple(g.shape), g.dtype) for g in torch.autograd.grad(out.float().sum(), ins)]
    with cost_counting() as c:
        ins, out = fn("meta")
        grads = torch.autograd.grad(out.float().sum(), ins)
    assert [(tuple(g.shape), g.dtype) for g in grads] == want
    assert c.launches() == launches


WRAPPERS = [
    (WK.wkv_cuda, lambda: _wkv("meta"), {"chunk": 8}),
    (WD.wkv_decode_cuda, lambda: _wkv("meta", t=1), {}),
    (WB.wkv_bwd_cuda, lambda: _wkv("meta")[:5] + [
        torch.empty((2, 2, 2, 64, 64), device="meta"), _wkv("meta")[0],
        torch.empty((2, 2, 64, 64), device="meta")], {"chunk": 8}),
    (EK.elevator_scan_cuda, lambda: [torch.empty((2, 8, 32), device="meta")] * 2, {}),
    (TS.token_shift_cuda, lambda: [torch.empty((2, 8, 32), device="meta"),
                                   torch.empty((4, 32), device="meta")], {}),
    (FA.flash_attention_cuda, lambda: [torch.empty((1, 2, 8, 64), device="meta")] * 3, {}),
    (MM.matmul_fwd_cuda, lambda: [torch.empty((64, 64), device="meta")] * 2, {}),
    (ST.stencil2d_cuda, lambda: [torch.empty((16, 16), device="meta"),
                                 torch.empty((5,), device="meta")], {}),
]


@pytest.mark.parametrize("wrapper,args,kw", WRAPPERS, ids=[w[0].__name__ for w in WRAPPERS])
def test_kernel_wrappers_refuse_meta_tensors(wrapper, args, kw):
    before = wrapper.launches
    with pytest.raises(ValueError, match="CUDA device"):
        wrapper(*args(), **kw)
    assert wrapper.launches == before


# --------------------------------------------------------------------------
# Every reduced arch: forward, decode step and train step on meta vs the CPU
# --------------------------------------------------------------------------

def _expected_launches(cfg, kind, n_micro=1):
    """The kernels a reduced arch's step launches on the card, from its
    layer kinds (prefill T > 64, decode K = 1, train without remat)."""
    kinds = cfg.layer_kinds
    n_attn = sum(k in ("attn", "local", "global") for k in kinds)
    n_rwkv, n_rec = kinds.count("rwkv"), kinds.count("rec")
    out = {}
    if kind == "decode":
        out = {"wkv_decode_cuda": n_rwkv, "elevator_decode_window_cuda": n_rec,
               "token_shift_cuda": n_rec}
        if cfg.is_enc_dec:
            out["flash_attention_cuda"] = cfg.num_layers
        return {k: v for k, v in out.items() if v}
    flash = n_attn + (cfg.encoder_layers + cfg.num_layers if cfg.is_enc_dec else 0)
    fwd = {"wkv_cuda": n_rwkv, "elevator_scan_cuda": n_rec, "token_shift_cuda": n_rec,
           "flash_attention_cuda": flash}
    if kind == "prefill":
        return {k: v * cfg.prefill_chunks for k, v in fwd.items() if v}
    fwd["wkv_train_cuda"] = fwd.pop("wkv_cuda")
    out = {}
    for k, v in fwd.items():
        out[k] = v * n_micro
        out[k.replace("_cuda", "_bwd_cuda").replace("wkv_train_bwd", "wkv_bwd")] = v * n_micro
    return {k: v for k, v in sorted(out.items()) if v}


TINY_DECODE = ShapeConfig("tiny_decode", 40, 2, "decode")


def _out_shapes(kind, out):
    if kind == "train":
        return {k: (tuple(v.shape), v.dtype) for k, v in out[1].items()}
    logits = out[0] if kind == "decode" else out
    return (tuple(logits.shape), logits.dtype)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_arch_on_meta_matches_cpu(arch, kind):
    cfg = get_config(arch).reduced()
    n_micro = max(1, cfg.microbatch)
    # A batch of prefill_chunks sequences scores one sequence a chunk.
    shape = {"prefill": ShapeConfig("tiny_prefill", 32, max(2, cfg.prefill_chunks), "prefill"),
             "decode": TINY_DECODE,
             "train": ShapeConfig("tiny_train", 32, n_micro, "train")}[kind]
    cpu = dryrun.make_cell(cfg, shape, device="cpu", seed=1)
    want = _out_shapes(kind, cpu.run())
    meta = dryrun.make_cell(cfg, shape, device="meta")
    with cost_counting() as c:
        got = _out_shapes(kind, meta.run())
    assert got == want
    assert c.launches() == _expected_launches(cfg, kind, n_micro)
    assert meta.state_bytes() == cpu.state_bytes()
    assert c.peak_live > 0 and c.total_flops > 0


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2-0.5b", "minitron-8b"])
def test_decode_aten_flops_equal_cpu_flop_counter(arch):
    """Attention-only decode runs no kernel, so the CPU runs the same aten
    ops as the card: the meta trace's aten FLOPs equal FlopCounterMode's."""
    cfg = get_config(arch).reduced()
    cpu = dryrun.make_cell(cfg, TINY_DECODE, device="cpu", seed=2)
    with FlopCounterMode(display=False) as fc:
        cpu.run()
    with cost_counting() as c:
        dryrun.make_cell(cfg, TINY_DECODE, device="meta").run()
    assert sum(c.aten_flops.values()) == fc.get_total_flops() > 0


def test_full_remat_records_each_forward_twice():
    cfg = dataclasses.replace(get_config("gemma3-1b").reduced(), remat="full")
    shape = ShapeConfig("tiny_train", 16, 2, "train")
    with cost_counting() as c:
        dryrun.make_cell(cfg, shape, device="meta").run()
    n = cfg.num_layers * cfg.microbatch
    assert c.launches() == {"flash_attention_bwd_cuda": n, "flash_attention_cuda": 2 * n}


@pytest.mark.parametrize("arch,launches", [
    # chip_smoke.py's phase-3h and 3e scoring forwards at B=1, T=4096.
    ("gemma3-1b", {"flash_attention_cuda": 26}),
    ("recurrentgemma-2b", {"elevator_scan_cuda": 18, "flash_attention_cuda": 8,
                           "token_shift_cuda": 18}),
    ("rwkv6-1.6b", {"wkv_cuda": 24}),
])
def test_full_width_scoring_launches_and_plans(arch, launches):
    cfg = get_config(arch)
    tokens = torch.empty((1, 4096), dtype=torch.int64, device="meta")
    with torch.inference_mode(), cost_counting() as c:
        logits = make_prefill_step(cfg)(M.abstract_params(cfg), tokens)
    assert logits.shape == (1, 4096, cfg.padded_vocab)
    assert c.launches() == launches
    if cfg.rwkv:
        declared = {dict(x.meta)["col_tile"] for x in
                    common.KERNEL_LAUNCH_SPECS["wkv_cuda"](cfg, common.H100_SMS)
                    if x.shape == "scoring B=1 T=4096"}
        assert set(c.kernels["wkv_cuda"].plans) == {repr((("col_tile", t),)) for t in declared}


def test_decode_step_on_meta_updates_state_in_place():
    cfg = get_config("rwkv6-1.6b").reduced()
    params, state = M.abstract_params(cfg), M.abstract_decode_state(cfg, 2, 16)
    ids = [id(x) for x in tree_leaves(state)]
    tokens = torch.empty((2, 1), dtype=torch.int64, device="meta")
    with torch.inference_mode():
        _, new = make_decode_step(cfg)(params, state, tokens, 3)
    assert [id(x) for x in tree_leaves(new)] == ids


# --------------------------------------------------------------------------
# The CLI
# --------------------------------------------------------------------------

def _cli(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                           "--out", str(tmp_path)], capture_output=True, text=True,
                          env=env, timeout=120, cwd=ROOT)


def test_cli_two_cells_and_a_skipped_one(tmp_path):
    """One process: the long_500k cells of all ten archs, three traced (the
    sub-quadratic archs) and seven skipped with the reference's reason."""
    r = _cli(tmp_path, "--all", "--shape", "long_500k")
    assert r.returncode == 0, r.stderr
    assert r.stdout.count("[OK]") == 3 and r.stdout.count("[SKIP]") == 7
    assert r.stdout.count("fits=True") == 3 and "failures=0" in r.stdout
    rows = {p.name.split("__")[0]: json.loads(p.read_text()) for p in tmp_path.glob("*.json")}
    assert set(rows) == set(ARCHS)
    skipped = rows["minitron_8b"]
    assert skipped["ok"] and "sub-quadratic" in skipped["skipped"]
    rw = rows["rwkv6_1_6b"]
    assert rw["launches"] == {"wkv_decode_cuda": 24}
    assert rw["memory"]["fits_one_card"] and rw["roofline"]["collective_s"] == 0.0
    assert rw["useful_flops_ratio"] > 0
    assert rows["recurrentgemma_2b"]["launches"] == {
        "elevator_decode_window_cuda": 18, "token_shift_cuda": 18}


def test_cli_skip_existing_and_multi_pod(tmp_path, capsys):
    args = ["--arch", "rwkv6-1.6b", "--shape", "long_500k", "--out", str(tmp_path)]
    with pytest.raises(SystemExit) as e:
        dryrun.main(args)
    assert e.value.code == 0
    with pytest.raises(SystemExit) as e:
        dryrun.main(args + ["--skip-existing"])
    assert e.value.code == 0 and "[CACHED]" in capsys.readouterr().out
    dryrun.main(["--table", "--out", str(tmp_path)])
    assert "| rwkv6-1.6b long_500k | yes | 3.43 / 3.93 |" in capsys.readouterr().out
    # --multi-pod reads the 512-card production mesh (no longer refused);
    # the one-card table is unchanged by its rows.
    with pytest.raises(SystemExit) as e:
        dryrun.main(args + ["--multi-pod"])
    out = capsys.readouterr().out
    assert e.value.code == 0 and "rwkv6-1.6b__long_500k__2x32x8" in out and "512 cards" in out
    dryrun.main(["--table", "--out", str(tmp_path)])
    table = capsys.readouterr().out
    assert "| rwkv6-1.6b long_500k | yes | 3.43 / 3.93 |" in table and "2x32x8" not in table


def test_extrapolated_costs_are_the_full_cell_trace():
    """The reference's return keys, each counted from the cell's one trace:
    no extrapolation, one point, the full cell's periods."""
    from repro_torch.launch.roofline_run import extrapolated_costs
    from repro_torch.model.transformer import plan_groups

    _, counter, _ = dryrun.trace_cell("recurrentgemma-2b", "long_500k")
    ex = extrapolated_costs("recurrentgemma-2b", "long_500k", counter)
    assert set(ex) == {"extrapolated", "n_periods", "n_micro", "points"}
    assert ex["points"] == {"full": ex["extrapolated"]} and ex["n_micro"] == 1
    assert ex["n_periods"] == plan_groups(get_config("recurrentgemma-2b"))[1]
    tot = ex["extrapolated"]
    assert tot["flops"] == counter.total_flops and tot["bytes"] == counter.total_bytes
    assert tot["flops_by_class"] == counter.flops_by_class() and tot["coll"] == 0.0

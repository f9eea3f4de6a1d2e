"""Rules the port keeps: it imports neither JAX nor the reference package,
it runs on the card unless the caller names the CPU, and no kernel wrapper
falls back to the plain version around a launch."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.benchmarks import matmul_plans, rodinia
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.examples import quickstart, serve_decode
from repro_torch.kernels.matmul_fwd import kernel as matmul_kernel
from repro_torch.kernels.matmul_fwd import ops as matmul_ops
from repro_torch.kernels.stencil2d import kernel as stencil_kernel
from repro_torch.kernels.stencil2d import ops as stencil_ops
from repro_torch.kernels.wkv import ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.model import model as M
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.step import init_train_state

# Tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
WRAPPERS = [PORT / "kernels" / "wkv" / n
            for n in ("kernel.py", "decode.py", "ops.py", "bwd.py", "vjp.py", "seqpar.py")]
#: The RecurrentGemma kernels' wrappers and dispatch.
RG_WRAPPERS = [PORT / "kernels" / pkg / n for pkg, names in (
    ("elevator_scan", ("kernel.py", "decode.py", "ops.py")),
    ("token_shift", ("kernel.py", "ops.py")),
    ("local_attention", ("kernel.py", "ops.py")),
) for n in names]
#: The training Functions of the kernels given a backward for training.
GRAD_WRAPPERS = [PORT / "kernels" / pkg / "vjp.py"
                 for pkg in ("elevator_scan", "token_shift", "local_attention")]
#: The paper-demo kernels' wrappers and dispatch.
PAPER_WRAPPERS = [PORT / "kernels" / pkg / n for pkg in ("stencil2d", "matmul_fwd")
                  for n in ("kernel.py", "ops.py")]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a CUDA device")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = (
        "import sys, pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", WRAPPERS, ids=lambda p: p.name)
def test_no_try_in_kernel_wrappers(path):
    tries = [n.lineno for n in ast.walk(ast.parse(path.read_text()))
             if isinstance(n, ast.Try)]
    assert not tries, f"{path.name} has try blocks at lines {tries}"


@pytest.mark.parametrize("path", RG_WRAPPERS, ids=lambda p: f"{p.parent.name}/{p.name}")
def test_no_try_in_recurrentgemma_kernel_wrappers(path):
    test_no_try_in_kernel_wrappers(path)


@pytest.mark.parametrize("path", PAPER_WRAPPERS, ids=lambda p: f"{p.parent.name}/{p.name}")
def test_no_try_in_paper_demo_kernel_wrappers(path):
    test_no_try_in_kernel_wrappers(path)


@pytest.mark.parametrize("path", GRAD_WRAPPERS, ids=lambda p: f"{p.parent.name}/{p.name}")
def test_no_try_in_training_functions(path):
    test_no_try_in_kernel_wrappers(path)


def test_training_modules_are_checked():
    """The training Functions, the train step, the launcher and the
    train_lm example are among the sources the import checks read."""
    names = {str(p.relative_to(PORT)) for p in SOURCES if p.is_relative_to(PORT)}
    for mod in ("kernels/elevator_scan/vjp.py", "kernels/token_shift/vjp.py",
                "kernels/local_attention/vjp.py", "kernels/wkv/vjp.py", "train/step.py",
                "launch/train.py", "examples/train_lm.py"):
        assert mod in names, f"{mod} is not among the sources the import checks read"


def test_paper_demo_modules_are_checked():
    names = {str(p.relative_to(PORT)) for p in SOURCES if p.is_relative_to(PORT)}
    for mod in ("core/cost_model.py", "core/elevator.py", "core/eldst.py",
                "core/scratchpad.py", "core/chunk_scan.py", "core/__init__.py",
                "kernels/stencil2d/ref.py", "kernels/stencil2d/kernel.py",
                "kernels/stencil2d/ops.py", "kernels/matmul_fwd/ref.py",
                "kernels/matmul_fwd/kernel.py", "kernels/matmul_fwd/ops.py",
                "benchmarks/rodinia.py", "examples/quickstart.py"):
        assert mod in names, f"{mod} is not among the sources the import checks read"


def test_seq_parallel_modules_are_checked():
    names = {str(p.relative_to(PORT)) for p in SOURCES if p.is_relative_to(PORT)}
    for mod in ("launch/mesh.py", "model/sharding.py", "core/device_comm.py",
                "core/pipeline.py", "kernels/wkv/seqpar.py"):
        assert mod in names, f"{mod} is not among the sources the import checks read"


def test_decoder_arch_modules_are_checked():
    """The MoE layer, the six configs of the last decoder-only archs and
    the serving example are among the sources the import checks read."""
    names = {str(p.relative_to(PORT)) for p in SOURCES if p.is_relative_to(PORT)}
    for mod in ("model/moe.py", "model/layers.py", "configs/qwen2_0_5b.py",
                "configs/minitron_8b.py", "configs/nemotron_4_15b.py",
                "configs/qwen2_vl_7b.py", "configs/dbrx_132b.py",
                "configs/qwen3_moe_235b_a22b.py", "examples/serve_decode.py"):
        assert mod in names, f"{mod} is not among the sources the import checks read"
    bad = [m for m in _imports(PORT / "model" / "moe.py")
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad


def test_dense_sharding_modules_are_checked():
    """The sharded dense layers' modules, the closed forms of their hops
    and the hill-climb are among the sources the import checks read, and
    import neither JAX nor the reference."""
    names = {str(p.relative_to(PORT)) for p in SOURCES if p.is_relative_to(PORT)}
    mods = ("model/sharding.py", "core/device_comm.py", "analysis/dense_hops.py",
            "launch/hillclimb.py", "launch/dryrun.py", "checkpoint/checkpoint.py",
            "train/step.py", "optim/adamw.py")
    for mod in mods:
        assert mod in names, f"{mod} is not among the sources the import checks read"
        bad = [m for m in _imports(PORT / mod) if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        assert not bad, (mod, bad)


def test_meshes_need_the_card_by_default(no_card):
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_mod.make_seq_mesh(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_mod.make_debug_mesh(2, 2)
    assert mesh_mod.make_seq_mesh(4, device="cpu").devices[0].type == "cpu"


def test_paper_demo_entry_points_need_the_card_by_default(no_card):
    with pytest.raises(RuntimeError, match="CUDA"):
        rodinia.make_inputs(smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        rodinia.run(reps=1, smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        rodinia.main(["--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_decode.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        matmul_plans.main(["--shapes", "64x64x64"])
    assert rodinia.make_inputs(smoke=True, device="cpu")["x1"].device.type == "cpu"


def test_paper_demo_ops_need_the_card_for_their_kernels(monkeypatch):
    # CPU tensors never reach a kernel: no library is loaded, nothing is
    # counted.  Meta tensors take the kernels' meta twins (shapes and
    # costs, nothing launched or counted); the wrappers themselves refuse a
    # tensor on any other device than the CPU, not sending it to the plain
    # version.
    def refuse(name):
        raise AssertionError(f"the {name} library was loaded for CPU tensors")

    monkeypatch.setattr(stencil_kernel, "load_library", refuse)
    monkeypatch.setattr(matmul_kernel, "load_library", refuse)
    counts = (stencil_kernel.stencil2d_cuda.launches, matmul_kernel.matmul_fwd_cuda.launches)
    x = torch.ones(8, 8)
    assert torch.equal(stencil_ops.stencil2d(x, [1.0, 0.0, 0.0, 0.0, 0.0]), x)
    assert torch.equal(matmul_ops.matmul_fwd(x, x), torch.full((8, 8), 8.0))
    assert (stencil_kernel.stencil2d_cuda.launches,
            matmul_kernel.matmul_fwd_cuda.launches) == counts
    x = torch.ones(8, 8, device="meta")
    assert stencil_ops.stencil2d(x, torch.zeros(5)).is_meta
    assert matmul_ops.matmul_fwd(x, x).shape == (8, 8)
    assert (stencil_kernel.stencil2d_cuda.launches,
            matmul_kernel.matmul_fwd_cuda.launches) == counts
    with pytest.raises(ValueError, match="CUDA"):
        stencil_kernel.stencil2d_cuda(x, torch.zeros(5, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        matmul_kernel.matmul_fwd_cuda(x, x)


def test_entry_points_need_the_card_by_default(no_card):
    cfg = get_config("rwkv6-1.6b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_decode_state(cfg, 1, 8)
    params = M.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, params)
    assert ServeEngine(cfg, params, device="cpu").device.type == "cpu"


def test_recurrentgemma_entry_points_need_the_card_by_default(no_card):
    cfg = get_config("recurrentgemma-2b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_decode_state(cfg, 1, 8, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_launch.main(["--arch", "recurrentgemma-2b", "--smoke"])
    params = M.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, params)
    assert ServeEngine(cfg, params, device="cpu").device.type == "cpu"


def test_training_entry_points_need_the_card_by_default(no_card):
    cfg = get_config("rwkv6-1.6b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2), 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_launch.main(["--arch", "rwkv6-1.6b", "--smoke", "--steps", "1"])
    state = init_train_state(cfg, device="cpu")
    assert state.params["tok"]["embedding"].device.type == "cpu"


def test_every_arch_has_a_train_step_and_a2a_without_mesh_is_the_gather_path():
    from repro_torch.configs.registry import list_archs
    from repro_torch.train.step import make_train_step

    for name in list_archs():
        assert callable(make_train_step(get_config(name).reduced()))
    # moe_impl="a2a" is ported: without a mesh its train step is the gather
    # path's, loss and grad norm bit for bit.
    cfg = get_config("dbrx-132b").reduced()
    batch = make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=8,
                                  global_batch=cfg.microbatch), 0, device="cpu")
    metrics = []
    for impl in ("gather", "a2a"):
        c = dataclasses.replace(cfg, moe_impl=impl)
        metrics.append(make_train_step(c)(init_train_state(c, device="cpu"), batch)[1])
    for k in ("loss", "grad_norm"):
        assert torch.equal(metrics[0][k], metrics[1][k])


def test_kernel_sources_are_listed():
    from repro_torch.kernels.common import KERNEL_SOURCES

    on_disk = sorted(p.relative_to(PORT) for p in PORT.rglob("*.cu"))
    assert sorted(p.relative_to(PORT) for p in KERNEL_SOURCES.values()) == on_disk


def test_use_kernel_true_on_cpu_raises():
    args = [torch.zeros(1, 1, 1, 64)] * 4 + [torch.zeros(1, 64), torch.zeros(1, 1, 64, 64)]
    with pytest.raises(ValueError, match="CUDA"):
        ops.wkv_fused(*args, use_kernel=True)


def test_engine_refuses_params_on_another_device():
    cfg = get_config("rwkv6-1.6b").reduced()
    params = M.init_params(cfg, device="cpu")
    params["tok"]["embedding"] = params["tok"]["embedding"].to("meta")
    with pytest.raises(ValueError, match="params live on"):
        ServeEngine(cfg, params, device="cpu")


def test_chip_smoke_alone_fails(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_registry_refuses_unported_and_unknown_archs():
    """Every arch of the reference is ported; an unknown name is refused."""
    from repro.configs.registry import list_archs as reference_archs  # imports no JAX

    from repro_torch.configs.registry import list_archs

    assert list_archs() == reference_archs()
    assert len(list_archs()) == 10
    assert get_config("seamless-m4t-large-v2").is_enc_dec
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    assert np.isclose(get_config("rwkv6-1.6b").param_count() / 1e9, 1.93, atol=0.01)
    assert np.isclose(get_config("recurrentgemma-2b").param_count() / 1e9, 2.66, atol=0.01)
    assert np.isclose(get_config("gemma3-1b").param_count() / 1e9, 1.00, atol=0.01)


def test_editing_a_shared_header_changes_every_library_name(tmp_path, monkeypatch):
    """The build cache hashes every ``*.cuh`` under ``kernels/`` into each
    library's name: an edited header rebuilds every library, so no stale
    library that still loads is left in ``build/``."""
    from repro_torch.kernels import common

    copies = {}
    for name, src in common.KERNEL_SOURCES.items():
        dst = tmp_path / src.relative_to(PORT / "kernels")
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_bytes(src.read_bytes())
        copies[name] = dst
    headers = sorted((PORT / "kernels").rglob("*.cuh"))
    assert headers, "the shared Hopper header is missing"
    for h in headers:
        dst = tmp_path / h.relative_to(PORT / "kernels")
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_bytes(h.read_bytes())
    monkeypatch.setattr(common, "KERNEL_SOURCES", copies)
    monkeypatch.setattr(common, "HEADER_ROOT", tmp_path)
    before = {n: common._lib_path(n) for n in copies}
    assert before == {n: common._lib_path(n) for n in copies}    # stable
    header = tmp_path / headers[0].relative_to(PORT / "kernels")
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: common._lib_path(n) for n in copies}
    assert all(after[n] != before[n] for n in copies)
    # A new header anywhere below the root counts too.
    (tmp_path / "extra.cuh").write_text("#pragma once\n")
    assert all(common._lib_path(n) != after[n] for n in copies)


def test_sources_include_the_shared_header_through_the_include_flag():
    from repro_torch.kernels import common

    assert (common.HOPPER_INCLUDE / "sm90.cuh").is_file()
    flags = list(common._NVCC_FLAGS)
    assert flags[flags.index("-I") + 1] == str(common.HOPPER_INCLUDE)
    for name in ("matmul_fwd", "flash_attention"):
        assert '#include "sm90.cuh"' in common.KERNEL_SOURCES[name].read_text()


def _load_chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: ``cuobjdump --dump-resource-usage`` of a library holding one wgmma kernel
#: and one other kernel.
_USAGE = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,8]
host = linux
compile_size = 64bit

Resource usage:
 Common:
  GLOBAL:0
 Function _ZN46_GLOBAL__N__abebe481_13_matmul_fwd_cu_bc48243619matmul_wgmma_kernelILi64EEEv14CUtensorMap_stS1_P13__nv_bfloat16Pfiiiiiii:
  REG:168 STACK:0 SHARED:16 LOCAL:0 CONSTANT[0]:680 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN46_GLOBAL__N__abebe481_13_matmul_fwd_cu_bc48243620splitk_reduce_kernelIfEEvPKfPT_mi:
  REG:16 STACK:8 SHARED:0 LOCAL:0 CONSTANT[0]:384 TEXTURE:0 SURFACE:0 SAMPLER:0
"""
_SASS = """        /*0a90*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0b10*/                   UTMALDG.2D [UR8], [UR14] ;
        /*0b20*/                   UBLKCP.S.G [UR12], [UR4], UR14 ;
"""
#: The SASS of flash attention's backward library: wgmma products, TMA
#: loads and the bulk copies of its ring's lse and delta rows.
_BWD_SASS = """        /*0c40*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24, gsb0 ;
        /*0c50*/                   UTMALDG.3D [UR8], [UR14] ;
        /*0c60*/                   UBLKCP.S.G [UR12], [UR4], UR14 ;
"""
#: The same for a WKV library (its kernel's name is filled in).
_WKV_USAGE = """
Resource usage:
 Function _ZN47_GLOBAL__N__eb81d125_14_wkv_cu_e169317214KERNELI13__nv_bfloat16Li16EEEv14CUtensorMap_st:
  REG:117 STACK:0 SHARED:1024 LOCAL:0 CONSTANT[0]:1000 TEXTURE:0 SURFACE:0 SAMPLER:0
"""


@pytest.mark.parametrize("built_by", ["this run", "an earlier run"])
def test_hopper_report_reads_the_library_file(built_by, tmp_path, monkeypatch):
    """chip_smoke's phase 1 reads the SASS counts and each wgmma kernel's
    registers, stack frame and local memory from the library file, so a
    library that an earlier run left in ``build/`` (the build report then
    says "cached") passes as a fresh one does, and a kernel with a stack
    frame still fails."""
    smoke = _load_chip_smoke()
    usage = {"text": _USAGE, "wkv": _WKV_USAGE, "decode": _WKV_USAGE, "scan": _WKV_USAGE,
             "bwd": _WKV_USAGE, "sass": _SASS, "scan_sass": _SASS, "bwd_sass": _BWD_SASS}

    def run(cmd, **kw):
        assert Path(cmd[-1]).parent == tmp_path
        lib = Path(cmd[-1]).stem[3:]                    # lib<name>.so
        if cmd[1] != "--dump-resource-usage":
            out = (usage["sass"] if lib == "wkv_decode" else
                   usage["scan_sass"] if lib in smoke.SCAN_LIBRARIES else
                   usage["bwd_sass"] if lib in smoke.BWD_LIBRARIES else _SASS)
        elif lib in smoke.WKV_TMA_LIBRARIES:
            out = usage["wkv"].replace("KERNEL", smoke.WKV_TMA_LIBRARIES[lib])
        elif lib in smoke.DECODE_LIBRARIES:
            out = usage["decode"].replace("KERNEL", smoke.DECODE_LIBRARIES[lib][0])
        elif lib in smoke.SCAN_LIBRARIES:
            out = usage["scan"].replace("KERNEL", smoke.SCAN_LIBRARIES[lib][0] + "scan_kernel")
        elif lib in smoke.BWD_LIBRARIES:
            out = usage["bwd"].replace("KERNEL", smoke.BWD_LIBRARIES[lib][0] + "dq_kernel")
        else:
            out = usage["text"]
        return subprocess.CompletedProcess(cmd, 0, stdout=out, stderr="")

    monkeypatch.setattr(smoke.subprocess, "run", run)
    report = "cached" if built_by == "an earlier run" else "ptxas info    : Used 168 registers"
    common = type("Common", (), {
        "_lib_path": staticmethod(lambda name: tmp_path / f"lib{name}.so"),
        "BUILD_REPORT": {n: (0.0, report) for n in smoke.HOPPER_LIBRARIES}})
    smoke._hopper_report(common)
    usage["text"] = _USAGE.replace("REG:168 STACK:0", "REG:168 STACK:24")
    with pytest.raises(SystemExit, match="spills"):
        smoke._hopper_report(common)
    usage["text"] = _USAGE.replace("matmul_wgmma_kernel", "matmul_kernel")
    with pytest.raises(SystemExit, match="no wgmma"):
        smoke._hopper_report(common)
    # The WKV libraries (phase 1 reads them since their TMA redesign): a
    # stack frame in their kernels fails too.
    usage["text"] = _USAGE
    smoke._hopper_report(common)
    usage["wkv"] = _WKV_USAGE.replace("STACK:0", "STACK:16")
    with pytest.raises(SystemExit, match="spills"):
        smoke._hopper_report(common)
    # The decode-step libraries (since their redesign): a spill fails, and
    # the decode window must hold its bulk copies.
    usage["wkv"] = _WKV_USAGE
    smoke._hopper_report(common)
    usage["decode"] = _WKV_USAGE.replace("LOCAL:0", "LOCAL:32")
    with pytest.raises(SystemExit, match="spills"):
        smoke._hopper_report(common)
    usage["decode"] = _WKV_USAGE
    usage["sass"] = _SASS.replace("UBLKCP", "LDG")
    with pytest.raises(SystemExit, match="UBLKCP"):
        smoke._hopper_report(common)
    # The elevator scan library (since its redesign): a spill in any of its
    # kernels fails, and its SASS must hold the TMA loads of the scan's ring.
    usage["sass"] = _SASS
    smoke._hopper_report(common)
    usage["scan"] = _WKV_USAGE.replace("STACK:0", "STACK:8")
    with pytest.raises(SystemExit, match="spills"):
        smoke._hopper_report(common)
    usage["scan"] = _WKV_USAGE
    usage["scan_sass"] = _SASS.replace("UTMALDG", "LDG")
    with pytest.raises(SystemExit, match="UTMALDG"):
        smoke._hopper_report(common)
    # Flash attention's backward library: a spill in any of its
    # kernels fails, and its SASS must hold wgmma products (HGMMA), not
    # mma.sync (HMMA) alone, with its TMA loads and bulk copies.
    usage["scan_sass"] = _SASS
    smoke._hopper_report(common)
    usage["bwd"] = _WKV_USAGE.replace("LOCAL:0", "LOCAL:28")
    with pytest.raises(SystemExit, match="spills"):
        smoke._hopper_report(common)
    usage["bwd"] = _WKV_USAGE
    usage["bwd_sass"] = _BWD_SASS.replace("HGMMA.64x128x16", "HMMA.16816")
    with pytest.raises(SystemExit, match="HGMMA"):
        smoke._hopper_report(common)
    usage["bwd_sass"] = _BWD_SASS.replace("UBLKCP", "LDG")
    with pytest.raises(SystemExit, match="UBLKCP"):
        smoke._hopper_report(common)

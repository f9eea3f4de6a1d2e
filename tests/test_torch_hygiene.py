"""Rules the port keeps: it imports neither JAX nor the reference package,
it runs on the card unless the caller names the CPU, and no kernel wrapper
falls back to the plain version around a launch."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.benchmarks import rodinia
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.examples import quickstart
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
    assert rodinia.make_inputs(smoke=True, device="cpu")["x1"].device.type == "cpu"


def test_paper_demo_ops_need_the_card_for_their_kernels(monkeypatch):
    # CPU tensors never reach a kernel: no library is loaded, nothing is
    # counted.  A tensor on any other device than the CPU is refused, not
    # sent to the plain version.
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
    with pytest.raises(ValueError, match="CUDA"):
        stencil_ops.stencil2d(x, torch.zeros(5))
    with pytest.raises(ValueError, match="CUDA"):
        matmul_ops.matmul_fwd(x, x)


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


def test_recurrentgemma_training_is_refused():
    with pytest.raises(NotImplementedError, match="backward kernel"):
        train_launch.main(["--arch", "recurrentgemma-2b", "--smoke", "--device", "cpu"])


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
    with pytest.raises(NotImplementedError):
        get_config("gemma3-1b")
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    assert np.isclose(get_config("rwkv6-1.6b").param_count() / 1e9, 1.93, atol=0.01)
    assert np.isclose(get_config("recurrentgemma-2b").param_count() / 1e9, 2.66, atol=0.01)

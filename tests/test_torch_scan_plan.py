"""The RG-LRU scan kernels' host side on the CPU: the chunked scan's plan
(``repro_torch.kernels.elevator_scan.kernel.plan_scan``), the decode
window's plan (``repro_torch.kernels.elevator_scan.decode.plan_window``),
the integers each wrapper hands its C entry point, and the constants the
plans share with ``csrc/elevator_scan.cu``.  They need no card and import
no JAX: each plan is a pure function of the shape, the dtype, the SM count
and the inputs' alignment, which the CUDA source launches as it is given."""

import inspect
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import common
from repro_torch.kernels.elevator_scan import decode as ED
from repro_torch.kernels.elevator_scan import kernel as EK

F32, BF16 = torch.float32, torch.bfloat16
SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
          / "elevator_scan" / "csrc" / "elevator_scan.cu")
#: The (B, T, D) shapes the card tests and chip_smoke.py run the scan at.
CARD_SHAPES = [(4, 256, 2560), (1, 4096, 2560), (1, 1000, 200), (2, 1, 64), (3, 129, 384),
               (2, 77, 250), (1, 65, 2563), (2, 200, 2560)]
WINDOWS = (1, 2, 8, 32, 37, 64, 65, 100)


def _cover(b, d, cols, sms):
    return b * -(-d // cols) >= sms


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,cols", [(1, 4096, 16), (4, 256, 32)])
def test_main_path_scan_plans_on_132_sms(b, t, cols, dtype):
    """RecurrentGemma's forward (B=1, T=4096) and generate prefill (B=4,
    T=256) at D=2560: 16 f32 channels a block give 160 blocks at B=1 (32
    would give 80); at B=4, 32 give 320.  bf16 takes twice the channels for
    the same bytes a row (at B=1 its narrowest tile, 80 blocks)."""
    plan = EK.plan_scan(b, t, 2560, dtype, 132)
    item = dtype.itemsize
    assert plan.mode == "ring" and EK.SCAN_ROWS["ring"] == 128
    assert plan.cols * item == cols * 4
    assert _cover(b, 2560, plan.cols, 132) == (dtype == F32 or b == 4)
    # A ring of 64 KB: 4 stages of 16 KB at B=1 (two blocks fit an SM), and
    # no more stages than T has chunks at B=4.
    assert plan.stages == min(EK.MAX_STAGES, EK.RING_BYTES // (2 * 128 * plan.cols * item),
                              -(-t // 128)) == (4 if b == 1 else 2)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("sms", [132, 114, 66, 16, 1000])
@pytest.mark.parametrize("b", [1, 2, 4, 8])
def test_scan_grid_covers_the_sms_where_it_can(b, sms, dtype):
    for d in (64, 200, 384, 2560, 4096):
        plan = EK.plan_scan(b, 256, d, dtype, sms)
        tiles = sorted({c.cols for c in EK.scan_plans(b, 256, d, dtype) if c.mode == plan.mode})
        wider = [c for c in tiles if c > plan.cols]
        assert all(not _cover(b, d, c, sms) for c in wider)
        if plan.cols != min(tiles):
            assert _cover(b, d, plan.cols, sms)


@pytest.mark.parametrize("b,t,d", CARD_SHAPES)
def test_row_pieces_are_never_under_64_bytes_in_f32(b, t, d):
    for dtype in (F32, BF16):
        for plan in EK.scan_plans(b, t, d, dtype) + EK.scan_plans(b, t, d, dtype, align=4):
            if dtype == F32:
                assert plan.cols * 4 >= 64
            if plan.mode != "loaders":
                # A lane of the chain warp takes a 4-byte word: 16 or 32 lanes.
                assert plan.cols * dtype.itemsize in EK.SCAN_ROW_BYTES
                assert plan.cols * dtype.itemsize // 4 in (16, 32)
            else:
                assert plan.cols == EK.LOADER_COLS


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,d", CARD_SHAPES)
def test_every_card_shape_gets_a_plan_and_tma_follows_the_stride_rule(b, t, d, dtype):
    plan = EK.plan_scan(b, t, d, dtype, 132)
    assert plan in EK.scan_plans(b, t, d, dtype)
    tma = (d * dtype.itemsize) % 16 == 0
    assert EK.uses_tma(d, dtype) == tma
    assert (plan.mode == "ring") == tma and (plan.mode == "loaders") == (not tma)
    assert 1 <= plan.stages <= min(EK.MAX_STAGES, -(-t // EK.SCAN_ROWS[plan.mode]))
    if plan.mode == "loaders":
        assert plan.cols == 16
    modes = {p.mode for p in EK.scan_plans(b, t, d, dtype)}
    assert modes == ({"ring", "loaders"} if tma else {"loaders"})
    # An address off the 16-byte grid takes the loader warps whatever D.
    assert EK.plan_scan(b, t, d, dtype, 132, align=8).mode == "loaders"
    assert {p.mode for p in EK.scan_plans(b, t, d, dtype, align=4)} == {"loaders"}


def test_ring_depth_fills_its_bytes_and_never_passes_t():
    for dtype in (F32, BF16):
        for cols in (16, 32, 64):
            for mode, rows in EK.SCAN_ROWS.items():
                for t in (1, 63, 64, 65, 129, 256, 4096):
                    stages = EK._stages(cols, mode, dtype.itemsize, t)
                    assert 1 <= stages <= EK.MAX_STAGES
                    assert stages <= -(-t // rows)
                    ring = 2 * stages * rows * cols * dtype.itemsize
                    assert ring <= max(EK.RING_BYTES, 2 * 2 * rows * cols * dtype.itemsize)
    # The largest ring and its barriers fit two blocks on an SM.
    assert 256 + EK.RING_BYTES <= 227 * 1024 // 2


def test_plans_are_deterministic_and_see_only_their_arguments():
    assert list(inspect.signature(EK.plan_scan).parameters) == ["b", "t", "d", "dtype", "sms",
                                                                "align"]
    assert list(inspect.signature(ED.plan_window).parameters) == ["b", "k", "d", "dtype", "sms",
                                                                  "align"]
    args = [(b, t, d, dt, sms, al) for b in (1, 4) for t in (1, 256, 4096)
            for d in (200, 2560, 2563) for dt in (F32, BF16) for sms in (132, 66)
            for al in (16, 4)]
    first = [EK.plan_scan(*a) for a in args]
    assert first == [EK.plan_scan(*a) for a in reversed(args)][::-1]
    wargs = [(b, k, d, dt, sms, al) for b in (1, 4) for k in WINDOWS
             for d in (200, 2560, 2562) for dt in (F32, BF16) for sms in (132, 66)
             for al in (16, 8, 4)]
    first = [ED.plan_window(*a) for a in wargs]
    assert first == [ED.plan_window(*a) for a in reversed(wargs)][::-1]


def test_plans_refuse_other_dtypes_and_empty_shapes():
    with pytest.raises(ValueError, match="float32"):
        EK.plan_scan(1, 8, 64, torch.float16, 132)
    with pytest.raises(ValueError, match="float32"):
        ED.plan_window(1, 8, 64, torch.float16, 132)
    with pytest.raises(ValueError, match=">= 1"):
        EK.plan_scan(1, 0, 64, F32, 132)
    with pytest.raises(ValueError, match=">= 1"):
        ED.plan_window(0, 1, 64, F32, 132)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,k,mode,vec,threads", [
    (4, 1, "regs", 4, 32), (4, 8, "tma", 1, 64), (4, 32, "tma", 1, 64), (4, 64, "tma", 1, 64),
    (1, 1, "regs", 4, 32), (1, 64, "tma", 1, 32), (4, 100, "regs", 1, 64)])
def test_main_path_window_plans_on_132_sms(b, k, mode, vec, threads, dtype):
    """A generated token (K=1) loads in 16-byte f32 accesses, 80 blocks of
    32 threads at B=4, D=2560; an admission window is staged by TMA in
    blocks of 64 channels (160 blocks); past 64 tokens the register window
    runs in pieces."""
    assert ED.plan_window(b, k, 2560, dtype, 132) == ED.WindowPlan(mode, vec, threads)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", WINDOWS)
def test_window_plans_fit_their_registers_and_cover_the_sms(k, dtype):
    for b in (1, 2, 4, 8):
        for d in (64, 200, 2560, 2562, 2563):
            for align in (16, 8, 4):
                plans = ED.window_plans(b, k, d, dtype, align)
                plan = ED.plan_window(b, k, d, dtype, 132, align)
                assert plan in plans
                for p in plans:
                    if p.mode == "regs":
                        assert d % p.vec == 0 and align % (4 * p.vec) == 0
                        assert 2 * p.vec * ED.window_kmax(k) <= ED.WINDOW_VALUES
                    else:
                        assert p.vec == 1 and k <= ED.WINDOW_TMA_KMAX
                        assert (d * dtype.itemsize) % 16 == 0 and align == 16
                assert (plan.mode == "tma") == (
                    k > 1 and ED.window_uses_tma(k, d, dtype, align))
                per_row = d // plan.vec
                sizes = ED.WINDOW_TMA_COLS if plan.mode == "tma" else ED.WINDOW_THREADS
                if plan.threads != sizes[-1]:
                    assert b * -(-per_row // plan.threads) >= 132
                assert all(b * -(-per_row // n) < 132 for n in sizes if n > plan.threads)


def test_window_kmax_is_the_source_rule():
    assert [ED.window_kmax(k) for k in (1, 2, 8, 9, 31, 32, 33, 64, 100)] == [
        1, 8, 8, 16, 32, 32, 32, 32, 32]


def test_constants_match_the_source():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("MAX_STAGES") == EK.MAX_STAGES
    assert const("RING_ROWS") == EK.SCAN_ROWS["ring"]
    assert const("LOADER_ROWS") == EK.SCAN_ROWS["loaders"]
    assert const("LOADER_COLS") == EK.LOADER_COLS
    assert const("WIN_KMAX") == ED.WINDOW_KMAX
    assert const("WIN_VALUES") == ED.WINDOW_VALUES
    assert const("WIN_TMA_KMAX") == ED.WINDOW_TMA_KMAX
    for cols in ED.WINDOW_TMA_COLS:
        assert f"threads == {cols}) return launch_window_tma<T, {cols}>" in src
    assert EK.SCAN_MODES == {"ring": 0, "loaders": 1}
    assert ED.WINDOW_MODES == {"regs": 0, "tma": 1}


class _Entry:
    """Records the integers a C entry point is called with, after its
    ``n_ptr`` pointers and before the stream."""

    def __init__(self, n_ptr):
        self.n_ptr, self.calls = n_ptr, []

    def __call__(self, *args):
        self.calls.append(list(args[self.n_ptr:-1]))
        return 0


def _stub(monkeypatch, sms=132):
    scan, window = _Entry(4), _Entry(5)

    class Lib:
        elevator_scan_fwd = scan
        elevator_decode_window_fwd = window

    for mod in (EK, ED):
        monkeypatch.setattr(mod, "load_library", lambda name: Lib())
        monkeypatch.setattr(mod, "launch_stream", lambda dev: 0)
    monkeypatch.setattr(ED, "check_scan_args", lambda *a: None)
    monkeypatch.setattr(EK, "check_scan_args", lambda *a: None)
    monkeypatch.setattr(ED, "sm_count", lambda dev: sms)
    return scan, window


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,d", [(1, 4096, 2560), (4, 256, 2560), (1, 65, 2563)])
def test_scan_wrapper_hands_the_plan_to_the_entry_point(monkeypatch, b, t, d, dtype):
    """The plumbing on the CPU, the library and the device checks stubbed:
    ints B, T, D, dtype code, cols, stages, mode; ``launch_plan`` hands over
    every plan it is given and counts no launch."""
    scan, _ = _stub(monkeypatch)
    a = torch.zeros((b, t, d), dtype=dtype)
    plans = EK.scan_plans(b, t, d, dtype, EK.pointer_alignment(a))
    before = EK.elevator_scan_cuda.launches
    for plan in plans:
        out = EK.launch_plan(a, a, None, plan=plan)
        assert out.shape == (b, t, d) and out.dtype == dtype
    code = common.DTYPE_CODE[dtype]
    assert scan.calls == [[b, t, d, code, p.cols, p.stages, EK.SCAN_MODES[p.mode]]
                          for p in plans]
    assert EK.elevator_scan_cuda.launches == before
    with pytest.raises(ValueError, match="not a plan"):
        EK.launch_plan(a, a, None, plan=EK.ScanPlan(8, 2, "ring"))


def test_scan_plan_sees_the_inputs_alignment():
    """An input that starts 4 bytes into its storage cannot take a tensor
    map, so the plan of its launch is the loader-warp variant."""
    base = torch.zeros(1 + 2 * 64 * 256, dtype=F32)
    a = base[1:].view(2, 64, 256)
    assert EK.pointer_alignment(a) == 4 and EK.pointer_alignment(base) == 16
    assert EK.plan_scan(2, 64, 256, F32, 132, EK.pointer_alignment(a)).mode == "loaders"
    assert EK.plan_scan(2, 64, 256, F32, 132, EK.pointer_alignment(base)).mode == "ring"


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,k", [(4, 1), (4, 8), (1, 64), (4, 100)])
def test_window_wrapper_hands_the_plan_to_the_entry_point(monkeypatch, b, k, dtype):
    _, window = _stub(monkeypatch)
    a = torch.zeros((b, k, 2560), dtype=dtype)
    h0 = torch.zeros((b, 2560))
    out, h = ED._launch(a, a, h0, ED.plan_window(b, k, 2560, dtype, 132))
    assert out.shape == a.shape and out.dtype == dtype and h.shape == h0.shape
    plan = ED.plan_window(b, k, 2560, dtype, 132)
    code = common.DTYPE_CODE[dtype]
    assert window.calls == [[b, k, 2560, code, plan.vec, plan.threads,
                             ED.WINDOW_MODES[plan.mode]]]
    before = ED.elevator_decode_window_cuda.launches
    plans = ED.window_plans(b, k, 2560, dtype)
    for p in plans:
        ED.launch_plan(a, a, h0, plan=p)
    assert [c[-3:] for c in window.calls[1:]] == [
        [p.vec, p.threads, ED.WINDOW_MODES[p.mode]] for p in plans]
    assert ED.elevator_decode_window_cuda.launches == before
    with pytest.raises(ValueError, match="h0 is required"):
        ED.launch_plan(a, a, None, plan=plan)


@pytest.mark.parametrize("copy", ["stamped", "floor"])
def test_stamp_edits_find_their_anchors_in_the_source(copy):
    """``benchmarks/scan_stamps.py`` instruments copies of the source at
    exact lines; each anchor must still occur once, so an edit of the
    kernel that moves one fails here, not on the card."""
    from repro_torch.benchmarks import scan_stamps as SS

    src = SS._edit(SOURCE.read_text(), SS.STAMPS)
    assert src.count("clock64()") == 6 and "g_st[" in src
    if copy == "floor":
        src = SS._edit(src, SS.FLOOR)
        assert "vx[i] = va[i];" in src and "o[r * stride]" not in src

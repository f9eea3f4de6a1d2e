"""The decode kernels' host side on the CPU: the WKV decode window's column
plan (``repro_torch.kernels.wkv.decode.plan_decode_columns``), its shared
memory, the arguments the wrapper hands the C entry point, and the C
signatures bound once per library (``repro_torch.kernels.common``).  They
need no card and import no JAX: the plan is a pure function of the shape,
the window, the dtype and the SM count, which the CUDA source launches as
it is given."""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import common
from repro_torch.kernels.wkv import decode as D
from repro_torch.kernels.wkv.kernel import SMEM_LIMIT

F32, BF16 = torch.float32, torch.bfloat16
H = 32
WINDOWS = (1, 2, 8, 32, 37, 64)
KERNELS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"

#: (B, column tile up to 8 tokens, column tile for longer windows) at the
#: decode shapes of RWKV6-1.6B (32 heads) on the H100's 132 SMs: generate
#: and serve (B=4), the seq path's generate (B=2) and one sequence (B=1).
MAIN_PATH = ((4, 64, 64), (2, 32, 64), (1, 16, 32))


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", WINDOWS)
@pytest.mark.parametrize("case", MAIN_PATH, ids=lambda c: f"B{c[0]}")
def test_main_path_plans_on_132_sms(case, k, dtype):
    b, short, long = case
    tile = D.plan_decode_columns(b, H, k, dtype, 132)
    assert tile == (short if k <= D.DECODE_SHORT else long)
    # The blocks reach 90% of the SMs up to 8 tokens, 45% beyond.
    assert b * H * (64 // tile) >= (0.9 if k <= 8 else 0.45) * 132


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", WINDOWS)
@pytest.mark.parametrize("b", [1, 2, 3, 4, 8, 16])
def test_plans_fit_and_cover_every_column_once(b, k, dtype):
    tile = D.plan_decode_columns(b, H, k, dtype, 132)
    assert tile in D.DECODE_TILES
    assert D.decode_smem_bytes(k, dtype.itemsize) <= SMEM_LIMIT
    # The grid's column blocks j0 = y * tile, y < 64 / tile; the warps of a
    # block 8 columns each.
    cover = np.zeros(64, dtype=np.int32)
    for y in range(64 // tile):
        for warp in range(tile // 8):
            cover[y * tile + 8 * warp:y * tile + 8 * warp + 8] += 1
    assert (cover == 1).all()


def test_shared_memory_fits_the_widest_window():
    """K=64 in f32 and in bf16 fit one block (and two on an SM's 228 KB);
    both need the opt-in above the 48 KB default, which the source asks for
    by size."""
    for item in (4, 2):
        assert 48 * 1024 < D.decode_smem_bytes(64, item) <= SMEM_LIMIT // 2
    assert D.decode_smem_bytes(64, 4) == 128 + 256 + 256 + 4 * 64 * 64 * 4
    # bf16 keeps the landed slabs and their f32 copy.
    assert D.decode_smem_bytes(64, 2) == 128 + 256 + 128 + 4 * 64 * 64 * (2 + 4)
    assert D.decode_smem_bytes(1, 2) < D.decode_smem_bytes(1, 4) + 4 * 64 * 4
    sizes = [D.decode_smem_bytes(k, 2) for k in range(1, 65)]
    assert sizes == sorted(sizes) and all(x % 128 == 0 for x in sizes)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", WINDOWS)
def test_plan_takes_the_widest_tile_that_fills(k, dtype):
    fill = D.DECODE_FILL if k <= D.DECODE_SHORT else D.DECODE_FILL_LONG
    for b in (1, 2, 3, 4, 8, 16):
        for sms in (132, 114, 66):
            tile = D.plan_decode_columns(b, H, k, dtype, sms)
            wider = [c for c in D.DECODE_TILES if c > tile]
            assert all(b * H * (64 // c) < fill * sms for c in wider)
            if tile != D.DECODE_TILES[-1]:
                assert b * H * (64 // tile) >= fill * sms


def test_longer_windows_take_wider_blocks():
    """Past 8 tokens the plan asks half the fill, so a window never gets a
    narrower tile than a shorter one on the same card."""
    for b in (1, 2, 3, 4):
        tiles = [D.plan_decode_columns(b, H, k, BF16, 132) for k in range(1, 65)]
        assert tiles == sorted(tiles)


def test_every_tile_is_some_card_s_plan():
    """Each tile is the plan at some SM count, so forcing the SM count
    reaches every plan through the planner itself (as the card tests do)."""
    reached = {D.plan_decode_columns(1, H, 8, BF16, sms) for sms in range(1, 2000)}
    assert reached == set(D.DECODE_TILES)


def test_plan_sees_only_the_shape_the_window_the_dtype_and_the_sms():
    assert list(inspect.signature(D.plan_decode_columns).parameters) == [
        "b", "h", "k", "dtype", "sms"]
    args = [(b, H, k, dt, sms) for b in (1, 2, 4, 8) for k in WINDOWS
            for dt in (F32, BF16) for sms in (132, 114)]
    first = [D.plan_decode_columns(*a) for a in args]
    second = [D.plan_decode_columns(*a) for a in reversed(args)][::-1]
    assert first == second


def test_plan_refuses_other_dtypes_and_windows():
    with pytest.raises(ValueError, match="float32"):
        D.plan_decode_columns(4, H, 1, torch.float16, 132)
    for k in (0, 65):
        with pytest.raises(ValueError, match="window"):
            D.plan_decode_columns(4, H, k, F32, 132)


class _Entry:
    """Records the integers a C entry point is called with, after its
    ``n_ptr`` pointers and before the stream."""

    def __init__(self, n_ptr):
        self.n_ptr, self.calls = n_ptr, []

    def __call__(self, *args):
        self.calls.append(list(args[self.n_ptr:-1]))
        return 0


def _stub(monkeypatch, sms=132):
    entry = _Entry(8)                        # r k v w u h0, out S

    class Lib:
        wkv_decode_window_fwd = entry

    monkeypatch.setattr(D, "load_library", lambda name: Lib())
    monkeypatch.setattr(D, "launch_stream", lambda dev: 0)
    monkeypatch.setattr(D, "sm_count", lambda dev: sms)
    monkeypatch.setattr(D, "check_wkv_args", lambda *a, **kw: None)
    return entry


def _args(b, k, dtype=F32):
    x = torch.zeros((b, H, k, 64), dtype=dtype)
    return [x] * 4 + [torch.zeros((H, 64), dtype=dtype), torch.zeros((b, H, 64, 64))]


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,k", [(4, 1), (4, 32), (1, 64), (2, 8)])
def test_wrapper_hands_the_plan_to_the_entry_point(monkeypatch, b, k, dtype):
    """The plumbing on the CPU, the library and the device checks stubbed:
    ints B, H, K, Dh, dtype code, column tile; ``launch_plan`` hands over
    the tile it is given, counting no launch."""
    entry = _stub(monkeypatch)
    out, s = D._launch("t", *_args(b, k, dtype))
    assert out.shape == (b, H, k, 64) and out.dtype == dtype
    assert s.shape == (b, H, 64, 64) and s.dtype == F32
    code = common.DTYPE_CODE[dtype]
    assert entry.calls == [[b, H, k, 64, code, D.plan_decode_columns(b, H, k, dtype, 132)]]
    before = (D.wkv_decode_cuda.launches, D.wkv_decode_window_cuda.launches)
    for tile in D.DECODE_TILES:
        D.launch_plan(*_args(b, k, dtype), col_tile=tile)
    assert [c[-1] for c in entry.calls[1:]] == list(D.DECODE_TILES)
    assert (D.wkv_decode_cuda.launches, D.wkv_decode_window_cuda.launches) == before


def test_wrapper_takes_the_plan_of_the_card_it_runs_on(monkeypatch):
    entry = _stub(monkeypatch, sms=1000)
    D._launch("t", *_args(1, 8))
    assert entry.calls[-1][-1] == D.plan_decode_columns(1, H, 8, F32, 1000) == 8
    D._launch("t", *_args(1, 1))
    assert entry.calls[-1][-1] == 8


def test_windows_outside_the_kernel_are_refused(monkeypatch):
    _stub(monkeypatch)
    with pytest.raises(ValueError, match="window of 65 tokens"):
        D._launch("t", *_args(1, 65))


def _called_entries():
    """(library, entry point) of every C call a wrapper of the package makes
    through ``load_library``."""
    found = set()
    for path in KERNELS.rglob("*.py"):
        text = path.read_text()
        for lib, entry in re.findall(r'load_library\("(\w+)"\)\.(\w+)', text):
            found.add((lib, entry))
        if 'getattr(load_library("wkv_chunked"), entry)' in text:
            from repro_torch.kernels.wkv import kernel as KC

            found |= {("wkv_chunked", e) for e in KC._ENTRIES.values()}
    return found


def test_every_entry_point_called_has_its_signature_bound():
    """Each C function a wrapper calls is bound once, when its library is
    loaded (``common.ENTRY_POINTS``), and no wrapper sets ``argtypes`` on a
    call."""
    called = _called_entries()
    assert ("wkv_decode", "wkv_decode_window_fwd") in called
    assert ("token_shift", "token_shift_fwd") in called
    for lib, entry in called:
        assert entry in common.ENTRY_POINTS[lib], (lib, entry)
    assert set(common.ENTRY_POINTS) == set(common.KERNEL_SOURCES)
    for path in KERNELS.rglob("*.py"):
        if path.name != "common.py":
            assert "argtypes" not in path.read_text(), path


def test_entry_point_signatures_match_the_sources():
    """The bound argument types follow each source's extern "C" signature:
    a pointer (c_void_p) for every pointer and the stream, c_int for every
    int, c_float for every float."""
    kinds = {common._P: "p", common._I: "i", common._F: "f"}
    for lib, entries in common.ENTRY_POINTS.items():
        src = common.KERNEL_SOURCES[lib].read_text()
        for entry, argtypes in entries.items():
            m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
            assert m, (lib, entry)
            params = [p.strip() for p in m.group(1).split(",")]
            want = ["p" if "*" in p else ("f" if p.startswith("float") else "i")
                    for p in params]
            assert [kinds[a] for a in argtypes] == want, (lib, entry)


def test_open_library_binds_every_entry_point(monkeypatch):
    class Fn:
        pass

    class Lib:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, name):
            fn = Fn()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(common.ctypes, "CDLL", Lib)
    lib = common.open_library("wkv_decode", "/nonexistent.so")
    for entry, argtypes in common.ENTRY_POINTS["wkv_decode"].items():
        fn = getattr(lib, entry)
        assert fn.argtypes == argtypes and fn.restype is common.ctypes.c_int

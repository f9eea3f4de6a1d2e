"""The token shift backward's host side on the CPU: its plan
(``repro_torch.kernels.token_shift.kernel.plan_shift_bwd``), the integers
the wrapper hands its C entry point, and the constants the plan shares with
``csrc/token_shift.cu``.  They need no card and import no JAX: a plan is a
pure function of the shape, the tap count, the dtype, the SM count and the
inputs' alignment, which the CUDA source launches as it is given."""

import inspect
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import common
from repro_torch.kernels.token_shift import kernel as TS

F32, BF16 = torch.float32, torch.bfloat16
SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
          / "token_shift" / "csrc" / "token_shift.cu")
#: The (B, T, D, taps) shapes the card tests and chip_smoke.py run the
#: backward at: RecurrentGemma's training microbatch and its 4096-token
#: row, the decode-sized windows, a D off the slot, the narrowest D.
CARD_SHAPES = [(1, 4096, 2560, 4), (2, 1024, 2560, 4), (4, 4, 2560, 4), (4, 9, 2560, 4),
               (4, 67, 2560, 4), (4, 259, 2560, 4), (2, 130, 2562, 3), (1, 9, 64, 8),
               (2, 300, 2560, 4), (3, 5, 40, 2)]
SMS = (132, 114, 66, 16, 1000)


def _stripes(d, dtype):
    return -(-d // (TS.slot_channels(dtype) * TS.BWD_MAX_COLS))


def _units(b, t, plan):
    """The C kernel's units, each (batch row, first row, end), in the order
    its lanes take them: lane i of the cluster takes units i, i + lanes, ..."""
    per = -(-t // plan.rows)
    return [(u // per, (u % per) * plan.rows, min(t, (u % per) * plan.rows + plan.rows))
            for u in range(b * per)]


def _flight(plan, taps, dtype, d):
    """Bytes in flight a lane of every stripe adds: its ring's sub-tiles
    ahead of the one it computes, 32 bytes a row and slot column."""
    stripes = -(-d // (TS.slot_channels(dtype) * plan.cols))
    return (TS.BWD_STAGES - 1) * TS.bwd_sub(taps, dtype) * 32 * plan.cols * stripes


@pytest.mark.parametrize("dtype,lanes", [(BF16, 32), (F32, 16)], ids=["bf16", "f32"])
@pytest.mark.parametrize("b,t", [(1, 4096), (2, 1024)])
def test_main_path_plans_on_132_sms(b, t, dtype, lanes):
    """RecurrentGemma's backward shapes at D=2560: 40 stripes of 64 bf16
    channels (80 of 32 f32), 16-byte copies, as many lanes a stripe as keep
    3 MiB in flight (32 bf16, 16 f32), in clusters that give the 132 SMs a
    block each (160 blocks of 8 lanes)."""
    plan = TS.plan_shift_bwd(b, t, 2560, 4, dtype, 132)
    assert plan == TS.ShiftBwdPlan(8, 8, lanes // 8, b * t // lanes, True)
    assert _stripes(2560, dtype) * plan.cluster == 160
    assert lanes * _flight(plan, 4, dtype, 2560) >= TS.BWD_IN_FLIGHT
    assert lanes // 2 * _flight(plan, 4, dtype, 2560) < TS.BWD_IN_FLIGHT


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("sms", SMS)
def test_grid_covers_the_sms_where_it_can(sms, dtype):
    """The smallest cluster whose blocks cover the SMs, among those that
    leave 4 to 16 lanes a block; the largest of them where none does."""
    for b, t in ((1, 4096), (2, 1024), (4, 4), (4, 9), (4, 67), (8, 300)):
        for d in (64, 200, 2560, 2562, 8192):
            plan = TS.plan_shift_bwd(b, t, d, 4, dtype, sms)
            lanes = plan.cluster * plan.groups
            sizes = [c for c in (1, 2, 4, 8) if 4 <= lanes // c <= 16 and lanes % c == 0]
            assert plan.cluster in sizes
            covers = [c for c in sizes if _stripes(d, dtype) * c >= sms]
            assert plan.cluster == (covers[0] if covers else sizes[-1])


@pytest.mark.parametrize("b,t,d,taps", CARD_SHAPES)
def test_lanes_hold_the_bytes_in_flight_or_every_row(b, t, d, taps):
    """The fewest lanes a stripe (a power of two from 4 to 128) whose rings
    hold BWD_IN_FLIGHT bytes, halved while they pass B * T rows."""
    for dtype in (F32, BF16):
        plan = TS.plan_shift_bwd(b, t, d, taps, dtype, 132)
        flight = _flight(plan, taps, dtype, d)
        want = next((n for n in (4, 8, 16, 32, 64) if n * flight >= TS.BWD_IN_FLIGHT), 128)
        while want > 4 and want > b * t:
            want //= 2
        assert plan.cluster * plan.groups == want


@pytest.mark.parametrize("b,t,d,taps", CARD_SHAPES + [(70, 3, 64, 4), (5, 1, 8, 2)])
def test_units_cover_every_row_once_and_fit_the_lanes(b, t, d, taps):
    """Every plan's units tile each batch row, none crossing into the next;
    they are the fewest rows whose count the lanes cover (one unit a lane)
    wherever the lanes are at least B."""
    for dtype in (F32, BF16):
        for plan in TS.shift_bwd_plans(b, t, d, taps, dtype):
            lanes = plan.cluster * plan.groups
            units = _units(b, t, plan)
            covered = sorted((bb, r) for bb, t0, t1 in units for r in range(t0, t1))
            assert covered == [(bb, r) for bb in range(b) for r in range(t)]
            if lanes >= b:
                assert len(units) <= lanes
                assert plan.rows == 1 or b * -(-t // (plan.rows - 1)) > lanes
            else:
                assert plan.rows == t


@pytest.mark.parametrize("b,t,d,taps", CARD_SHAPES)
def test_scalar_variant_exactly_where_the_layout_demands_it(b, t, d, taps):
    """16-byte copies where D is a multiple of the slot and the inputs are
    16-byte aligned; the scalar variant wherever either fails, in every
    plan."""
    for dtype in (F32, BF16):
        v = TS.slot_channels(dtype)
        for align in (16, 8, 4, 2):
            want = d % v == 0 and align == 16
            assert TS.plan_shift_bwd(b, t, d, taps, dtype, 132, align).vec == want
            assert {p.vec for p in TS.shift_bwd_plans(b, t, d, taps, dtype, align)} == {want}


@pytest.mark.parametrize("b,t,d,taps", CARD_SHAPES)
def test_chosen_plan_is_one_of_the_plans(b, t, d, taps):
    for dtype in (F32, BF16):
        for sms in SMS:
            for align in (16, 4):
                plans = TS.shift_bwd_plans(b, t, d, taps, dtype, align)
                assert TS.plan_shift_bwd(b, t, d, taps, dtype, sms, align) in plans
                assert len(set(plans)) == len(plans) == 4 * len(TS.BWD_GROUPS)


def test_plans_are_deterministic_and_see_only_their_arguments():
    assert list(inspect.signature(TS.plan_shift_bwd).parameters) == [
        "b", "t", "d", "taps", "dtype", "sms", "align"]
    assert list(inspect.signature(TS.shift_bwd_plans).parameters) == [
        "b", "t", "d", "taps", "dtype", "align"]
    args = [(b, t, d, taps, dt, sms, al) for b in (1, 2, 4) for t in (1, 9, 1024, 4096)
            for d in (64, 2560, 2562) for taps in (2, 4, 8) for dt in (F32, BF16)
            for sms in (132, 66) for al in (16, 4)]
    first = [TS.plan_shift_bwd(*a) for a in args]
    TS.plan_shift_bwd.cache_clear()
    assert first == [TS.plan_shift_bwd(*a) for a in reversed(args)][::-1]
    assert [TS.shift_bwd_plans(*a[:5], a[6]) for a in args] == [
        TS.shift_bwd_plans(*a[:5], a[6]) for a in args]


@pytest.mark.parametrize("call", [
    lambda: TS.plan_shift_bwd(1, 8, 64, 4, torch.float16, 132),
    lambda: TS.shift_bwd_plans(1, 8, 64, 4, torch.float64),
    lambda: TS.plan_shift_bwd(1, 0, 64, 4, F32, 132),
    lambda: TS.plan_shift_bwd(0, 8, 64, 4, F32, 132),
    lambda: TS.shift_bwd_plans(1, 8, 0, 4, BF16),
    lambda: TS.plan_shift_bwd(1, 8, 64, 1, F32, 132),
    lambda: TS.shift_bwd_plans(1, 8, 64, 9, F32),
    lambda: TS.plan_shift_bwd(1, 8, 64, 4, F32, 0),
], ids=["f16", "f64", "t0", "b0", "d0", "taps1", "taps9", "sms0"])
def test_plans_refuse_bad_shapes_and_dtypes(call):
    with pytest.raises(ValueError):
        call()


def test_constants_and_shared_memory_match_the_source():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("BWD_THREADS") == TS.BWD_THREADS
    assert const("BWD_MAX_COLS") == TS.BWD_MAX_COLS
    assert const("BWD_MAX_CLUSTER") == TS.BWD_MAX_CLUSTER
    assert const("BWD_STAGES") == TS.BWD_STAGES
    assert const("MAX_TAPS") == TS.MAX_TAPS
    # The mirrors' formulas are the source's.
    assert "return taps <= 4 ? 8 : v == 4 ? 2 : 1;" in src
    assert "const int ring = BWD_STAGES * bwd_sub(taps, v) * 32 * cols * groups;" in src
    assert "const int sums = (groups + 1) * taps * cols * v * 4;" in src
    assert "return ring > sums ? ring : sums;" in src
    assert [TS.bwd_sub(k, BF16) for k in range(2, 9)] == [8, 8, 8, 1, 1, 1, 1]
    assert [TS.bwd_sub(k, F32) for k in range(2, 9)] == [8, 8, 8, 2, 2, 2, 2]
    # No plan has more threads than the bounds; every plan's shared memory
    # fits two blocks an SM (227 KB), the planner's four.
    for b, t, d, taps in CARD_SHAPES:
        for dtype in (F32, BF16):
            for plan in TS.shift_bwd_plans(b, t, d, taps, dtype):
                assert plan.cols * plan.groups <= TS.BWD_THREADS
                assert plan.cols <= TS.BWD_MAX_COLS and plan.cluster <= TS.BWD_MAX_CLUSTER
                assert 2 * TS.bwd_smem_bytes(plan, taps, dtype) <= 227 * 1024
            chosen = TS.plan_shift_bwd(b, t, d, taps, dtype, 132)
            assert 4 * TS.bwd_smem_bytes(chosen, taps, dtype) <= 227 * 1024
    # The main path's block: a ring of 3 sub-tiles of 8 rows, 32 bytes a
    # row, 64 threads; at the most taps and lanes the partials outgrow the
    # ring of 1-row sub-tiles: 17 x 8 x 64 x 4.
    main = TS.plan_shift_bwd(1, 4096, 2560, 4, BF16, 132)
    assert TS.bwd_smem_bytes(main, 4, BF16) == 3 * 8 * 32 * 64 == 49152
    most = TS.ShiftBwdPlan(8, 16, 8, 32, True)
    assert TS.bwd_smem_bytes(most, TS.MAX_TAPS, BF16) == 17 * 8 * 64 * 4


class _Entry:
    """Records the integers a C entry point is called with, after its
    ``n_ptr`` pointers and before the stream."""

    def __init__(self, n_ptr):
        self.n_ptr, self.calls = n_ptr, []

    def __call__(self, *args):
        self.calls.append(list(args[self.n_ptr:-1]))
        return 0


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,d,taps", [(1, 4096, 2560, 4), (2, 1024, 2560, 4),
                                        (2, 130, 2562, 3)])
def test_wrapper_hands_the_plan_to_the_entry_point(monkeypatch, b, t, d, taps, dtype):
    """The plumbing on the CPU, the library and the device checks stubbed:
    five pointers, then ints B, T, D, taps, dtype code, cols, groups,
    cluster, rows, vec; ``launch_bwd_plan`` hands over every plan it is
    given, counts no launch and refuses a plan of other inputs."""
    entry = _Entry(5)

    class Lib:
        token_shift_bwd = entry

    monkeypatch.setattr(TS, "load_library", lambda name: Lib())
    monkeypatch.setattr(TS, "launch_stream", lambda dev: 0)
    monkeypatch.setattr(TS, "check_kernel_tensors", lambda *a, **k: None)
    x = torch.zeros((b, t, d), dtype=dtype)
    w = torch.zeros((taps, d), dtype=dtype)
    plans = TS.shift_bwd_plans(b, t, d, taps, dtype, common.pointer_alignment(x, w))
    before = TS.token_shift_bwd_cuda.launches
    for plan in plans:
        dx, dw = TS.launch_bwd_plan(x, w, x, plan=plan)
        assert dx.shape == x.shape and dw.shape == w.shape and dx.dtype == dw.dtype == dtype
    code = common.DTYPE_CODE[dtype]
    assert entry.calls == [[b, t, d, taps, code, p.cols, p.groups, p.cluster, p.rows,
                            int(p.vec)] for p in plans]
    assert TS.token_shift_bwd_cuda.launches == before
    with pytest.raises(ValueError, match="not a plan"):
        TS.launch_bwd_plan(x, w, x, plan=TS.ShiftBwdPlan(8, 16, 3, 1, True))


def test_plan_sees_the_inputs_alignment():
    """An input that starts 4 bytes into its storage takes the scalar
    variant; the same storage from its start the 16-byte copies."""
    base = torch.zeros(1 + 2 * 64 * 256, dtype=F32)
    x = base[1:].view(2, 64, 256)
    assert common.pointer_alignment(x) == 4 and common.pointer_alignment(base) == 16
    assert not TS.plan_shift_bwd(2, 64, 256, 4, F32, 132, common.pointer_alignment(x)).vec
    assert TS.plan_shift_bwd(2, 64, 256, 4, F32, 132, common.pointer_alignment(base)).vec

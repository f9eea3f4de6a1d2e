"""The WKV kernels' plans on the CPU: the chunked forward's value-column tile
(``repro_torch.kernels.wkv.kernel.plan_columns``) and the backward's cluster
size (``repro_torch.kernels.wkv.bwd.plan_cluster``).  They need no card and
import no JAX: pure functions of the shape, the chunk, the dtype and the SM
count, which the CUDA sources launch as they are given."""

import inspect

import numpy as np
import pytest
import torch

from repro_torch.kernels.wkv import bwd as BW
from repro_torch.kernels.wkv import kernel as K

F32, BF16 = torch.float32, torch.bfloat16
H = 32

#: (name, B, T, chunk, column tile, cluster) at each main-path shape of
#: RWKV6-1.6B (32 heads) on the H100's 132 SMs: serving's prefill (B=4,
#: 256-token prompts), a training microbatch (B=4, T=256), a seq-prefill
#: shard (B=1, 1024 of 4096 tokens), a seq-generate shard (B=2, 512 of
#: 2048) and a seq-gradient shard (B=1, 512 of 2048).
MAIN_PATH = (
    ("serve prefill", 4, 256, 16, 64, 1),
    ("train microbatch", 4, 256, 16, 64, 1),
    ("seq prefill shard", 1, 1024, 16, 16, 2),
    ("seq generate shard", 2, 512, 16, 32, 1),
    ("seq gradient shard", 1, 512, 16, 16, 2),
)
SHAPES = [(b, t, c) for b in (1, 2, 3, 4, 8, 16) for t, c in
          ((256, 16), (100, 10), (64, 64), (257, 1), (64, 32), (16, 16), (1024, 16), (96, 4))]


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", MAIN_PATH, ids=lambda c: c[0].replace(" ", "-"))
def test_main_path_plans_on_132_sms(case, dtype):
    _, b, t, chunk, tile, cluster = case
    assert K.plan_columns(b, H, t, chunk, dtype, 132) == tile
    assert BW.plan_cluster(b, H, t, chunk, dtype, 132) == cluster
    # The forward keeps one block (12 warps) on at least 90% of the SMs;
    # the backward's blocks reach at least 45% of them.
    assert b * H * (64 // tile) >= 0.9 * 132
    assert b * H * cluster >= 0.45 * 132


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B{}-T{}-L{}".format(*s))
def test_plans_fit_and_cover_every_column_once(shape, dtype):
    b, t, chunk = shape
    item = torch.empty((), dtype=dtype).element_size()
    tile = K.plan_columns(b, H, t, chunk, dtype, 132)
    assert tile in K.COL_TILES
    assert K.fwd_smem_bytes(chunk, tile, item) <= K.SMEM_LIMIT
    # The grid's column blocks j0 = x * tile, x < 64 / tile.
    cover = np.zeros(64, dtype=np.int32)
    for x in range(64 // tile):
        cover[x * tile:(x + 1) * tile] += 1
    assert (cover == 1).all()
    if chunk <= BW.BWD_MAX_CHUNK:
        cluster = BW.plan_cluster(b, H, t, chunk, dtype, 132)
        assert cluster in BW.CLUSTERS
        assert BW.bwd_smem_bytes(chunk, cluster, item) <= K.SMEM_LIMIT
        # Rank q owns value columns and key rows [64q / C, 64(q+1) / C).
        cover = np.zeros(64, dtype=np.int32)
        for q in range(cluster):
            cover[q * 64 // cluster:(q + 1) * 64 // cluster] += 1
        assert (cover == 1).all()


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_plans_take_the_widest_tile_and_smallest_cluster_that_fill(dtype):
    for b in (1, 2, 3, 4, 8, 16):
        for sms in (132, 114, 66):
            tile = K.plan_columns(b, H, 256, 16, dtype, sms)
            wider = [c for c in K.COL_TILES if c > tile]
            assert all(b * H * (64 // c) < K.FILL * K.BLOCKS_PER_SM * sms for c in wider)
            cluster = BW.plan_cluster(b, H, 256, 16, dtype, sms)
            smaller = [c for c in BW.CLUSTERS if c < cluster]
            assert all(b * H * c < BW.FILL * sms for c in smaller)


def test_shared_memory_narrows_the_largest_chunks():
    """Chunk 64 fits the forward's 8-column tile in f32 and 16 or 8 columns
    in bf16; chunk 32 of the backward fits a cluster of 4 in f32 and of 2
    or 4 in bf16."""
    assert [c for c in K.COL_TILES if K.fwd_smem_bytes(64, c, 4) <= K.SMEM_LIMIT] == [8]
    assert [c for c in K.COL_TILES if K.fwd_smem_bytes(64, c, 2) <= K.SMEM_LIMIT] == [16, 8]
    assert K.plan_columns(16, H, 256, 64, F32, 132) == 8
    assert K.plan_columns(16, H, 256, 64, BF16, 132) == 16
    assert [c for c in BW.CLUSTERS if BW.bwd_smem_bytes(32, c, 4) <= K.SMEM_LIMIT] == [4]
    assert [c for c in BW.CLUSTERS if BW.bwd_smem_bytes(32, c, 2) <= K.SMEM_LIMIT] == [2, 4]
    assert BW.plan_cluster(16, H, 256, 32, F32, 132) == 4
    assert BW.plan_cluster(16, H, 256, 32, BF16, 132) == 2


def test_every_tile_and_cluster_fits_at_the_model_chunk():
    """At chunk 16 every column tile and every cluster size fits, so the
    card tests and ``chip_smoke.py`` can time them all."""
    for item in (2, 4):
        assert all(K.fwd_smem_bytes(16, c, item) <= K.SMEM_LIMIT for c in K.COL_TILES)
        assert all(BW.bwd_smem_bytes(16, c, item) <= K.SMEM_LIMIT for c in BW.CLUSTERS)


def test_plans_never_see_the_t_stride():
    """The plans take the shape, the chunk, the dtype and the SM count:
    no stride, no tensor."""
    for fn in (K.plan_columns, BW.plan_cluster):
        assert list(inspect.signature(fn).parameters) == ["b", "h", "t", "chunk", "dtype", "sms"]


class _FakeEntry:
    """Records the integers a C entry point is called with, after its
    ``n_ptr`` pointers and before the stream."""

    def __init__(self, calls, n_ptr):
        self.calls, self.n_ptr = calls, n_ptr

    def __call__(self, *args):
        self.calls.append(list(args[self.n_ptr:-1]))
        return 0


@pytest.mark.parametrize("summary", [False, True], ids=["hist", "summary"])
def test_a_window_launch_takes_the_contiguous_plan(monkeypatch, summary):
    """The wrappers' plumbing on the CPU, the library and the device checks
    stubbed: a T-window (tokens 512..1024 of 2048) and its contiguous copy
    reach the C entry point with different T strides and one plan."""
    from repro_torch.kernels.wkv import kernel as KM

    calls = []

    class Lib:
        def __getattr__(self, name):
            return _FakeEntry(calls, 9 + summary)      # r k v w u h0, out S s_hist [a_seg]

    monkeypatch.setattr(KM, "load_library", lambda name: Lib())
    monkeypatch.setattr(KM, "launch_stream", lambda dev: 0)
    monkeypatch.setattr(KM, "sm_count", lambda dev: 132)
    monkeypatch.setattr(KM, "check_kernel_tensors", lambda *a, **kw: None)
    b, full_t, t = 1, 2048, 512
    x = torch.zeros((b, H, full_t, 64))
    win = [x[:, :, 512:1024]] * 4
    flat = [w.contiguous() for w in win]
    u, h0 = torch.zeros((H, 64)), torch.zeros((b, H, 64, 64))
    for args in (win, flat):
        KM._launch_chunked("t", *args, u, h0, 16, with_hist=True, with_summary=summary)
    (wi, fl) = calls
    if summary:
        # ints: B, H, T, T_stride, Dh, chunk, dtype, col_tile
        assert wi[3] == full_t and fl[3] == t
        assert wi[:3] + wi[4:] == fl[:3] + fl[4:]
    assert wi[-1] == fl[-1] == K.plan_columns(b, H, t, 16, F32, 132)


def test_backward_window_launch_takes_the_contiguous_plan(monkeypatch):
    from repro_torch.kernels.wkv import bwd as BM

    calls = []

    class Lib:
        wkv_bwd = _FakeEntry(calls, 14)

    monkeypatch.setattr(BM, "load_library", lambda name: Lib())
    monkeypatch.setattr(BM, "launch_stream", lambda dev: 0)
    monkeypatch.setattr(BM, "sm_count", lambda dev: 132)
    monkeypatch.setattr(BM, "check_kernel_tensors", lambda *a, **kw: None)
    b, full_t, t, chunk = 1, 2048, 512, 16
    x = torch.zeros((b, H, full_t, 64))
    win = [x[:, :, 512:1024]] * 4
    flat = [w.contiguous() for w in win]
    u = torch.zeros((H, 64))
    hist = torch.zeros((b, H, t // chunk, 64, 64))
    d_out, d_s = torch.zeros((b, H, t, 64)), torch.zeros((b, H, 64, 64))
    for args in (win, flat):
        BM.launch_plan(*args, u, hist, d_out, d_s, chunk=chunk)
    (wi, fl) = calls
    # ints: B, H, T, T_stride, Dh, chunk, dtype, cluster
    assert wi[3] == full_t and fl[3] == t
    assert wi[:3] + wi[4:] == fl[:3] + fl[4:]
    assert wi[-1] == BW.plan_cluster(b, H, t, chunk, F32, 132) == 2


def test_plans_are_pure_functions():
    args = [(b, H, t, c, dt, sms) for b, t, c in SHAPES for dt in (F32, BF16)
            for sms in (132, 114)]
    first = [(K.plan_columns(*a), BW.plan_cluster(*a) if a[3] <= 32 else None) for a in args]
    second = [(K.plan_columns(*a), BW.plan_cluster(*a) if a[3] <= 32 else None)
              for a in reversed(args)][::-1]
    assert first == second


def test_plans_refuse_other_dtypes_and_ragged_chunks():
    with pytest.raises(ValueError, match="float32"):
        K.plan_columns(4, H, 256, 16, torch.float16, 132)
    with pytest.raises(ValueError, match="float32"):
        BW.plan_cluster(4, H, 256, 16, torch.float16, 132)
    with pytest.raises(ValueError, match="divisible"):
        K.plan_columns(4, H, 100, 16, F32, 132)

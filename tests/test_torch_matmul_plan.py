"""The matmul planner (``repro_torch.kernels.matmul_fwd.kernel.plan``) on the
CPU: it needs no card and imports no JAX.  It chooses the variant, the
output tile and the split of K that the CUDA source launches."""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import card_checks as CC
from repro_torch.kernels.matmul_fwd.kernel import FILL, MAX_SPLIT, VARIANTS, plan

F32, BF16 = torch.float32, torch.bfloat16

#: (M, N, K): the Rodinia suite's 256^3, 4096^3, every MATMUL_CASES shape of
#: the card checks, and shapes that are small, skinny, deep or unaligned.
SHAPES = sorted({(m, n, k) for m, k, n, *_ in CC.MATMUL_CASES} | {
    (256, 256, 256), (4096, 4096, 4096), (128, 128, 128), (512, 384, 256),
    (100, 72, 36), (96, 60, 100), (3, 7, 5), (64, 64, 16), (1, 4096, 4096),
    (4096, 1, 4096), (4096, 4096, 1), (8192, 8192, 64), (320, 2560, 10240),
    (1000, 1000, 1000), (17, 33, 65), (129, 257, 8),
})
SMS = (132, 114)


def _k_step(variant):
    return VARIANTS[variant][1]


def _splits_allowed(k, variant):
    """Divisors of the k-tiles, at most MAX_SPLIT, that leave each K range
    at least the variant's fewest k-tiles (1 = no split is always allowed)."""
    k_tiles = -(-k // _k_step(variant))
    min_kt = VARIANTS[variant][2]
    return [d for d in range(1, min(k_tiles, MAX_SPLIT) + 1)
            if k_tiles % d == 0 and (d == 1 or k_tiles // d >= min_kt)]


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tiles_cover_the_output_once(shape, dtype, sms):
    m, n, k = shape
    variant, tile_m, tile_n, _ = plan(m, n, k, dtype, sms)
    assert (tile_m, tile_n) in VARIANTS[variant][3]
    cover = np.zeros((m, n), dtype=np.int32)
    for m0 in range(0, m, tile_m):
        for n0 in range(0, n, tile_n):
            cover[m0:m0 + tile_m, n0:n0 + tile_n] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_split_divides_the_k_tiles_and_fills_the_card(shape, dtype, sms):
    m, n, k = shape
    variant, tile_m, tile_n, split = plan(m, n, k, dtype, sms)
    k_tiles = -(-k // _k_step(variant))
    assert 1 <= split <= MAX_SPLIT and k_tiles % split == 0
    assert split in _splits_allowed(k, variant)
    # Every K range holds whole k-tiles and none is empty.
    per = k_tiles // split
    assert per >= 1 and (split - 1) * per < k_tiles
    tiles = math.ceil(m / tile_m) * math.ceil(n / tile_n)
    target = math.ceil(FILL * sms)
    k_allows = tiles * _splits_allowed(k, variant)[-1]
    assert tiles * split >= min(target, k_allows)
    # The split is the smallest that reaches the target.
    smaller = [d for d in _splits_allowed(k, variant) if d < split]
    assert all(tiles * d < target for d in smaller)
    # K is split only where no tile's count reaches the target alone.
    if split > 1:
        assert all(math.ceil(m / tm) * math.ceil(n / tn) < target
                   for tm, tn in VARIANTS[variant][3])


def test_large_products_keep_the_largest_tile_and_no_split():
    assert plan(4096, 4096, 4096, BF16, 132) == ("wgmma", 128, 256, 1)
    assert plan(4096, 4096, 4096, F32, 132) == ("f32", 128, 128, 1)


def test_small_products_split_k():
    """Small outputs split a K that holds enough k-tiles: the suite's 256^3
    in f32 (8 k-tiles of 32), and 256 x 256 x 4096 in bf16.  At 256^3 bf16
    the 4 k-tiles of 64 are too few: the split's second pass would cost
    more than it spreads."""
    assert plan(256, 256, 256, F32, 132) == ("f32", 64, 64, 8)
    assert plan(256, 256, 4096, BF16, 132) == ("wgmma", 128, 64, 16)
    assert plan(256, 256, 256, BF16, 132) == ("wgmma", 128, 64, 1)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_a_tile_count_that_fills_the_card_is_not_split(dtype):
    """1024 x 1024 outputs: 128 tiles of 128 x 64 (bf16) or 64 x 128 (f32)
    reach 90% of 132 SMs, so K is not split, however deep."""
    for k in (256, 2048, 8192):
        assert plan(1024, 1024, k, dtype, 132)[1:] == (
            (128, 64, 1) if dtype == BF16 else (64, 128, 1))


def test_a_wgmma_split_keeps_four_k_tiles_per_range():
    for k in (256, 512, 1024, 2048, 4096):
        k_tiles = k // 64
        split = plan(128, 128, k, BF16, 132)[3]
        assert split == 1 or k_tiles // split >= 4


@pytest.mark.parametrize("shape", [(100, 72, 36), (96, 60, 100), (3, 7, 5), (17, 33, 65),
                                   (64, 64, 12), (64, 12, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_unaligned_bf16_takes_the_element_wise_variant(shape):
    assert plan(*shape, BF16, 132)[0] == "mma_elem"
    assert plan(*shape, BF16, 132, aligned=True)[0] == "mma_elem"


def test_misaligned_pointers_take_the_element_wise_variants():
    assert plan(256, 256, 256, BF16, 132, aligned=False)[0] == "mma_elem"
    assert plan(256, 256, 256, F32, 132, aligned=False)[0] == "f32_elem"


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_f32_never_gets_a_tensor_core_variant(shape):
    for aligned in (True, False):
        variant = plan(*shape, F32, 132, aligned=aligned)[0]
        assert variant in ("f32", "f32_elem")


def test_plan_is_a_pure_function():
    args = [(m, n, k, dt, sms) for m, n, k in SHAPES for dt in (F32, BF16) for sms in SMS]
    first = [plan(*a) for a in args]
    second = [plan(*a) for a in reversed(args)][::-1]
    assert first == second


def test_plan_refuses_other_dtypes():
    with pytest.raises(ValueError, match="float32"):
        plan(64, 64, 64, torch.float16, 132)


def test_card_cases_reach_every_planner_branch():
    """The matmul card checks (``card_checks.MATMUL_CASES``, which
    ``chip_smoke.py`` and the card tests run), on the H100's 132 SMs, take
    every variant, K split and unsplit in f32 and in wgmma, both wgmma tile
    widths, three f32 tiles and the persistent grid (more work items than
    SMs)."""
    seen = set()
    for m, k, n, *_ in CC.MATMUL_CASES:
        for dtype in (F32, BF16):
            variant, tile_m, tile_n, split = plan(m, n, k, dtype, 132)
            tiles = -(-m // tile_m) * -(-n // tile_n)
            seen |= {variant, f"{variant}-split={split > 1}", f"{variant}-{tile_m}x{tile_n}"}
            if variant == "wgmma" and tiles * split > 132:
                seen.add("persistent")
    assert {"f32", "f32_elem", "wgmma", "mma_elem", "f32-split=True", "f32-split=False",
            "wgmma-split=True", "wgmma-split=False", "persistent"} <= seen
    assert {"wgmma-128x64", "wgmma-128x256", "f32-64x64", "f32-64x128", "f32-128x128",
            "f32_elem-32x64"} <= seen

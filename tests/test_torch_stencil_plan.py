"""The stencil's launch plan (``kernels/stencil2d/kernel.py:plan_stencil``),
pure Python: the rows a thread walks, so that the grid covers the SMs.

The kernel computes every output the same way at any row tile (the card
tests hold every plan bit for bit against the planner's), so the plan only
trades the halo rows a strip reads again against the blocks the grid puts
on the card.
"""

import math

import pytest
import torch

from repro_torch.kernels.stencil2d import kernel as ST

SMS = (132, 114, 78, 16, 1)
SHAPES = ((256, 512), (8192, 8192), (64, 128), (257, 383), (1, 1), (4096, 256),
          (65535, 32), (300000, 4096))


def _blocks(h, w, rows):
    return math.prod(ST.stencil_grid(h, w, rows))


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("h,w", SHAPES)
def test_plan_is_the_most_rows_that_reach_the_sms(h, w, sms):
    rows = ST.plan_stencil(h, w, torch.float32, sms)
    assert rows in ST.ROW_TILES
    assert ST.stencil_grid(h, w, rows)[1] <= 65535
    if _blocks(h, w, rows) >= ST.FILL * sms:
        more = [r for r in ST.ROW_TILES if r > rows]
        assert all(_blocks(h, w, r) < ST.FILL * sms for r in more)
    else:
        # No tile reaches the SMs: the fewest rows, the most blocks.
        fits = [r for r in ST.ROW_TILES if ST.stencil_grid(h, w, r)[1] <= 65535]
        assert rows == fits[-1]


def test_the_suites_grid_now_covers_the_card():
    """At the Rodinia grid (256 x 512) 16 rows a thread made 32 blocks on
    132 SMs; the plan takes 4 rows and 128 blocks (2 rows, 256 blocks, ran
    no faster).  At 8192 x 8192 the 16-row tile stays."""
    assert ST.stencil_grid(256, 512, 16) == (2, 16, 1)
    assert ST.plan_stencil(256, 512, torch.float32, 132) == 4
    assert ST.stencil_grid(256, 512, 4) == (2, 64, 1)
    assert ST.plan_stencil(256, 512, torch.float32, 256) == 2
    assert ST.plan_stencil(8192, 8192, torch.float32, 132) == 16
    assert ST.plan_stencil(8192, 8192, torch.bfloat16, 132) == 16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_does_not_depend_on_the_dtype(dtype):
    for h, w in SHAPES:
        assert ST.plan_stencil(h, w, dtype, 132) == ST.plan_stencil(h, w, torch.float32, 132)


def test_plan_refuses_what_the_kernel_cannot_launch():
    with pytest.raises(ValueError):
        ST.plan_stencil(256, 512, torch.float16, 132)
    with pytest.raises(ValueError):
        ST.plan_stencil(0, 512, torch.float32, 132)
    with pytest.raises(ValueError):
        ST.plan_stencil(256, 512, torch.float32, 0)
    with pytest.raises(ValueError):
        ST.plan_stencil(16 * 65535 + 1, 32, torch.float32, 132)


def test_grid_is_the_sources():
    """A block: eight 32-column strips (256 columns) of ``rows`` rows."""
    assert (ST.STRIP_COLS, ST.THREADS) == (256, 256)
    for h, w in SHAPES[:6]:
        for rows in ST.ROW_TILES:
            gx, gy, gz = ST.stencil_grid(h, w, rows)
            assert gx * ST.STRIP_COLS >= w > (gx - 1) * ST.STRIP_COLS
            assert gy * rows >= h > (gy - 1) * rows and gz == 1


def test_launch_plan_checks_before_it_launches():
    """On the CPU ``launch_plan`` refuses CPU tensors and unknown tiles (it
    only ever launches the kernel); the wrapper takes the plain version."""
    x = torch.randn(16, 32)
    c = torch.tensor([0.6, 0.1, 0.1, 0.1, 0.1])
    with pytest.raises(ValueError, match="rows=3"):
        ST.launch_plan(x, c, rows=3)
    with pytest.raises(ValueError, match="CUDA"):
        ST.launch_plan(x, c, rows=2)
    assert torch.equal(ST.stencil2d_cuda(x, c), ST.stencil2d_ref(x, c, 0.0))

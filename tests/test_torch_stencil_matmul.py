"""The port's paper-demo kernels' plain versions (``stencil2d_ref``,
``matmul_ref``) and their ops against the reference, on the CPU.

Inputs come from numpy with a fixed seed and go through both packages; the
reference's Pallas kernels run in interpret mode, as its own tests run
them (``tests/test_kernel_shift_stencil_matmul.py``, whose
parametrizations these repeat).  Tolerances: the stencil is the same five
f32 products summed in the same order on both sides, held to 1e-6 (XLA may
contract a product and a sum into one fused multiply-add, which moves the
last bit); the f32 matmul is an f32 dot summed in another order, 1e-4
relative with K-scaled atol as the reference's test; bf16 outputs are
rounded to bf16 by both sides, so one bf16 ulp (2**-7 relative) plus the
f32 difference before the rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matmul_fwd.kernel import matmul_fwd_pallas
from repro.kernels.matmul_fwd.ops import tile_traffic as jax_tile_traffic
from repro.kernels.matmul_fwd.ref import matmul_ref as jax_matmul_ref
from repro.kernels.stencil2d.kernel import stencil2d_pallas
from repro.kernels.stencil2d.ref import stencil2d_ref as jax_stencil_ref
from repro_torch.kernels.matmul_fwd import kernel as MK
from repro_torch.kernels.matmul_fwd import ops as MO
from repro_torch.kernels.matmul_fwd.ref import matmul_ref
from repro_torch.kernels.stencil2d import kernel as SK
from repro_torch.kernels.stencil2d import ops as SO
from repro_torch.kernels.stencil2d.ref import stencil2d_ref

jax.config.update("jax_platform_name", "cpu")
# Tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

STENCIL_TOL = 1e-6
MATMUL_TOL = 1e-4


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _pair(arr, dtype):
    """The same numpy values as a torch tensor and a JAX array of ``dtype``."""
    t = torch.from_numpy(arr).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    j = jnp.asarray(arr).astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    return t, j


def _bf16_close(got, want, f32_tol):
    """|got - want| <= one bf16 ulp of |want| + the f32 tolerance."""
    g, w = _np(got), _np(want)
    ulp = np.ldexp(np.ones_like(w), np.frexp(w)[1] - 8)
    bad = np.abs(g - w) > ulp + f32_tol
    assert not bad.any(), f"{bad.sum()} elements beyond one bf16 ulp"


class TestStencil2d:
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    @pytest.mark.parametrize("h,w,block_h", [(128, 128, 32), (256, 384, 128), (64, 512, 64)])
    def test_plain_matches_reference_and_pallas(self, h, w, block_h, dtype):
        rng = np.random.default_rng(h + w)
        x, xj = _pair(rng.standard_normal((h, w)).astype(np.float32), dtype)
        c, cj = _pair(rng.standard_normal(5).astype(np.float32), "f32")
        got = stencil2d_ref(x, c)
        assert got.dtype == x.dtype and got.shape == (h, w)
        for want in (jax_stencil_ref(xj, cj),
                     stencil2d_pallas(xj, cj, block_h=block_h, interpret=True)):
            if dtype == "f32":
                np.testing.assert_allclose(_np(got), _np(want), rtol=STENCIL_TOL,
                                           atol=STENCIL_TOL)
            else:
                _bf16_close(got, want, STENCIL_TOL)

    @pytest.mark.parametrize("boundary", [5.0, -1.25])
    def test_boundary_constant(self, boundary):
        x = torch.ones(64, 128)
        c = torch.tensor([0.0, 1.0, 1.0, 1.0, 1.0])
        got = stencil2d_ref(x, c, boundary=boundary)
        want = stencil2d_pallas(jnp.ones((64, 128)), jnp.asarray(c.numpy()), block_h=32,
                                boundary=boundary, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        # Interior = 4 neighbours of 1.0; corner = 2 real + 2 boundary.
        assert got[5, 5] == pytest.approx(4.0)
        assert got[0, 0] == pytest.approx(2 + 2 * boundary)

    def test_hotspot_style_update(self):
        # One Jacobi step keeps a constant field constant (row-sum-1 coeffs).
        x = torch.full((128, 256), 3.0)
        c = torch.tensor([0.6, 0.1, 0.1, 0.1, 0.1])
        np.testing.assert_allclose(stencil2d_ref(x, c, boundary=3.0).numpy(),
                                   np.full((128, 256), 3.0), rtol=1e-6)

    @pytest.mark.parametrize("h,w", [(257, 383), (1, 7), (9, 1)])
    def test_any_shape_matches_reference(self, h, w):
        rng = np.random.default_rng(h * w)
        x = rng.standard_normal((h, w)).astype(np.float32)
        c = rng.standard_normal(5).astype(np.float32)
        got = SO.stencil2d(torch.from_numpy(x), torch.from_numpy(c), boundary=0.5)
        want = jax_stencil_ref(jnp.asarray(x), jnp.asarray(c), boundary=0.5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=STENCIL_TOL,
                                   atol=STENCIL_TOL)

    def test_ops_dispatch(self):
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal((48, 40)).astype(np.float32))
        c = [0.6, 0.1, 0.1, 0.1, 0.1]
        want = stencil2d_ref(x, torch.tensor(c), 1.5)
        launches = SK.stencil2d_cuda.launches
        # The op and the kernel wrapper on CPU tensors: the plain version,
        # bit for bit, and no launch.
        assert torch.equal(SO.stencil2d(x, c, boundary=1.5), want)
        assert torch.equal(SK.stencil2d_cuda(x, torch.tensor(c), boundary=1.5), want)
        assert torch.equal(SK.stencil2d_cuda(x, torch.tensor(c), block_h=16, boundary=1.5),
                           want)
        assert SK.stencil2d_cuda.launches == launches

    def test_block_h_checked_as_the_reference(self):
        x = torch.zeros(48, 8)
        with pytest.raises(ValueError, match="not divisible by block_h"):
            SK.stencil2d_cuda(x, torch.zeros(5), block_h=32)
        with pytest.raises(ValueError, match="not divisible"):
            stencil2d_pallas(jnp.zeros((48, 8)), jnp.zeros(5), block_h=32, interpret=True)
        with pytest.raises(ValueError, match="coeffs"):
            SK.stencil2d_cuda(x, torch.zeros(4), block_h=16)


class TestMatmulFwd:
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    @pytest.mark.parametrize("m,k,n,bm,bn,bk", [
        (128, 128, 128, 128, 128, 128),
        (256, 512, 128, 128, 128, 256),
        (512, 256, 384, 256, 128, 128),
    ])
    def test_plain_matches_reference_and_pallas(self, m, k, n, bm, bn, bk, dtype):
        rng = np.random.default_rng(m * n)
        a, aj = _pair(rng.standard_normal((m, k)).astype(np.float32), dtype)
        b, bj = _pair(rng.standard_normal((k, n)).astype(np.float32), dtype)
        got = MO.matmul_fwd(a, b, block_m=bm, block_n=bn, block_k=bk)
        assert got.dtype == a.dtype and got.shape == (m, n)
        assert torch.equal(got, matmul_ref(a, b))
        for want in (jax_matmul_ref(aj, bj),
                     matmul_fwd_pallas(aj, bj, block_m=bm, block_n=bn, block_k=bk,
                                       interpret=True)):
            if dtype == "f32":
                np.testing.assert_allclose(_np(got), _np(want), rtol=MATMUL_TOL,
                                           atol=MATMUL_TOL * k)
            else:
                _bf16_close(got, want, MATMUL_TOL * k)

    def test_mixed_dtypes_take_a_dtype(self):
        # The plain version takes mixed dtypes and returns a.dtype (the card
        # kernel refuses them).
        rng = np.random.default_rng(1)
        a = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32))
        got = matmul_ref(a.bfloat16(), b)
        want = jax_matmul_ref(jnp.asarray(a.numpy()).astype(jnp.bfloat16), jnp.asarray(b.numpy()))
        assert got.dtype == torch.bfloat16
        _bf16_close(got, want, 1e-5)

    def test_ops_dispatch(self):
        a, b = torch.ones(32, 16), torch.ones(16, 8)
        launches = MK.matmul_fwd_cuda.launches
        assert torch.equal(MO.matmul_fwd(a, b), torch.full((32, 8), 16.0))
        assert torch.equal(MK.matmul_fwd_cuda(a, b), torch.full((32, 8), 16.0))
        assert MK.matmul_fwd_cuda.launches == launches

    @pytest.mark.parametrize("shape_a,shape_b,blocks", [
        ((256, 384), (384, 256), (256, 256, 256)),   # K=384 not a multiple of 256
        ((300, 128), (128, 128), (256, 128, 128)),   # M=300 not of 256
        ((128, 64), (32, 128), (128, 128, 128)),     # inner dims
    ])
    def test_block_contract_raises_as_the_reference(self, shape_a, shape_b, blocks):
        bm, bn, bk = blocks
        a, b = torch.zeros(shape_a), torch.zeros(shape_b)
        with pytest.raises(ValueError) as port:
            MK.matmul_fwd_cuda(a, b, block_m=bm, block_n=bn, block_k=bk)
        with pytest.raises(ValueError) as ref:
            matmul_fwd_pallas(jnp.zeros(shape_a), jnp.zeros(shape_b), block_m=bm, block_n=bn,
                              block_k=bk, interpret=True)
        assert str(port.value) == str(ref.value)

    @pytest.mark.parametrize("m,k,n", [(100, 36, 72), (3, 5, 7)])
    def test_blocks_cut_to_the_dims(self, m, k, n):
        # min(block, dim) divides any dim, so small or odd shapes pass.
        rng = np.random.default_rng(m)
        a = rng.standard_normal((m, k)).astype(np.float32)
        b = rng.standard_normal((k, n)).astype(np.float32)
        got = MO.matmul_fwd(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_allclose(got.numpy(), a @ b, rtol=MATMUL_TOL, atol=MATMUL_TOL * k)

    @pytest.mark.parametrize("args", [
        (1024, 1024, 1024, 128, 128, 128),
        (1024, 1024, 1024, 512, 512, 128),
        (512, 384, 256, 256, 128, 128, 4),
    ])
    def test_tile_traffic_equals_reference(self, args):
        got, want = MO.tile_traffic(*args), jax_tile_traffic(*args)
        assert (got.dram_bytes, got.scratchpad_bytes, got.fabric_bytes, got.energy_pj()) == (
            want.dram_bytes, want.scratchpad_bytes, want.fabric_bytes, want.energy_pj())

    def test_traffic_reduction_law(self):
        # §3.3 at tile granularity: bigger tiles -> less HBM traffic.
        small = MO.tile_traffic(1024, 1024, 1024, 128, 128, 128)
        big = MO.tile_traffic(1024, 1024, 1024, 512, 512, 128)
        assert big.dram_bytes < small.dram_bytes < 2 * 1024**3 * 2 / 20

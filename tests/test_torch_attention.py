"""The port's attention against the reference's, on the CPU: the flash
kernel's plain versions against ``flash_attention_pallas`` in interpret
mode, in every variant it has, and the dense attention module (RoPE, the
ring insert, decode attention, the whole layer with and without a cache).

Inputs come from numpy with a fixed seed.  Tolerances, f32: the plain
versions compute the same masked softmax in another summation order than
the Pallas kernel's online softmax (errors measured below 1e-5 at outputs
of about 3), so 1e-4; the module, which adds projections and RoPE, is held
to the port's model tolerance, also 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.kernels.local_attention.kernel import flash_attention_pallas
from repro.kernels.local_attention.ref import attention_blockwise as jax_blockwise
from repro.model import attention as JA
from repro.model import layers as JL
from repro.model import model as JM
from repro_torch.configs.registry import get_config
from repro_torch.kernels.local_attention import kernel as FK
from repro_torch.kernels.local_attention import ops as FO
from repro_torch.kernels.local_attention import ref as FR
from repro_torch.model import attention as A
from repro_torch.model import convert
from repro_torch.model import layers as L
from repro_torch.model import sharding as S

jax.config.update("jax_platform_name", "cpu")
# Tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

TOL = 1e-4


def _np(x):
    return np.asarray(x, np.float32)


def _qkv(b, hq, hkv, t, s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, hq, t, d), (b, hkv, s, d), (b, hkv, s, d))]


# (b, hq, hkv, t, s, causal, window): the variants of flash_attention_pallas,
# as tests/test_kernel_attention.py sweeps them, with T <= 384.
VARIANTS = {
    "causal-128": (1, 2, 2, 128, 128, True, None),
    "causal-256": (1, 2, 2, 256, 256, True, None),
    "causal-384": (1, 2, 2, 384, 384, True, None),
    "gqa-4-2": (2, 4, 2, 256, 256, True, None),
    "gqa-8-1": (1, 8, 1, 256, 256, True, None),
    "window-128": (1, 2, 1, 384, 384, True, 128),
    "window-past-T": (1, 2, 2, 256, 256, True, 4096),
    "non-causal": (2, 4, 4, 128, 384, False, None),
    "non-causal-window": (1, 2, 1, 300, 300, False, 100),
    "unpadded": (1, 2, 2, 200, 200, True, None),
    "decode": (2, 4, 2, 1, 300, True, None),
    "windowed-decode": (1, 2, 1, 8, 300, True, 128),
}


@pytest.mark.parametrize("d", [32, 256])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_plain_matches_pallas(name, d):
    b, hq, hkv, t, s, causal, window = VARIANTS[name]
    q, k, v = _qkv(b, hq, hkv, t, s, d, t + s + d)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=causal, window=window, interpret=True)
    # On CPU tensors the kernel's wrapper runs its plain version.
    got = FK.flash_attention_cuda(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t,window", [(300, None), (513, None), (700, 256), (1024, 128)])
def test_blockwise_matches_reference_blockwise(t, window):
    q, k, v = _qkv(1, 4, 2, t, t, 32, t)
    want = jax_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                         window=window, block=128)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = FR.attention_blockwise(tq, tk, tv, causal=True, window=window, block=128)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)
    exact = FR.attention_ref(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=TOL, atol=TOL)


def test_ops_dispatch_goes_blockwise_past_1024(monkeypatch):
    calls = []
    monkeypatch.setattr(FO, "flash_attention_cuda",
                        lambda *a, **kw: calls.append("cuda"))
    monkeypatch.setattr(FO, "attention_blockwise",
                        lambda *a, **kw: calls.append("blockwise") or FR.attention_blockwise(*a, **kw))
    monkeypatch.setattr(FO, "attention_ref",
                        lambda *a, **kw: calls.append("ref") or FR.attention_ref(*a, **kw))
    for t in (64, 1025):
        q, k, v = map(torch.from_numpy, _qkv(1, 1, 1, t, t, 32, t))
        FO.flash_attention(q, k, v, causal=True, window=32)
    assert calls == ["ref", "blockwise"]


# ---------------------------------------------------------------------------
# The attention module
# ---------------------------------------------------------------------------

def test_rope_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 9, 32)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 9)).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
    # M-RoPE (qwen2-vl's sections of the reduced config), 2-D positions
    # broadcast to its three streams.
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0, (8, 4, 4))
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0, (8, 4, 4))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t", [1, 5, 16])
def test_masked_insert_matches_reference(t):
    rng = np.random.default_rng(t)
    cache = rng.standard_normal((3, 2, 16, 8)).astype(np.float32)
    new = rng.standard_normal((3, 2, t, 8)).astype(np.float32)
    length = np.array([0, 13, 30], np.int32)            # the last one wraps the ring
    mask = np.ones((3, t), bool)
    mask[1, t // 2:] = False
    for m in (None, mask):
        want = JA._masked_insert(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(length),
                                 None if m is None else jnp.asarray(m))
        got = A._masked_insert(torch.from_numpy(cache), torch.from_numpy(new),
                               torch.from_numpy(length), None if m is None else torch.from_numpy(m))
        assert np.array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="exceeds cache size"):
        A._masked_insert(torch.from_numpy(cache), torch.zeros(3, 2, 17, 8), torch.zeros(3))


@pytest.mark.parametrize("window", [None, 6])
def test_decode_attention_matches_reference(window):
    cfg_j = jax_config("recurrentgemma-2b").reduced()
    cfg = get_config("recurrentgemma-2b").reduced()
    rng = np.random.default_rng(3)
    q = rng.standard_normal((3, 4, 4, 32)).astype(np.float32)
    kc, vc = (rng.standard_normal((3, 1, 12, 32)).astype(np.float32) for _ in range(2))
    pos = np.array([0, 7, 20], np.int32)
    want = JA._decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                jnp.asarray(pos), cfg_j, window=window)
    parts = A._decode_partials(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
                               torch.from_numpy(pos), cfg, window=window)
    got = S.combine_partials(*parts, ())
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def layer():
    cfg_j = jax_config("recurrentgemma-2b").reduced()
    cfg = get_config("recurrentgemma-2b").reduced()
    pj = JM.init_params(cfg_j, jax.random.key(0))["decoder"]["scanned"][2]["attn"]
    pj = jax.tree.map(lambda a: a[1], pj)                       # period 1's local layer
    return cfg_j, cfg, pj, convert.params_from_jax(jax.tree.map(np.asarray, pj))


@pytest.mark.parametrize("kind,t", [("local", 100), ("global", 40)])
def test_layer_without_cache_matches_reference(layer, kind, t):
    cfg_j, cfg, pj, pt = layer
    x = np.random.default_rng(t).standard_normal((2, t, cfg.d_model)).astype(np.float32)
    want, _ = JA.apply_attention(pj, jnp.asarray(x), cfg_j, kind=kind)
    got, cache = A.apply_attention(pt, torch.from_numpy(x), cfg, kind=kind)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)


def test_layer_with_ring_cache_matches_reference(layer):
    """Three masked windows into a local ring of window + 8 - 1 slots, so
    the ring wraps; outputs and caches against the reference's."""
    cfg_j, cfg, pj, pt = layer
    b, kw, s = 3, 8, cfg.attn_window + 8 - 1
    rng = np.random.default_rng(9)
    cj = JA.KVCache(jnp.zeros((b, 1, s, 32)), jnp.zeros((b, 1, s, 32)),
                    jnp.zeros((b,), jnp.int32))
    ct = A.KVCache(torch.zeros(b, 1, s, 32), torch.zeros(b, 1, s, 32),
                   torch.zeros(b, dtype=torch.int32))
    length = np.zeros(b, np.int32)
    for i in range(10):
        x = rng.standard_normal((b, kw, cfg.d_model)).astype(np.float32)
        mask = np.ones((b, kw), bool)
        mask[1, 5:] = i % 2 == 0
        mask[2] = i != 3
        pos = length[:, None] + np.arange(kw)[None]
        want, cj = JA.apply_attention(pj, jnp.asarray(x), cfg_j, kind="local",
                                      positions=jnp.asarray(pos), kv_cache=cj,
                                      token_mask=jnp.asarray(mask))
        got, ct = A.apply_attention(pt, torch.from_numpy(x), cfg, kind="local",
                                    positions=torch.from_numpy(pos), kv_cache=ct,
                                    token_mask=torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)
        for a, w in zip(ct, cj):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=TOL, atol=TOL)
        length += mask.sum(1).astype(np.int32)
    assert int(length.max()) > s


def test_unported_attention_paths_raise(layer):
    """Cross-attention, once refused, is ported: the layer's params over a
    memory of another length (T = 4 against S = 7, no RoPE, non-causal)
    match the reference, no cache comes back, and ``init_attention(cross=
    True)`` builds the self-attention's keys and shapes."""
    from repro_torch.model import model as M

    cfg_j, cfg, pj, pt = layer
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 4, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    want, _ = JA.apply_attention(pj, jnp.asarray(x), cfg_j, x_kv=jnp.asarray(mem))
    got, cache = A.apply_attention(pt, torch.from_numpy(x), cfg, x_kv=torch.from_numpy(mem))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)
    mk = M.init_mk(torch.Generator().manual_seed(0), torch.float32, torch.device("cpu"))
    cross = A.init_attention(mk, cfg, "x", cross=True)
    assert {k: tuple(v.shape) for k, v in cross.items()} == {
        k: tuple(v.shape) for k, v in pt.items()}

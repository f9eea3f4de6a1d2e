"""Paged KV serving in the port, on the CPU: a counterpart of every test of
tests/test_serve_paged.py (paged against dense, greedy and sampled;
quarantine on the paged engine; recurrent-state prefix sharing against
cold admission; prefix validation; a starved pool and a request no pool
can hold; preemption and restore; the controller's invariants; the cost
model), on the reduced configs with the reference's parameters converted.

Beyond the reference's own checks, the port is held to the reference: its
greedy paged streams and serve counters equal the reference's paged run,
and its controller decisions, gathered views, inserted rows, checksums
and cost-model values equal the reference's.  Sampled streams use the
port's own draw, so they are held port against port.

The reference's masked K/V writes land on its pool's last row (JAX
normalises the -1 it scatters with before it drops anything), so pools
are compared only through mapped rows and gathered views, and
``TestLastPage`` shows that the port's pool keeps that row for real data.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.core import cost_model as JCM
from repro.model import attention as JA
from repro.model import model as JM
from repro.serve import engine as JE
from repro.serve import paging as JP
from repro_torch.configs.registry import get_config
from repro_torch.core import cost_model as CM
from repro_torch.model import attention as A
from repro_torch.model import convert
from repro_torch.model import model as M
from repro_torch.serve import paging as P
from repro_torch.serve.chaos import ChaosInjector, EnginePreempted, bitflip_slot_state
from repro_torch.serve.chaos import poison_slot_state
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.tree import tree_leaves

jax.config.update("jax_platform_name", "cpu")
# Tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["rwkv6-1.6b", "gemma3-1b", "recurrentgemma-2b"]
SPEC = [(5, 9), (12, 3), (7, 14), (3, 6), (9, 11)]
SUFFIXES = (5, 9, 3, 7)
_SETUPS = {}


def _setup(arch):
    """(reference config, port config, reference params, port params),
    built once per arch and worker."""
    if arch not in _SETUPS:
        cfg_j = jax_config(arch).reduced()
        pj = JM.init_params(cfg_j, jax.random.key(0))
        _SETUPS[arch] = (cfg_j, get_config(arch).reduced(), pj,
                         convert.params_from_jax(jax.tree.map(np.asarray, pj)))
    return _SETUPS[arch]


def _requests(vocab, spec=SPEC, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(tokens=rng.integers(0, vocab, (pl,)).astype(np.int32), max_new_tokens=nn)
            for pl, nn in spec]


def _prefix_workload(vocab):
    """A 40-token prefix (one 32-token page shared) and four requests
    extending it, as the reference's prefix test draws them."""
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, vocab, (40,)).astype(np.int32)
    sfx = [rng.integers(0, vocab, (k,)).astype(np.int32) for k in SUFFIXES]
    return prefix, [np.concatenate([prefix, s]) for s in sfx]


def _engines(arch, **paged_kw):
    _, cfg, _, pt = _setup(arch)
    dense = ServeEngine(cfg, pt, max_len=96, decode_window=4, device="cpu")
    paged = ServeEngine(cfg, pt, max_len=96, decode_window=4, device="cpu", paged=True,
                        **paged_kw)
    return dense, paged


def _assert_streams_equal(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.outcome == y.outcome, (i, x.outcome, y.outcome)
        np.testing.assert_array_equal(np.asarray(x.tokens), np.asarray(y.tokens),
                                      err_msg=f"req {i}")


def _no_stragglers(stats):
    """Every counter but the straggler flags, which read the host clock."""
    return {k: v for k, v in stats.items() if k != "stragglers"}


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's greedy paged serves, run once per arch: SPEC on two
    slots, and the prefix workload warm through a registered prefix.
    {arch: {"parity": (outs, stats, paged stats), "warm": (...)}}."""
    runs = {}
    for arch in ARCHS:
        cfg_j, _, pj, _ = _setup(arch)
        eng = JE.ServeEngine(cfg_j, pj, max_len=96, decode_window=4, paged=True)
        reqs = [JE.Request(tokens=r.tokens, max_new_tokens=r.max_new_tokens)
                for r in _requests(cfg_j.vocab_size)]
        outs = eng.serve(reqs, slots=2)
        parity = (outs, dict(eng.last_serve_stats), dict(eng.last_paged_stats))
        prefix, prompts = _prefix_workload(cfg_j.vocab_size)
        pid = eng.register_prefix(prefix)
        outs = eng.serve([JE.Request(tokens=p, max_new_tokens=8, prefix_id=pid)
                          for p in prompts], slots=2)
        runs[arch] = {"parity": parity,
                      "warm": (outs, dict(eng.last_serve_stats), dict(eng.last_paged_stats))}
    return runs


class TestPagedParity:
    """Pooled pages and page-table gathers are an exact storage-layout
    change: every stream equals the dense engine's, greedy and sampled,
    on all three arch families, and the greedy run is the reference's."""

    @pytest.mark.parametrize("arch", ARCHS)
    def test_greedy_bit_identical_to_dense(self, arch, reference_runs):
        reqs = _requests(_setup(arch)[1].vocab_size)
        dense, paged = _engines(arch)
        outs = paged.serve(reqs, slots=2)
        _assert_streams_equal(dense.serve(reqs, slots=2), outs)
        assert paged.last_serve_stats["admissions"] >= 2   # slots recycled
        assert paged.last_paged_stats["page_table_violations"] == 0
        ref, ref_stats, ref_paged = reference_runs[arch]["parity"]
        _assert_streams_equal(ref, outs)
        assert _no_stragglers(paged.last_serve_stats) == _no_stragglers(ref_stats)
        assert paged.last_paged_stats == ref_paged

    @pytest.mark.parametrize("arch", ARCHS)
    def test_sampled_bit_identical_to_dense(self, arch):
        reqs = _requests(_setup(arch)[1].vocab_size)
        dense, paged = _engines(arch)
        kw = dict(slots=2, temperature=0.8, top_k=5, seed=3)
        _assert_streams_equal(dense.serve(reqs, **kw), paged.serve(reqs, **kw))

    @pytest.mark.parametrize("arch", ["rwkv6-1.6b", "gemma3-1b"])
    def test_quarantine_recovery_parity(self, arch):
        """A NaN-poisoned slot (recurrent state on rwkv6; a K row of a page
        the slot owns on gemma3) quarantines and recovers on the paged
        engine: the victim's resumed stream and every neighbour equal the
        fault-free run."""
        reqs = _requests(_setup(arch)[1].vocab_size)
        _, paged = _engines(arch)
        base = paged.serve(reqs, slots=2, seed=0)
        outs = paged.serve(reqs, slots=2, seed=0, chaos=ChaosInjector(seed=1, nan_at=(1,)))
        assert paged.last_serve_stats["quarantines"] >= 1
        assert any(r.outcome == "recovered" for r in outs)
        for b, o in zip(base, outs):
            np.testing.assert_array_equal(b.tokens, o.tokens)
        assert paged.last_paged_stats["page_table_violations"] == 0


class TestPrefixSharing:
    """A registered prefix's recurrent state and KV pages enter each
    admitted slot (the read-side dual of the reset): streams equal cold
    admission's, and the reference's warm run."""

    @pytest.mark.parametrize("arch", ARCHS)
    def test_shared_prefix_matches_cold(self, arch, reference_runs):
        prefix, prompts = _prefix_workload(_setup(arch)[1].vocab_size)
        cold = [Request(tokens=p, max_new_tokens=8) for p in prompts]
        dense, paged = _engines(arch)
        pid = paged.register_prefix(prefix)
        warm = [Request(tokens=p, max_new_tokens=8, prefix_id=pid) for p in prompts]
        outs = paged.serve(warm, slots=2)
        _assert_streams_equal(dense.serve(cold, slots=2), outs)
        assert paged.last_serve_stats["prefix_admissions"] == len(SUFFIXES)
        assert paged.last_paged_stats["shared_pages"] >= 1
        assert paged.last_paged_stats["page_table_violations"] == 0
        ref, ref_stats, ref_paged = reference_runs[arch]["warm"]
        _assert_streams_equal(ref, outs)
        assert _no_stragglers(paged.last_serve_stats) == _no_stragglers(ref_stats)
        assert paged.last_paged_stats == ref_paged

    @pytest.mark.parametrize("arch", ["gemma3-1b", "recurrentgemma-2b"])
    def test_copied_ring_prefix_matches_cold(self, arch):
        """At max_len 128 the local rings (window 64 plus a 64-token insert
        window) stop one slot short of max_len and wrap, so the prefix's
        ring content is copied into each slot's private pages (the "copy"
        role) instead of shared: streams still equal cold admission's."""
        _, cfg, _, pt = _setup(arch)
        prefix, prompts = _prefix_workload(cfg.vocab_size)
        kw = dict(max_len=128, decode_window=4, device="cpu")
        paged = ServeEngine(cfg, pt, paged=True, **kw)
        pid = paged.register_prefix(prefix)
        outs = paged.serve([Request(tokens=p, max_new_tokens=8, prefix_id=pid)
                            for p in prompts], slots=2)
        assert any(isinstance(n, A.PagedKVCache) and n.s_view < 128
                   for n in M.state_nodes(paged.last_state))
        assert paged.last_serve_stats["prefix_admissions"] == len(SUFFIXES)
        assert paged.last_paged_stats["page_table_violations"] == 0
        cold = ServeEngine(cfg, pt, **kw).serve(
            [Request(tokens=p, max_new_tokens=8) for p in prompts], slots=2)
        _assert_streams_equal(cold, outs)

    def test_prefix_validation(self):
        dense, paged = _engines("gemma3-1b")
        with pytest.raises(ValueError, match="paged"):
            dense.register_prefix(np.arange(40, dtype=np.int32))
        with pytest.raises(ValueError, match="page"):
            paged.register_prefix(np.arange(8, dtype=np.int32))      # < 1 page
        with pytest.raises(ValueError, match="no room"):
            paged.register_prefix(np.arange(96, dtype=np.int32))
        pid = paged.register_prefix(np.arange(40, dtype=np.int32))
        with pytest.raises(ValueError, match="extend"):
            paged.serve([Request(tokens=np.zeros(50, np.int32), max_new_tokens=4,
                                 prefix_id=pid)])
        with pytest.raises(ValueError, match="unknown prefix"):
            paged.serve([Request(tokens=np.arange(50, dtype=np.int32), max_new_tokens=4,
                                 prefix_id=99)])
        with pytest.raises(ValueError, match="paged engine"):
            dense.serve([Request(tokens=np.arange(50, dtype=np.int32), max_new_tokens=4,
                                 prefix_id=pid)])

    def test_engine_validation(self):
        _, cfg, _, pt = _setup("gemma3-1b")
        for ps in (16, 48):
            with pytest.raises(ValueError, match="multiple of the 32-token"):
                ServeEngine(cfg, pt, device="cpu", paged=True, page_size=ps)
        from repro_torch.launch.mesh import make_seq_mesh

        with pytest.raises(NotImplementedError, match="mesh"):
            ServeEngine(cfg, pt, device="cpu", paged=True, mesh=make_seq_mesh(2, device="cpu"))

    def test_prompt_equal_to_prefix_admits_cold(self):
        """A prompt that is exactly the page-aligned prefix leaves no suffix
        token to prefill from: it is admitted cold, as in the reference."""
        prefix, _ = _prefix_workload(_setup("rwkv6-1.6b")[1].vocab_size)
        dense, paged = _engines("rwkv6-1.6b")
        pid = paged.register_prefix(prefix[:32])
        outs = paged.serve([Request(tokens=prefix[:32], max_new_tokens=6, prefix_id=pid),
                            Request(tokens=prefix, max_new_tokens=6, prefix_id=pid)], slots=2)
        assert paged.last_serve_stats["prefix_admissions"] == 1
        _assert_streams_equal(dense.serve([Request(tokens=prefix[:32], max_new_tokens=6),
                                           Request(tokens=prefix, max_new_tokens=6)],
                                          slots=2), outs)


class TestPoolPressure:
    """Tight pools: admission waits for freed pages (head of line, no
    reordering), and a request no pool can hold is shed, not deadlocked;
    streams still equal the dense engine's."""

    def test_starved_pool_recycles_and_stays_exact(self):
        reqs = _requests(_setup("gemma3-1b")[1].vocab_size)
        dense, paged = _engines("gemma3-1b", pool_pages=1)
        _assert_streams_equal(dense.serve(reqs, slots=2), paged.serve(reqs, slots=2))
        assert paged.last_serve_stats["page_waits"] >= 1

    def test_impossible_request_is_shed(self):
        vocab = _setup("gemma3-1b")[1].vocab_size
        rng = np.random.default_rng(0)
        _, paged = _engines("gemma3-1b", pool_pages=1)
        big = Request(tokens=rng.integers(0, vocab, (40,)).astype(np.int32),
                      max_new_tokens=40)                              # needs 3 pages
        small = Request(tokens=rng.integers(0, vocab, (5,)).astype(np.int32),
                        max_new_tokens=6)
        outs = paged.serve([big, small], slots=2)
        assert outs[0].outcome == "shed" and outs[0].size == 0
        assert outs[1].outcome in ("ok", "eos")
        assert paged.last_serve_stats["shed"] == 1


class TestLastPage:
    """The pool's last row carries real data.  Four requests on two slots
    and four private pages per node: the first takes pages 1-3, the second
    page 4; freeing them in that order leaves page 4 at the head of the
    free list, so the fourth request maps page 4 as its FIRST logical page
    and writes position 31 to the pool's last row (page 4, offset 31),
    which its later queries read while the other slot's masked windows
    run.  The reference's masked writes land on that row; the port's must
    not: the row still holds that request's K/V (the dense engine's, bit
    for bit) at the end, and the streams equal the dense engine's."""

    def test_last_page_holds_live_data(self):
        vocab = _setup("gemma3-1b")[1].vocab_size
        reqs = _requests(vocab, spec=[(60, 10), (5, 20), (30, 20), (40, 15)], seed=5)
        dense, paged = _engines("gemma3-1b", pool_pages=4)
        _assert_streams_equal(dense.serve(reqs, slots=2), paged.serve(reqs, slots=2))
        assert paged.last_paged_stats["page_table_violations"] == 0
        for d, node in zip(M.state_nodes(dense.last_state), M.state_nodes(paged.last_state)):
            last = node.k.shape[1] - 1
            assert last == 4
            # Slot 1 last held the fourth request: its row still maps it, and
            # the pool's last row still holds that request's K/V at position
            # 31, which the other slot's masked windows ran after.
            assert node.page_table[0, 1].tolist() == [last, 3, -1]
            assert torch.equal(node.k[:, last, 31], d.k[:, 1, :, 31])
            assert torch.equal(node.v[:, last, 31], d.v[:, 1, :, 31])


def _ctl(private=8, shared_map=None, *, reference=False):
    """A controller over a paged gemma3 state (2 slots, max_len 96): the
    port's from a real state, or the reference's from its abstract one."""
    spec_kw = dict(page_size=32, private_pages=private,
                   shared_pages=sum(n for _, n in (shared_map or {}).values()))
    if reference:
        state = JM.abstract_decode_state(jax_config("gemma3-1b").reduced(), batch=2,
                                         max_len=96, insert_window=32,
                                         paged=JM.PageSpec(**spec_kw))
        return JP.PagedController(None, state, batch=2, max_len=96, shared_map=shared_map)
    state = M.init_decode_state(get_config("gemma3-1b").reduced(), 2, 96, 32,
                                M.PageSpec(**spec_kw), device="cpu")
    return P.PagedController(None, state, batch=2, max_len=96, shared_map=shared_map)


class TestPagedController:
    """Host allocator invariants, and the reference's decisions."""

    def test_alloc_free_roundtrip_and_rollback(self):
        ctl = _ctl(private=2)
        assert ctl.try_admit(0, 64, None, 0) is not None   # 2 pages on 96-view nodes
        free_before = [len(f) for f in ctl.free]
        assert ctl.try_admit(1, 96, None, 0) is None         # needs 3, has 0
        assert [len(f) for f in ctl.free] == free_before     # rollback
        ctl.free_slot(0)
        assert ctl.try_admit(1, 64, None, 0) is not None
        for owner in ctl.owners:
            assert not (owner == 0).any()                    # slot 0 owns nothing

    def test_table_rows_and_scrub_exclude_shared(self):
        ctl = _ctl(private=8, shared_map={7: (1, 1)})
        tables, scrubs = ctl.try_admit(0, 96, 7, 32)
        for g, row, scrub in zip(ctl.geoms, tables, scrubs):
            assert row.shape == (g.nl,)
            mapped = row[row >= 0]
            assert len(set(mapped.tolist())) == len(mapped)   # no page twice
            if g.role == "share":
                assert row[0] == 1 and scrub[0] == -1         # shared: not scrubbed
            assert (scrub[1:] == row[1:]).all()

    def test_peak_tracks_high_water(self):
        ctl = _ctl(private=8)
        base = ctl.peak_mapped_bytes
        ctl.try_admit(0, 96, None, 0)
        ctl.try_admit(1, 96, None, 0)
        high = ctl.peak_mapped_bytes
        assert high > base
        ctl.free_slot(0)
        ctl.free_slot(1)
        assert ctl.peak_mapped_bytes == high                  # high-water, not current
        assert ctl.mapped_bytes() < high

    @pytest.mark.parametrize("private", [3, 8])
    def test_decisions_equal_reference(self, private):
        """The same sequence of admissions and frees: the same tables,
        scrubs and waits (None), owner arrays, byte counts and capacity
        verdicts as the reference's controller."""
        shared = {4: (1, 1), 9: (2, 2)}
        port, ref = _ctl(private, shared), _ctl(private, shared, reference=True)
        assert [dataclass_tuple(g) for g in port.geoms] == [
            dataclass_tuple(g) for g in ref.geoms]
        ops = [("admit", 0, 70, 4, 32), ("admit", 1, 96, 9, 64), ("free", 0),
               ("admit", 0, 33, None, 0), ("admit", 1, 20, None, 0), ("free", 1),
               ("admit", 1, 96, 9, 64), ("free", 0), ("admit", 0, 50, 4, 32),
               ("free", 1), ("free", 0), ("admit", 1, 65, None, 0)]
        for op in ops:
            if op[0] == "free":
                port.free_slot(op[1])
                ref.free_slot(op[1])
            else:
                got, want = port.try_admit(*op[1:]), ref.try_admit(*op[1:])
                assert (got is None) == (want is None), op
                if got is not None:
                    for a, b in zip(got[0] + got[1], want[0] + want[1]):
                        np.testing.assert_array_equal(a, b)
            for a, b in zip(port.owners, ref.owners):
                np.testing.assert_array_equal(a, b)
            assert port.free == ref.free
            assert port.mapped_bytes() == ref.mapped_bytes()
            assert port.peak_mapped_bytes == ref.peak_mapped_bytes
        for total, start in ((96, 0), (96, 64), (200, 0), (40, 32)):
            assert port.fits_capacity(total, start) == ref.fits_capacity(total, start)
        assert (port.pool_bytes(), port.dense_bytes()) == (ref.pool_bytes(), ref.dense_bytes())
        assert port.roles == ref.roles


def dataclass_tuple(g):
    return (g.layers, g.s_view, g.page_size, g.nl, g.pool_pages, g.role, g.page_bytes)


class TestPagedSnapshotRestore:
    """Preempt a paged serve mid-run, restore, finish bit-identically:
    page tables, pool contents and owner bookkeeping all survive."""

    @pytest.mark.parametrize("arch", ["gemma3-1b", "rwkv6-1.6b"])
    def test_preempt_restore_bit_identical(self, arch, tmp_path):
        reqs = _requests(_setup(arch)[1].vocab_size)
        _, paged = _engines(arch)
        kw = dict(slots=3, seed=0, temperature=0.8, top_k=5)
        base = paged.serve(reqs, **kw)
        _, eng = _engines(arch)
        with pytest.raises(EnginePreempted):
            eng.serve(reqs, **kw, snapshot_every=1, snapshot_dir=str(tmp_path),
                      chaos=ChaosInjector(seed=1, preempt_after=2))
        assert eng.last_serve_stats["snapshots"] >= 1
        outs = eng.serve(reqs, **kw, restore_from=str(tmp_path))
        _assert_streams_equal(base, outs)
        assert eng.last_paged_stats["page_table_violations"] == 0

    def test_restore_rejects_paging_mismatch(self, tmp_path):
        reqs = _requests(_setup("gemma3-1b")[1].vocab_size)
        dense, eng = _engines("gemma3-1b")
        with pytest.raises(EnginePreempted):
            eng.serve(reqs, slots=3, seed=0, snapshot_every=1, snapshot_dir=str(tmp_path),
                      chaos=ChaosInjector(preempt_after=1))
        with pytest.raises(ValueError, match="snapshot meta"):
            dense.serve(reqs, slots=3, seed=0, restore_from=str(tmp_path))
        _, other = _engines("gemma3-1b", pool_pages=5)
        with pytest.raises(ValueError, match="paging config"):
            other.serve(reqs, slots=3, seed=0, restore_from=str(tmp_path))


# --------------------------------------------------------------------------
# The model layer against the reference: gather, insert, checksum, chaos
# --------------------------------------------------------------------------


def _random_paged(rng, b=3, nl=3, pool=12, ps=32, hkv=1, dh=8, s_view=95):
    """A random paged node (pool values, a table with -1 entries and
    distinct pages that never include the null page or the last page,
    lengths), as numpy, and the same as the port's node."""
    k = rng.standard_normal((pool, ps, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((pool, ps, hkv, dh)).astype(np.float32)
    k[A.NULL_PAGE] = v[A.NULL_PAGE] = 0
    pages = rng.permutation(np.arange(1, pool - 1))[:b * nl].reshape(b, nl).astype(np.int32)
    pages[rng.random((b, nl)) < 0.3] = -1
    length = rng.integers(0, s_view, (b,)).astype(np.int32)
    port = A.PagedKVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()),
                          torch.from_numpy(pages.copy()), torch.from_numpy(length.copy()),
                          s_view, ps)
    return (k, v, pages, length), port


def _ref_node(arrs, s_view, ps):
    k, v, pages, length = arrs
    return JA.PagedKVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pages),
                           jnp.asarray(length), s_view, ps)


class TestPagedAttentionLayer:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_gather_equals_reference(self, seed):
        arrs, node = _random_paged(np.random.default_rng(seed))
        ref = _ref_node(arrs, node.s_view, node.page_size)
        for pool, rpool in ((node.k, ref.k), (node.v, ref.v)):
            np.testing.assert_array_equal(A._paged_gather(node, pool).numpy(),
                                          np.asarray(JA._paged_gather(ref, rpool)))

    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("t", [1, 5, 32])
    def test_insert_mapped_rows_equal_reference(self, seed, t):
        """Random tables with unmapped entries and random token masks: every
        mapped row after the insert equals the reference's; unmapped pages
        and the null page are untouched; the real targets are unique."""
        rng = np.random.default_rng(seed)
        arrs, node = _random_paged(rng)
        b, hkv, dh = node.page_table.shape[0], node.k.shape[-2], node.k.shape[-1]
        kn = rng.standard_normal((b, hkv, t, dh)).astype(np.float32)
        vn = rng.standard_normal((b, hkv, t, dh)).astype(np.float32)
        mask = rng.random((b, t)) < 0.7
        before_k = node.k.clone()
        flat, ok = A._paged_targets(node, t, torch.from_numpy(mask))
        real = flat[ok]
        assert real.unique().numel() == real.numel()
        A._paged_insert(node, torch.from_numpy(kn), torch.from_numpy(vn),
                        torch.from_numpy(mask))
        rk, rv = JA._paged_insert(_ref_node(arrs, node.s_view, node.page_size),
                                  jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(mask))
        mapped = np.unique(arrs[2][arrs[2] >= 0])
        np.testing.assert_array_equal(node.k.numpy()[mapped], np.asarray(rk)[mapped])
        np.testing.assert_array_equal(node.v.numpy()[mapped], np.asarray(rv)[mapped])
        unmapped = np.setdiff1d(np.arange(node.k.shape[0]), mapped)
        assert torch.equal(node.k[unmapped], before_k[unmapped])
        assert not node.k[A.NULL_PAGE].any() and not node.v[A.NULL_PAGE].any()

    def test_stacked_decode_step_updates_pool_in_place(self):
        """One decode step through a paged state: the pools are the same
        tensors before and after (written in place, never copied back)."""
        _, cfg, _, pt = _setup("gemma3-1b")
        st = M.init_decode_state(cfg, 2, 96, 4, M.PageSpec(), device="cpu")
        node = M.state_nodes(st)[0]
        ptr = node.k.data_ptr()
        node.page_table[:, :, 0] = torch.tensor([1, 2], dtype=torch.int32)
        toks = torch.tensor([[3, 4], [5, 6]])
        M.decode_step(pt, cfg, st, toks, torch.zeros(2, dtype=torch.int64))
        node = M.state_nodes(st)[0]
        assert node.k.data_ptr() == ptr
        assert node.length.tolist() == [[2, 2]] * node.length.shape[0]
        assert node.k[:, 1:3, :2].abs().sum() > 0 and not node.k[:, 3:].any()


def _random_paged_state(arch, dtype, seed, batch=3):
    """A reference paged decode state with random contents (tables with -1
    entries and shared pages mapped in several rows), as the reference's
    tree and as the port's state converted from it."""
    import dataclasses

    cfg_j = dataclasses.replace(jax_config(arch).reduced(), dtype=dtype)
    spec = JM.PageSpec(page_size=32, private_pages=None, shared_pages=2)
    st = JM.init_decode_state(cfg_j, batch, 96, 32, paged=spec)
    rng = np.random.default_rng(seed)

    def rand(leaf):
        return jnp.asarray(rng.standard_normal(leaf.shape), leaf.dtype)

    def fill(node):
        if isinstance(node, JA.PagedKVCache):
            # One table for every stacked layer, pages anywhere in the pool
            # (the null page and shared pages included, some in two rows).
            tbl = rng.integers(-1, node.k.shape[-4], node.page_table.shape[-2:])
            return JA.PagedKVCache(
                rand(node.k), rand(node.v),
                jnp.asarray(np.broadcast_to(tbl, node.page_table.shape).astype(np.int32)),
                jnp.asarray(rng.integers(0, 64, node.length.shape).astype(np.int32)),
                node.s_view, node.page_size)
        return type(node)(*(rand(leaf) for leaf in node))

    st_j = jax.tree.map(fill, st, is_leaf=lambda x: isinstance(
        x, (JA.PagedKVCache, JA.KVCache)) or hasattr(x, "conv"))
    return st_j, convert.state_from_jax(jax.tree.map(np.asarray, st_j))


class TestPagedStateHealth:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("arch", ARCHS)
    def test_checksum_bit_equal_to_reference(self, arch, dtype):
        st_j, st = _random_paged_state(arch, dtype, seed=len(arch))
        assert any(isinstance(n, A.PagedKVCache) for n in M.state_nodes(st)) == (
            arch != "rwkv6-1.6b")
        want = np.asarray(JM.decode_state_checksum(st_j))
        got = M.decode_state_checksum(st)
        assert got.dtype == torch.int64 and int(got.max()) < 2**32
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
        np.testing.assert_array_equal(M.decode_state_finite(st).numpy(),
                                      np.asarray(JM.decode_state_finite(st_j)))
        # And back: the reference's checksum of the port's state.
        back = jax.tree.unflatten(jax.tree.structure(st_j), [
            jnp.asarray(a) for a in tree_leaves(convert.state_to_jax_numpy(st))])
        np.testing.assert_array_equal(np.asarray(JM.decode_state_checksum(back)), want)

    def test_chaos_sites_hit_the_slots_own_page(self):
        """On an attention-only paged state the NaN and the flipped bit land
        on the slot's most recently written position, on a page it owns:
        only that slot's checksum moves, and an unmapped position is left
        alone."""
        _, st = _random_paged_state("gemma3-1b", "float32", seed=3)
        for node in M.state_nodes(st):
            node.page_table.copy_(torch.tensor([[1, 2, -1], [3, 4, 5], [6, -1, -1]],
                                               dtype=torch.int32))
            node.length.copy_(torch.tensor([40, 90, 33], dtype=torch.int32))
        before = M.decode_state_checksum(st)
        bitflip_slot_state(st, 1)
        after = M.decode_state_checksum(st)
        assert (after != before).tolist() == [False, True, False]
        node = M.state_nodes(st)[0]
        snap = node.k.clone()
        poison_slot_state(st, 2)                    # position 32 is unmapped
        assert torch.equal(node.k, snap)
        poison_slot_state(st, 0)                    # position 39: page 2, offset 7
        assert torch.isnan(node.k[:, 2, 7, :, 0]).all()
        assert torch.isnan(node.k).sum() == node.k.shape[0] * node.k.shape[-2]


def test_paged_pool_cost_model():
    peak, dense = CM.serve_paged_pool([48, 200, 24], [80, 56, 16], slots=2, page_size=32)
    assert 0 < peak <= dense
    shared, cold = CM.serve_prefix_admission(1000, 24, 8, page_size=32)
    assert shared < cold
    assert cold / shared >= 3.0
    with pytest.raises(ValueError):
        CM.serve_paged_pool([4], [0, 1], slots=1, page_size=32)
    with pytest.raises(ValueError):
        CM.serve_prefix_admission(10, 0, 1, 32)
    rng = np.random.default_rng(0)
    for _ in range(20):
        n = int(rng.integers(1, 9))
        p, t = rng.integers(1, 300, n).tolist(), rng.integers(1, 90, n).tolist()
        kw = dict(slots=int(rng.integers(1, 5)), page_size=int(rng.choice([32, 64])),
                  window=int(rng.integers(1, 9)))
        assert CM.serve_paged_pool(p, t, **kw) == JCM.serve_paged_pool(p, t, **kw)
        args = (int(rng.integers(0, 2000)), int(rng.integers(1, 99)),
                int(rng.integers(1, 17)), kw["page_size"])
        assert CM.serve_prefix_admission(*args) == JCM.serve_prefix_admission(*args)


def test_launcher_lane_3d_on_cpu():
    """Tier-1 lane 3d's flags through the port's launcher, on the CPU: it
    exits 0 only if every stream equals the dense engine's, the audit is
    clean and the explicitly sized pool beats the dense footprint."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "gemma3-1b", "--smoke",
           "--continuous", "--paged", "--requests", "5", "--slots", "2", "--prompt-len", "6",
           "--new-tokens", "6", "--max-len", "128", "--decode-window", "2",
           "--prefix-len", "40", "--pool-pages", "4", "--temperature", "0.8",
           "--top-k", "16", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "paged: page_size=32 shared_pages=1" in out.stdout
    assert "prefix_admissions=5" in out.stdout
    assert "paged drill: every stream bit-identical to the dense engine" in out.stdout

"""The port's partition specs against the reference's, on the host.

``param_pspecs``, ``decode_state_pspecs`` (dense and paged),
``train_state_pspecs`` and ``resolve_pspecs`` (the train, prefill and
decode inputs, ``enc_out`` included) are compared leaf by leaf, as tuples,
for every arch at full size, under every rules mode, on the (data, model)
and (pod, data, model) production meshes.  The reference's ``make_rules``
reads only ``mesh.axis_names``, so its side needs no devices.  The
reference's decode-state nodes map to the port's through
``model.convert``'s node mapping, so both trees have the same paths.

Then the dry run's per-card state on the production mesh
(``dryrun.per_card_bytes``) against a numpy reckoning of three cells from
the reference's abstract trees and specs.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.registry import get_config as jax_config
from repro.launch import inputs as JI
from repro.model import model as JM
from repro.model import sharding as JS
from repro.train import step as JT
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.launch import dryrun
from repro_torch.launch import inputs as I
from repro_torch.launch.mesh import PRODUCTION_SHAPE, make_production_mesh
from repro_torch.model import convert
from repro_torch.model import model as M
from repro_torch.model.sharding import P, make_rules, to_pspec
from repro_torch.optim.adamw import AdamWState
from repro_torch.train import step as T
from repro_torch.tree import tree_paths

jax.config.update("jax_platform_name", "cpu")

MODES = ("train", "prefill", "decode", "decode_long", "prefill_seq")
ARCHS = list_archs()


def _port(tree):
    """A reference spec tree (dicts, lists, ``None``, JAX specs) with the
    port's :class:`PartitionSpec` leaves."""
    if isinstance(tree, dict):
        return {k: _port(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_port(v) for v in tree]
    if tree is None:
        return None
    assert isinstance(tree, JP), type(tree)
    return P(*tree)


def _same(got, want):
    got, want = tree_paths(got), tree_paths(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert isinstance(g, P), path
        assert tuple(g) == tuple(w), (path, g, w)


def _rules(multi_pod, mode):
    mesh = make_production_mesh(multi_pod=multi_pod)
    ref_mesh = types.SimpleNamespace(axis_names=mesh.axis_names)
    return make_rules(mesh, mode), JS.make_rules(ref_mesh, mode)


PAGED = dict(page_size=32, private_pages=6, shared_pages=2)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["data_model", "pod_data_model"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_equal_the_reference(arch, mode, multi_pod):
    rules, ref_rules = _rules(multi_pod, mode)
    assert rules == ref_rules
    cfg, cfg_j = get_config(arch), jax_config(arch)

    _same(M.param_pspecs(cfg, rules), _port(JM.param_pspecs(cfg_j, ref_rules)))

    ts, ts_j = T.train_state_pspecs(cfg, rules), JT.train_state_pspecs(cfg_j, ref_rules)
    assert ts.ef is None and ts_j.ef is None
    _same(ts._replace(ef=None),
          T.TrainState(params=_port(ts_j.params), ef=None, opt=AdamWState(
              step=P(*ts_j.opt.step), mu=_port(ts_j.opt.mu), nu=_port(ts_j.opt.nu))))

    for paged in (None, PAGED):
        got = M.decode_state_pspecs(cfg, 4, 256, rules, insert_window=4,
                                    paged=None if paged is None else M.PageSpec(**paged))
        want = JM.decode_state_pspecs(cfg_j, 4, 256, ref_rules, insert_window=4,
                                      paged=None if paged is None else JM.PageSpec(**paged))
        _same(got, convert._map_state(want, lambda s: P(*s)))

    for name in ("train_4k", "prefill_32k", "decode_32k"):
        shape, shape_j = SHAPES[name], JSHAPES[name]
        if shape.kind == "decode":
            *_, axes = I.decode_specs(dataclasses.replace(cfg, num_layers=1), shape)
            *_, axes_j = JI.decode_specs(dataclasses.replace(cfg_j, num_layers=1), shape_j)
        else:
            _, axes = I.batch_specs(cfg, shape)
            _, axes_j = JI.batch_specs(cfg_j, shape_j)
        assert axes == axes_j
        if cfg.is_enc_dec and shape.kind == "decode":
            assert "enc_out" in axes
        _same(I.resolve_pspecs(axes, rules), _port(JI.resolve_pspecs(axes_j, ref_rules)))


def test_partition_spec_prints_and_compares_like_the_reference():
    for parts in [(), (None,), ("data", None), (("pod", "data"), "model")]:
        assert repr(P(*parts)) == repr(JP(*parts))
        assert P(*parts) == JP(*parts) == parts
    assert P() != P(None)
    rules = make_rules(make_production_mesh(), "prefill_seq")
    # seq takes the model axis first; vocab, later, is replicated.
    assert to_pspec(("batch", "seq", "vocab"), rules) == P("data", "model")
    assert to_pspec((None, "embed", None), rules) == P(None, "data")


# --------------------------------------------------------------------------
# Each card's share of the state on the production mesh
# --------------------------------------------------------------------------

def _ref_per_card(sds_tree, spec_tree, shape: dict) -> int:
    """The reference's abstract tree split by its specs, in numpy: every
    dimension divided by its axes' extent, rounded up."""
    leaves = jax.tree.leaves(sds_tree)
    specs = jax.tree.leaves(spec_tree, is_leaf=lambda x: isinstance(x, JP))
    assert len(leaves) == len(specs)
    total = 0
    for x, spec in zip(leaves, specs):
        spec = tuple(spec) + (None,) * (len(x.shape) - len(spec))
        ext = [int(np.prod([shape[a] for a in (s if isinstance(s, tuple) else (s,))]))
               if s else 1 for s in spec]
        total += int(np.prod([-(-d // e) for d, e in zip(x.shape, ext)])) * x.dtype.itemsize
    return total


@pytest.mark.parametrize("arch,shape_name,multi_pod", [
    ("dbrx_132b", "train_4k", False),
    ("qwen3_moe_235b_a22b", "decode_32k", True),
    ("gemma3_1b", "prefill_32k", False),
])
def test_per_card_state_equals_a_reckoning_from_the_reference(arch, shape_name, multi_pod):
    row = dryrun.run_production_cell(arch, shape_name, multi_pod=multi_pod, verbose=False)
    assert row["ok"] and not row.get("skipped")
    mem = row["memory"]
    assert mem["cards"] == int(np.prod(list(PRODUCTION_SHAPE[multi_pod].values())))
    assert mem["peak_estimate_bytes"] is None and "not known" in mem["peak_note"]
    shape = PRODUCTION_SHAPE[multi_pod]
    ref_mesh = types.SimpleNamespace(axis_names=tuple(shape))
    cfg_j, s = jax_config(arch), JSHAPES[shape_name]
    kind = s.kind
    rules = JS.make_rules(ref_mesh, dryrun._mode_for(shape_name, kind))
    if kind == "train":
        st, sp = JT.abstract_train_state(cfg_j), JT.train_state_pspecs(cfg_j, rules)
        want = {"params": _ref_per_card(st.params, sp.params, shape),
                "opt": _ref_per_card(st.opt, sp.opt, shape)}
    elif kind == "prefill":
        want = {"params": _ref_per_card(JM.abstract_params(cfg_j),
                                        JM.param_pspecs(cfg_j, rules), shape)}
    else:
        dcfg = dataclasses.replace(cfg_j, remat="none", microbatch=1)
        want = {"params": _ref_per_card(JM.abstract_params(dcfg),
                                        JM.param_pspecs(dcfg, rules), shape),
                "decode_state": _ref_per_card(
                    JM.abstract_decode_state(dcfg, s.global_batch, s.seq_len),
                    JM.decode_state_pspecs(dcfg, s.global_batch, s.seq_len, rules), shape)}
    # The inputs differ by design (the port's token ids are int64).
    got = {k: v for k, v in mem["state_per_card_by_part"].items() if k != "inputs"}
    assert got == want
    assert mem["state_fits"] == (mem["state_bytes_per_card"] <= mem["capacity_bytes"])


def test_production_mesh_touches_no_card():
    mesh = make_production_mesh()
    assert mesh.shape == {"data": 32, "model": 8}
    assert {d.type for d in mesh.devices.flat} == {"meta"}
    assert make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 32, "model": 8}

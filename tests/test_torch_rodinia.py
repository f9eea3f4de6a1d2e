"""The port's Rodinia suite (``repro_torch.benchmarks.rodinia``) against the
reference's ``benchmarks/rodinia.py``, on the CPU at the smoke shapes.

``benchmarks/`` has no ``__init__.py``, so the reference suite is loaded by
its path.  Each of the nine cases, shared and direct, gets the same numpy
seed-0 inputs on both sides; the reference's case functions run under
``jax.jit`` as its harness runs them.  Tolerance 1e-5 relative and
absolute: the cases are f32 sums taken in other orders (the port's scans
double Hillis–Steele style where the reference runs an associative scan;
reductions, the dot and the bpnn sums follow each framework's own order),
and the largest values (prefix sums over 1024 normals) are a few tens.
The modeled fields of ``run`` are pure Python and must equal the
reference's exactly.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.benchmarks import rodinia as R

jax.config.update("jax_platform_name", "cpu")
# Tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
#: The row fields computed from the cost model and the performance model.
MODELED = ("modeled_speedup", "energy_shared_pj", "energy_direct_pj",
           "energy_reduction", "traffic_reduction", "critical_path_direct")


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location("reference_rodinia",
                                                  ROOT / "benchmarks" / "rodinia.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def inputs():
    return R.make_inputs(smoke=True, device="cpu")


CASES = [c[0] for c in R.cases(R.make_inputs(smoke=True, device="cpu"))]


@pytest.mark.parametrize("variant", ["shared", "direct"])
@pytest.mark.parametrize("name", CASES)
def test_case_matches_reference(ref, inputs, name, variant):
    case = {c[0]: c for c in R.cases(inputs)}[name]
    port_fn = case[1] if variant == "shared" else case[2]
    args = case[3]
    ref_fn = getattr(ref, port_fn.__name__)
    got = port_fn(*args)
    want = jax.jit(ref_fn)(*(jnp.asarray(a.numpy()) for a in args))
    assert tuple(got.shape) == tuple(want.shape) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_inputs_are_the_references(inputs):
    # The reference draws x1, a_m, b_m, grid, w_b, x_b, pf_cost from one
    # seed-0 generator, in that order, at its smoke shapes.
    rng = np.random.default_rng(0)
    for key, shape in (("x1", (1024,)), ("a_m", (32, 32)), ("b_m", (32, 32)),
                       ("grid", (16, 32)), ("w_b", (8, 64)), ("x_b", (64,))):
        want = rng.standard_normal(shape).astype(np.float32)
        if key == "w_b":
            want = want * 0.05
        np.testing.assert_array_equal(inputs[key].numpy(), want)
    np.testing.assert_array_equal(inputs["pf_cost"].numpy(), rng.random(1024).astype(np.float32))
    np.testing.assert_array_equal(inputs["k3"].numpy(), [0.25, 0.5, 0.25])


def test_run_rows_equal_reference_modeled_fields(ref):
    got = R.run(reps=1, smoke=True, device="cpu")
    want = ref.run(reps=1, smoke=True)
    assert [r["name"] for r in got] == [r["name"] for r in want] == CASES
    for g, w in zip(got, want):
        assert {k: g[k] for k in MODELED} == {k: w[k] for k in MODELED}, g["name"]
        assert g["device"] == "cpu" and g["us_shared"] > 0 and g["us_direct"] > 0


def test_full_shapes_and_model_constants(ref):
    assert (R.N, R.MAT, R.GRID, R.BP) == (ref.N, ref.MAT, ref.GRID, (64, 2048))
    for name in ("GPU_LANES", "CGRA_UNITS", "CLOCK", "DRAM_BW", "SPAD_BW", "FABRIC_BW",
                 "BARRIER_CYCLES"):
        assert getattr(R, name) == getattr(ref, name), name


def test_report_lines(capsys):
    rows = R.main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("# device: cpu")
    assert out[1].startswith("name,us_shared,us_direct,wallclock_speedup,modeled_speedup")
    assert [ln.split(",")[0] for ln in out[2:11]] == CASES
    assert out[11].startswith("geomean_modeled_speedup,")
    assert out[-1].startswith("paper_reference,")
    assert len(rows) == 9

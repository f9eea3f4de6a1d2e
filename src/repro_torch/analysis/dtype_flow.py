"""Dtype-flow lint: bf16 stays bf16 on kernel I/O, f32 stays f32 in state
(counterpart of ``repro.analysis.dtype_flow``).

The kernels advertise a precise dtype contract (see ``wkv_fused``'s
docstring): activations may arrive in bf16 and come back in bf16 — every
backend accumulates in float32 *internally* — and recurrent decode state
(WKV S, RG-LRU h) is float32 end to end.  Two silent regressions break
that contract without breaking any test:

* a caller-side ``.float()`` sneaks onto the kernel I/O path, doubling the
  unavoidable HBM traffic (``cost_model.wkv_traffic``'s ``io`` term) for
  zero numerical benefit;
* the internal f32 accumulation is dropped, so long sequences quietly
  lose precision in the recurrence.

Where the reference reads a jaxpr, this pass traces the dispatch entry
points on the ``meta`` device (nothing allocated, nothing executed) under
:func:`repro_torch.core.lowering.cost_counting`, with bf16 activations,
and checks three things:

1. **I/O contract**: bf16 in -> bf16 out, state out float32 — on the
   kernel path (the meta twins) and the plain path (the plain versions).
2. **Upcast lint**: no bf16 -> f32 conversion of an activation-sized
   operand *outside* the kernel boundary, which is a meta twin's
   :func:`~repro_torch.core.lowering.kernel_scope`, a plain version called
   as the backend (:func:`~repro_torch.core.lowering.plain_version`) or a
   ``vjp.py`` autograd Function.  Inside is the backend's business (that
   is the f32 accumulation); outside is a caller paying double I/O.
3. **f32-accumulation witness**: on the plain path, a bf16 -> f32
   conversion somewhere in the trace; on the kernel path, the launch
   recorded with its FLOPs in the f32 class (the kernel's own arithmetic,
   which no aten op shows).

Plus the state-dtype audit: every ``RecState.h`` leaf in the abstract
decode state must be float32 (``model._layer_state`` builds it; a frozen
slot must round-trip bit-identically even under bf16 models).
"""

from __future__ import annotations

from repro_torch.analysis.findings import Finding, error, info

PASS = "dtype_flow"


def _trace(fn, args):
    """(counter, outputs) of ``fn(*args)`` under cost counting."""
    from repro_torch.core.lowering import cost_counting

    with cost_counting() as counter:
        out = fn(*args)
    return counter, out


def _upcasts(counter, *, interior=None):
    """bf16 -> f32 conversions of ``counter`` (all, or those in or out of
    the kernel boundary)."""
    import torch

    return [c for c in counter.conversions
            if c.src == torch.bfloat16 and c.dst == torch.float32
            and (interior is None or c.interior == interior)]


def lint_upcasts(counter, *, min_elements: int, what: str,
                 location: str) -> list[Finding]:
    """Error on any activation-sized bf16 -> f32 conversion outside the
    kernel boundary."""
    big = [c for c in _upcasts(counter, interior=False) if c.elements >= min_elements]
    if big:
        return [error(
            PASS, location,
            f"{what}: caller-side bf16->f32 upcast of activation-sized "
            f"operand(s) {[c.shape for c in big]} on the kernel I/O path — "
            f"doubles HBM traffic for no numerical benefit",
            upcasts=len(big), largest=max(c.elements for c in big),
        )]
    return [info(
        PASS, location,
        f"{what}: no activation-sized bf16->f32 upcasts outside the "
        f"kernel boundary",
    )]


def confirm_f32_accumulation(counter, *, kernel: bool, what: str,
                             location: str) -> list[Finding]:
    """The witness of internal float32 accumulation: on the kernel path a
    launch with FLOPs in the f32 class, on the plain path a bf16 -> f32
    conversion anywhere in the trace."""
    if kernel:
        n = sum(1 for k in counter.kernels.values() if k.launches and k.flops["f32"] > 0)
        if not n:
            return [error(
                PASS, location,
                f"{what}: no launch recorded with f32 FLOPs — the kernel "
                f"accumulates the recurrence in bf16",
            )]
        return [info(
            PASS, location,
            f"{what}: f32 accumulation confirmed ({n} kernel(s) with f32 FLOPs)",
            f32_kernels=n,
        )]
    ups = _upcasts(counter)
    if not ups:
        return [error(
            PASS, location,
            f"{what}: no bf16->f32 conversion anywhere in the trace — the "
            f"backend is accumulating the recurrence in bf16",
        )]
    return [info(
        PASS, location,
        f"{what}: f32 accumulation confirmed ({len(ups)} internal upcast sites)",
        upcast_sites=len(ups),
    )]


def check_io_contract(out, *, out_dtypes: tuple, what: str,
                      location: str) -> list[Finding]:
    """Compare the outputs' leaf dtypes with the advertised contract (a
    tuple parallel to the flattened outputs)."""
    import torch

    from repro_torch.tree import tree_leaves

    got = tuple(str(x.dtype).removeprefix("torch.") for x in tree_leaves(out)
                if isinstance(x, torch.Tensor))
    want = tuple(str(d).removeprefix("torch.") for d in out_dtypes)
    if got != want:
        return [error(
            PASS, location,
            f"{what}: output dtypes {got} != contract {want}",
        )]
    return [info(
        PASS, location,
        f"{what}: I/O contract holds ({' ,'.join(want)})",
        out_dtypes=want,
    )]


def audit_state_dtypes(cfg, *, batch: int = 2, max_len: int = 32,
                       location: str = "src/repro_torch/model/model.py:_layer_state",
                       ) -> list[Finding]:
    """Every RecState.h leaf in the abstract decode state must be f32."""
    import torch

    from repro_torch.model import model as M
    from repro_torch.model.recurrent import RecState

    state = M.abstract_decode_state(cfg, batch, max_len)
    rec = [n for n in M.state_nodes(state) if isinstance(n, RecState)]
    bad = [str(n.h.dtype) for n in rec if n.h.dtype != torch.float32]
    if bad:
        return [error(
            PASS, location,
            f"{cfg.name}: recurrent decode state h carried in {bad} — "
            f"must be float32 for bit-exact slot round-trips",
        )]
    if not rec:
        return []
    return [info(
        PASS, location,
        f"{cfg.name}: {len(rec)} recurrent state group(s) carry h in float32",
        rec_groups=len(rec),
    )]


def _check_dispatch(fn, args, *, out_dtypes, kernel: bool, min_elements, what: str,
                    location: str) -> list[Finding]:
    """Trace ``fn(*args)`` on meta; its I/O contract, its upcast lint (with
    ``min_elements``) and its f32 witness."""
    try:
        counter, out = _trace(fn, args)
    except Exception as e:  # noqa: BLE001 — a broken trace IS a finding
        return [error(PASS, location, f"{what}: trace failed: {e!r}")]
    findings = check_io_contract(out, out_dtypes=out_dtypes, what=f"{what} bf16",
                                 location=location)
    if min_elements is not None:
        findings += lint_upcasts(counter, min_elements=min_elements, what=what,
                                 location=location)
    return findings + confirm_f32_accumulation(counter, kernel=kernel, what=what,
                                               location=location)


# --------------------------------------------------------------------------
# Pass runner
# --------------------------------------------------------------------------

def run(cfg, *, b: int = 1, t: int = 64, chunk: int = 16) -> list[Finding]:
    """Dtype-flow audit for ``cfg``'s kernel dispatch paths, traced on the
    ``meta`` device.

    The entry points are late-bound through their module objects so the
    audit sees exactly what a caller of the module would call (mutation
    tests, and real regressions, swap the attribute)."""
    import torch

    findings: list[Finding] = []
    pattern = tuple(cfg.pattern)
    bf16, f32 = torch.bfloat16, torch.float32

    def meta(*shape, dtype=bf16):
        return torch.empty(shape, dtype=dtype, device="meta")

    if "rwkv" in pattern:
        from repro_torch.kernels.wkv import ops as wkv_ops
        from repro_torch.model.recurrent import RWKV_HEAD_DIM

        loc = "src/repro_torch/kernels/wkv/ops.py:wkv_fused"
        dh = RWKV_HEAD_DIM
        h = max(1, cfg.d_model // dh)
        act = meta(b, h, t, dh)
        args = (act, act, act, act, meta(h, dh), meta(b, h, dh, dh, dtype=f32))
        for uk in (False, True):
            def dispatch(r, k, v, w, u_, h0_, _uk=uk):
                return wkv_ops.wkv_fused(r, k, v, w, u_, h0_, chunk=chunk,
                                         use_kernel=_uk, decode=False)

            tag = "kernel" if uk else "plain"
            findings += _check_dispatch(
                dispatch, args, out_dtypes=(bf16, f32), kernel=uk,
                min_elements=b * h * t * dh, what=f"{cfg.name} wkv_fused[{tag}]",
                location=loc)

    if "rec" in pattern:
        from repro_torch.kernels.elevator_scan import ops as elev_ops

        loc = "src/repro_torch/kernels/elevator_scan/ops.py:elevator_scan"
        a, x = meta(b, t, cfg.d_rnn), meta(b, t, cfg.d_rnn)

        def elev(a_, x_):
            return elev_ops.elevator_scan(a_, x_, None, decode=False)

        def elev_plain(a_, x_):
            return elev_ops.elevator_scan_ref(a_, x_, None)

        for fn, uk in ((elev_plain, False), (elev, True)):
            findings += _check_dispatch(
                fn, (a, x), out_dtypes=(bf16,), kernel=uk, min_elements=None,
                what=f"{cfg.name} elevator_scan[{'kernel' if uk else 'plain'}]",
                location=loc)

    if not ({"rwkv", "rec"} & set(pattern)):
        findings.append(info(
            PASS, "src/repro_torch/model/transformer.py",
            f"{cfg.name}: attention-only pattern {pattern} — no recurrent "
            f"f32-accumulation contract to audit",
        ))

    findings += audit_state_dtypes(cfg.reduced())
    return findings

"""Collective-traffic audit: what crosses a mesh axis, read from the hops a
program makes (counterpart of ``repro.analysis.collectives``).

The paper's core claim is that a dataflow fabric makes communication
*statically knowable*.  The reference proves it from the jaxpr, where a
collective primitive appears with a token-sized operand or does not.  The
port has no jaxpr; its one place where a value crosses shards is
:mod:`repro_torch.core.device_comm`, whose :func:`~repro_torch.core.device_comm.record_hops`
logs every hop and exchange, forward and backward, with the elements that
leave each shard.  This pass runs the program on ``meta`` shards (every op
of the sequence-parallel WKV path has its meta twin, so nothing is
allocated or computed, yet every hop is made and logged) and, over the
audited axis:

* forbids gather-class hops (an ``all_to_all`` exchange): token
  activations crossed the mesh, which the segment-summary protocol
  (kernels/wkv/seqpar) exists to avoid;
* bounds every point-to-point hop (a ``permute``: ``device_shift``,
  ``ring_pass``) by a caller-supplied element budget (``B·H·Dh²`` for the
  WKV summaries);
* requires the reverse hops that the transposed carry must contain;
* counts the elements crossing the axis and cross-checks them against the
  cost model (:func:`repro_torch.core.cost_model.wkv_seqshard_traffic`,
  ``direct``), so the model cannot drift from the program it describes.

The cost model's ``direct`` traffic includes one masked psum of the final
state per (batch, head) and device; the single controller reads the final
state off the last shard instead, so the cross-check compares the counted
hops with the model less that term, and reports both.  The same for the
reference's findings in number of collectives: its jaxpr holds that psum
(and its transpose), the hop log does not.
"""

from __future__ import annotations

from repro_torch.analysis.findings import Finding, error, info

PASS = "collectives"

#: Gather-class hop kinds: moving one of these over a sequence axis means
#: token activations crossed the mesh.
GATHER_KINDS = ("all_to_all",)

#: Point-to-point hop kinds the summary protocol may use; their operands
#: must stay summary-sized.
P2P_KINDS = ("permute",)

LOCATION = "src/repro_torch/kernels/wkv/seqpar.py:wkv_seqshard"
COST_LOCATION = "src/repro_torch/core/cost_model.py:wkv_seqshard_traffic"

#: The audited mesh axis, the pass's element size (f32) and how far the
#: counted bytes may drift from the cost model's.
SEQ_AXIS = "seq"
ITEMSIZE = 4
TOLERANCE = 0.05


def has_reverse_hops(hops) -> bool:
    """True iff some permute (:class:`~repro_torch.core.device_comm.Hop`)
    runs high -> low shard index: the device-space *reverse* elevator a
    transposed carry must contain."""
    return any(h.reverse for h in hops)


def counted_axis_elements(hops) -> int:
    """Elements each shard sends over the axis: the sum over point-to-point
    hops, the count the cost model's fabric term must match."""
    return sum(h.elements for h in hops if h.kind in P2P_KINDS)


def audit_collectives(hops, *, max_elements: int, what: str) -> list[Finding]:
    """The per-axis budget audit.  Errors: a gather-class hop; a
    point-to-point hop above ``max_elements``; no hops at all (a program
    claiming to communicate but not communicating usually means the audit
    ran the wrong thing)."""
    findings: list[Finding] = []
    for h in hops:
        if h.kind in GATHER_KINDS:
            findings.append(error(
                PASS, LOCATION,
                f"{what}: gather collective '{h.kind}' over axis '{SEQ_AXIS}' "
                f"moves {h.elements} elements from each shard — token data "
                f"crossed the mesh",
                elements=h.elements,
            ))
    p2p = [h for h in hops if h.kind in P2P_KINDS]
    if not hops:
        findings.append(error(
            PASS, LOCATION,
            f"{what}: no collectives found over axis '{SEQ_AXIS}' — the audited "
            f"run does not communicate on this axis",
        ))
        return findings
    biggest = max((h.elements for h in p2p), default=0)
    if biggest > max_elements:
        off = [h.elements for h in p2p if h.elements > max_elements]
        findings.append(error(
            PASS, LOCATION,
            f"{what}: collective operand of {biggest} elements exceeds the "
            f"per-hop budget {max_elements} ({off})",
            elements=biggest, budget=max_elements,
        ))
    per_dev = counted_axis_elements(p2p)
    findings.append(info(
        PASS, LOCATION,
        f"{what}: {len(p2p)} point-to-point collectives over '{SEQ_AXIS}', "
        f"largest operand {biggest} <= budget {max_elements}",
        collectives=len(p2p), max_elements=biggest,
        per_device_bytes=per_dev * ITEMSIZE,
    ))
    return findings


def crosscheck_cost_model(hops, *, b: int, h: int, t: int, dh: int, n_dev: int,
                          what: str) -> list[Finding]:
    """Counted bytes (from the hop log) against the cost model's ``direct``
    bytes less its final-state psum (which the single controller does not
    make), flagging a divergence above :data:`TOLERANCE`."""
    from repro_torch.core import cost_model

    counted = counted_axis_elements(hops) * ITEMSIZE * n_dev
    modeled = cost_model.wkv_seqshard_traffic(
        b, h, t, dh, n_dev, itemsize=ITEMSIZE)[2].traffic.fabric_bytes
    psum = b * h * n_dev * dh * dh * ITEMSIZE
    div = abs(counted - (modeled - psum)) / max(modeled - psum, 1)
    msg = (f"{what}: counted {counted} B over '{SEQ_AXIS}' vs modeled {modeled} B less "
           f"its final-state psum {psum} B (divergence {div * 100:.2f}%)")
    metrics = dict(counted_bytes=counted, modeled_bytes=modeled, psum_bytes=psum,
                   divergence_pct=round(div * 100, 3), n_dev=n_dev)
    if div > TOLERANCE:
        return [error(PASS, COST_LOCATION,
                      msg + f" — cost model drifted past {TOLERANCE:.0%}", **metrics)]
    return [info(PASS, COST_LOCATION, msg, **metrics)]


# --------------------------------------------------------------------------
# Pass runner: audit the sequence-parallel entry point for a config
# --------------------------------------------------------------------------

def seq_inputs(b: int, h: int, t: int, dh: int, device):
    """The six WKV inputs (r, k, v, w, u, h0) at the pass's size on
    ``device``, requiring grad: empty on ``meta``, else drawn from seed 0
    (decays in [0.85, 0.999])."""
    import torch

    shapes = [(b, h, t, dh)] * 4 + [(h, dh), (b, h, dh, dh)]
    device = torch.device(device)
    if device.type == "meta":
        return [torch.empty(s, device=device, requires_grad=True) for s in shapes]
    gen = torch.Generator(device=device).manual_seed(0)
    out = [torch.randn(s, generator=gen, device=device) for s in shapes]
    out[3] = 0.85 + 0.149 * torch.rand(shapes[3], generator=gen, device=device)
    return [x.requires_grad_(True) for x in out]


def run(cfg, *, n: int = 4, mesh=None) -> list[Finding]:
    """Audit the sequence-parallel WKV protocol for ``cfg``.

    Runs ``wkv_seqshard`` forward and backward over ``mesh``'s ``seq``
    axis (default: an ``n``-shard seq mesh on the ``meta`` device, at the reference's reduced
    size: B = 1, H = d_model / 64, chunk 8, T = 16 n), logs its hops,
    bounds every one by the ``B·H·Dh²`` summary budget, requires reverse
    hops in the backward and cross-checks the forward's counted bytes with
    the cost model (the last two on >= 2 shards).  A mesh on a card runs
    the same on real tensors there.  Families with no RWKV layers have no
    sequence-parallel entry point: an info finding, not silence."""
    import torch

    from repro_torch.core.device_comm import record_hops
    from repro_torch.kernels.wkv.seqpar import wkv_seqshard
    from repro_torch.launch.mesh import make_seq_mesh
    from repro_torch.model.recurrent import RWKV_HEAD_DIM

    if "rwkv" not in tuple(cfg.pattern):
        return [info(
            PASS, LOCATION,
            f"{cfg.name}: no seq-parallel collective entrypoints registered for "
            f"pattern {tuple(cfg.pattern)}",
        )]
    if mesh is None:
        mesh = make_seq_mesh(n, axis=SEQ_AXIS, device="meta")
    n_dev = mesh.shape[SEQ_AXIS]
    dh = RWKV_HEAD_DIM
    b, h = 1, max(1, cfg.d_model // dh)
    chunk = 8
    t = 2 * chunk * n_dev
    args = seq_inputs(b, h, t, dh, mesh.devices.flat[0])
    with record_hops() as fwd:
        out, s = wkv_seqshard(*args, mesh=mesh, seq_axis=SEQ_AXIS, chunk=chunk)
    with record_hops() as bwd:
        torch.autograd.grad(out.sum() + s.sum(), args)

    budget = b * h * dh * dh
    findings = audit_collectives(fwd, max_elements=budget, what=f"{cfg.name} forward")
    findings += audit_collectives(bwd, max_elements=budget, what=f"{cfg.name} backward")
    if n_dev >= 2 and not has_reverse_hops(bwd):
        findings.append(error(
            PASS, LOCATION,
            f"{cfg.name} backward: no reverse-direction hops — the transposed "
            f"carry is not a reverse elevator",
        ))
    if n_dev >= 2:
        findings += crosscheck_cost_model(fwd, b=b, h=h, t=t, dh=dh, n_dev=n_dev,
                                          what=f"{cfg.name} forward")
    else:
        findings.append(info(
            PASS, LOCATION,
            f"{cfg.name}: single device — counted {counted_axis_elements(fwd) * ITEMSIZE} "
            f"B/device over '{SEQ_AXIS}'; cost-model cross-check needs >= 2 devices",
        ))
    return findings

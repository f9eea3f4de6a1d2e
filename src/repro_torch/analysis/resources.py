"""Launch-resource checker: every kernel launch's geometry and shared
memory against the card's limits, at full-width shapes.

Every kernel of the port declares its launches next to its planner
(``kernels.common.register_launch_spec``): for a config and an SM count,
the grid, block, cluster and shared memory each main path launches at
full width — *not* the smoke-reduced variant, because the point is to
catch a production shape that only fails on the card.  This pass checks,
with pure integer math over those declarations:

* a block's dynamic shared memory fits the card's opt-in limit
  (``common.SMEM_LIMIT``, 232448 bytes on the H100);
* its static and dynamic shared memory, with the card's 1 KB reservation a
  block, leave at least one block an SM in the SM's 233472 bytes (and how
  many blocks an SM shared memory allows);
* a block's threads are at most 1024 and a whole number of warps;
* the grid is well-formed: every dimension >= 1, y and z at most 65535;
* a cluster holds at most 8 blocks and divides the grid along each axis;
* the planners accept the config: a spec that raises becomes an ERROR;
* the WKV decode window's state bytes equal the cost model's per-window
  state bytes (``core/cost_model.py:wkv_decode_traffic`` direct, less
  ``wkv_decode_token_io``), so the kernel and the model it is measured
  against cannot drift apart.

Nothing is launched and nothing is allocated.  ``chip_smoke.py`` phase 1b
holds the same declarations against the card: each Python byte count
against the library's own answer, and each launch's blocks an SM against
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``.
"""

from __future__ import annotations

from repro_torch.analysis.findings import Finding, error, info

PASS = "resources"

#: A block's threads at most, and the grid's y and z at most.
MAX_THREADS = 1024
MAX_GRID_YZ = 65535
#: Blocks of a thread-block cluster at most (the portable size).
MAX_CLUSTER = 8


def load_specs():
    """Import every kernel module (their registrations), then return the
    registry."""
    import repro_torch.kernels.elevator_scan.decode  # noqa: F401
    import repro_torch.kernels.elevator_scan.kernel  # noqa: F401
    import repro_torch.kernels.local_attention.kernel  # noqa: F401
    import repro_torch.kernels.matmul_fwd.kernel  # noqa: F401
    import repro_torch.kernels.stencil2d.kernel  # noqa: F401
    import repro_torch.kernels.token_shift.kernel  # noqa: F401
    import repro_torch.kernels.wkv.bwd  # noqa: F401
    import repro_torch.kernels.wkv.decode  # noqa: F401
    import repro_torch.kernels.wkv.kernel  # noqa: F401
    from repro_torch.kernels.common import KERNEL_LAUNCH_SPECS

    return KERNEL_LAUNCH_SPECS


def launches(cfg, sms: int) -> list:
    """Every declared launch for ``cfg`` at ``sms`` SMs, spec by spec in
    name order (a spec that raises is skipped here; :func:`run` reports
    it)."""
    out = []
    for name, spec in sorted(load_specs().items()):
        try:
            out += spec(cfg, sms)
        except Exception:  # noqa: BLE001 — run() turns it into a finding
            continue
    return out


def check_launch(launch, *, what: str = "") -> list[Finding]:
    """The card's limits for one declared launch."""
    from repro_torch.kernels.common import SMEM_LIMIT, SMEM_PER_SM

    label = f"{what}{launch.kernel} [{launch.shape}]"
    loc = launch.location
    bad = []
    if len(launch.grid) != 3 or any(g < 1 for g in launch.grid):
        bad.append(f"malformed grid {launch.grid}")
    elif max(launch.grid[1:]) > MAX_GRID_YZ:
        bad.append(f"grid {launch.grid}: y and z may be at most {MAX_GRID_YZ}")
    if not 1 <= launch.threads <= MAX_THREADS or launch.threads % 32:
        bad.append(f"{launch.threads} threads a block: need a multiple of 32, "
                   f"at most {MAX_THREADS}")
    if launch.cluster_size > MAX_CLUSTER:
        bad.append(f"cluster {launch.cluster} of {launch.cluster_size} blocks: at most "
                   f"{MAX_CLUSTER}")
    if len(launch.grid) == 3 and any(c < 1 or g % c for g, c in zip(launch.grid, launch.cluster)):
        bad.append(f"cluster {launch.cluster} does not divide grid {launch.grid}")
    per_sm = launch.smem_blocks_per_sm()
    findings = [error(PASS, loc, f"{label}: {m}") for m in bad]
    if launch.dynamic_smem > SMEM_LIMIT:
        findings.append(error(
            PASS, loc,
            f"{label}: {launch.dynamic_smem} bytes of dynamic shared memory exceed "
            f"the {SMEM_LIMIT} a block may opt in to",
            smem_bytes=launch.dynamic_smem, limit_bytes=SMEM_LIMIT))
    elif per_sm < 1:
        findings.append(error(
            PASS, loc,
            f"{label}: {launch.dynamic_smem} dynamic + {launch.static_smem or 0} static "
            f"bytes leave no block an SM in {SMEM_PER_SM}",
            smem_bytes=launch.dynamic_smem, blocks_per_sm=per_sm))
    if not findings:
        findings.append(info(
            PASS, loc,
            f"{label}: grid {launch.grid} x {launch.threads} threads"
            + (f", cluster {launch.cluster}" if launch.cluster_size > 1 else "")
            + f", {launch.dynamic_smem} B of dynamic shared memory, "
            f"{per_sm} block(s) an SM by shared memory",
            smem_bytes=launch.dynamic_smem, blocks_per_sm=per_sm, blocks=launch.blocks))
    return findings


def crosscheck_decode_state(cfg, launch) -> list[Finding]:
    """The WKV decode window's state bytes against the cost model's
    per-window state bytes (``wkv_decode_traffic`` direct: one read and one
    write of S, less the token I/O)."""
    from repro_torch.core import cost_model

    meta = dict(launch.meta)
    b, h, k = meta["b"], meta["h"], meta["k"]
    dh = 64
    costs = {c.variant: c for c in cost_model.wkv_decode_traffic(b, h, dh, k)}
    modeled = costs["direct"].traffic.dram_bytes - cost_model.wkv_decode_token_io(b, h, dh, k)
    counted = launch.state_bytes * launch.blocks
    if counted != modeled:
        return [error(
            PASS, launch.location,
            f"{cfg.name} {launch.kernel} [{launch.shape}]: declared state traffic "
            f"{counted} B != cost model's {modeled} B per window — kernel and "
            f"wkv_decode_traffic drifted apart",
            counted_bytes=counted, modeled_bytes=modeled)]
    return [info(
        PASS, launch.location,
        f"{cfg.name} {launch.kernel} [{launch.shape}]: state traffic matches "
        f"wkv_decode_traffic direct ({counted} B/window)",
        state_bytes=counted)]


def run(cfg, *, sms: int | None = None) -> list[Finding]:
    """Audit every registered launch spec for ``cfg`` (the FULL config) on a
    card of ``sms`` SMs (default: the H100 SXM's 132)."""
    from repro_torch.kernels.common import EVERY_ARCH_SPECS, H100_SMS

    sms = H100_SMS if sms is None else sms
    specs = load_specs()
    findings: list[Finding] = []
    applicable = 0
    for name in sorted(specs):
        try:
            got = specs[name](cfg, sms)
        except Exception as e:  # noqa: BLE001 — invalid geometry IS a finding
            findings.append(error(
                PASS, f"src/repro_torch/kernels:{name}",
                f"{cfg.name} {name}: its planner refused the config: {e}"))
            continue
        if got and name not in EVERY_ARCH_SPECS:
            applicable += 1
        for launch in got:
            findings += check_launch(launch, what=f"{cfg.name} ")
            if launch.state_bytes is not None and launch.kernel == "wkv_decode_window_cuda":
                findings += crosscheck_decode_state(cfg, launch)
    if applicable == 0:
        findings.append(error(
            PASS, "src/repro_torch/kernels/common.py:KERNEL_LAUNCH_SPECS",
            f"{cfg.name}: no registered launch spec of a model kernel applies — "
            f"registry wiring is broken for pattern {tuple(cfg.pattern)}"))
    return findings

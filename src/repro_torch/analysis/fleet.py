"""Fleet-readiness audit: the contracts snapshot handoff rests on
(counterpart of ``repro.analysis.fleet``).

A replica fleet (:mod:`repro_torch.serve.fleet`) only delivers its
guarantee — kill a replica mid-decode, every in-flight stream finishes
bit-identical on survivors — if three engine-side contracts hold.  Each is
checked on a tiny session of the reduced config, without running a fleet:

* **Replica dispatches are registered.**  Every dispatch kind a replica's
  :class:`~repro_torch.serve.engine.ServeSession` issues (read through
  ``engine.dispatch_hook`` while one admission and one window run, on a
  dense and a paged engine) must have an entry in the in-place audit's
  registry (a fleet multiplies any per-dispatch copy by N replicas), and
  the shadow checksum entry must be registered *read-only*
  (``updated=None``): it recomputes checksums over live state the serve
  loop still owns.
* **Checksum emission is present in the window and admit dispatches.**
  The silent-corruption chain (exit(n) == entry(n+1)) only exists if
  every state-mutating dispatch returns per-slot entry and exit checksums
  as the trailing two (B,) rows of its one host array, with
  ``checksum_every > 0``.  The pass holds them to
  :func:`repro_torch.model.model.decode_state_checksum` of the state as the
  dispatch found it and as it left it.  A refactor that drops them reverts
  detection to ``isfinite``-only without failing any dispatch.
* **Handoff meta is well-formed.**  A router hands off from a dead
  replica's snapshot after validating its ``meta`` vector; the engine's
  ``ServeEngine._serve_meta`` layout and the fleet's
  :data:`~repro_torch.serve.fleet.META_LEN` parser must agree on length and
  field positions (the request count at index 3 is what stops a fleet
  resuming the wrong serve's streams).
"""

from __future__ import annotations

from repro_torch.analysis.findings import Finding, error, info

PASS = "fleet"
LOCATION = "src/repro_torch/serve/fleet.py:FleetRouter"
REGISTRY = "src/repro_torch/serve/engine.py:audit_dispatch_entrypoints"
SESSION = "src/repro_torch/serve/engine.py:ServeSession"

#: Entries whose dispatches must return the (B,) entry/exit checksum rows,
#: and the session's dispatch kinds they are.
CHECKSUM_ENTRIES = ("serve.serve_window", "serve.admit",
                    "serve.paged_window", "serve.paged_admit")
CHECKSUM_KINDS = ("admit", "window")


def session_rows(eng, batch: int):
    """One admission and one window of a checksum-armed session on
    ``eng``: the dispatch kinds it issued, and per kind (its host array,
    the state's checksum as the dispatch found it, as it left it)."""
    import numpy as np
    import torch

    from repro_torch.model import model as M
    from repro_torch.serve import engine as E

    rng = np.random.default_rng(0)
    reqs = [E.Request(tokens=rng.integers(1, eng.cfg.vocab_size, 5), max_new_tokens=4)
            for _ in range(batch)]
    kinds: list[str] = []
    rows: dict = {}
    prev = E.dispatch_hook
    E.dispatch_hook = lambda phase, kind: kinds.append(kind) if phase == "pre" else None
    try:
        sess = E.ServeSession(eng, reqs, slots=batch, checksum_every=1)
        dispatch = sess._dispatch

        def capture(kind, fn):
            entry = M.decode_state_checksum(sess.state).cpu().numpy()
            out = dispatch(kind, fn)
            host = np.asarray(out[-1]) if isinstance(out, tuple) and out else None
            rows[kind] = (host, entry, M.decode_state_checksum(sess.state).cpu().numpy())
            return out

        sess._dispatch = capture
        with torch.inference_mode():
            sess._admit()
            sess._decode_window()
    finally:
        E.dispatch_hook = prev
    return set(kinds), rows


def check_rows(name, location, got, batch: int, what: str) -> list[Finding]:
    import numpy as np

    host, entry, exit_ = got
    ok = (host is not None and host.ndim == 2 and host.shape[0] >= 2
          and host.shape[1] == batch and np.array_equal(host[-2], entry)
          and np.array_equal(host[-1], exit_))
    if ok:
        return []
    return [error(
        PASS, location,
        f"{what}: {name} does not return the trailing (B,) entry/exit checksum "
        f"rows (decode_state_checksum of the state on entry and on exit) — "
        f"silent-corruption chaining is broken for this dispatch",
    )]


def run(cfg, *, device=None) -> list[Finding]:
    """The three fleet contracts for ``cfg``'s reduced member, on
    ``device`` (``None``: the card)."""
    import numpy as np

    from repro_torch.kernels.common import resolve_device
    from repro_torch.model import model as M
    from repro_torch.serve import engine as E
    from repro_torch.serve import fleet as F

    rcfg = cfg.reduced()
    if rcfg.frontend or rcfg.is_enc_dec:
        return [info(
            PASS, LOCATION,
            f"{cfg.name}: frontend/enc-dec engines are not fleet-served "
            f"(token-only replicas)",
        )]

    findings: list[Finding] = []
    batch = 2
    registered = E.audit_dispatch_entrypoints(rcfg, device=device, batch=batch)
    entries = {e.name: e for e in registered}

    shadow = entries.get("serve.shadow_checksum")
    if shadow is None:
        findings.append(error(
            PASS, REGISTRY,
            f"{cfg.name}: the shadow checksum is not registered for the in-place "
            f"audit — the spot-check path is un-audited",
        ))
    elif shadow.updated is not None:
        findings.append(error(
            PASS, REGISTRY,
            f"{cfg.name}: the shadow checksum entry is registered as updating "
            f"{shadow.updated!r} — it must be read-only (updated=None) or the spot "
            f"check may write the live decode state",
        ))
    for name in CHECKSUM_ENTRIES:
        if name not in entries:
            findings.append(error(
                PASS, REGISTRY,
                f"{cfg.name}: {name} is not registered — replica dispatch missing "
                f"from the in-place audit",
            ))

    params = M.init_params(rcfg, 0, device=resolve_device(device))
    engines = {}
    for paged in (False, True):
        eng = engines[paged] = E.ServeEngine(rcfg, params, max_len=64, decode_window=4,
                                             device=device, paged=paged)
        mode = "paged" if paged else "dense"
        covered = {e.kind: e for e in registered if e.kind is not None and e.paged == paged}
        try:
            kinds, rows = session_rows(eng, batch)
        except Exception as e:  # noqa: BLE001 — a session that fails IS a finding
            findings.append(error(
                PASS, SESSION,
                f"{cfg.name}: a {mode} checksum-armed session failed: {e!r}"))
            continue
        for kind in sorted(kinds - set(covered)):
            findings.append(error(
                PASS, REGISTRY,
                f"{cfg.name}: a {mode} replica issues {kind!r} dispatches that no "
                f"entry of the in-place audit covers — register it",
            ))
        for kind in CHECKSUM_KINDS:
            e = covered.get(kind)
            findings += check_rows(
                e.name if e else f"the {mode} {kind}",
                e.location if e else SESSION,
                rows.get(kind, (None, None, None)), batch, cfg.name)

    meta = engines[False]._serve_meta(batch, 4, 32, 7, 0, None)
    if meta.shape != (F.META_LEN,) or meta.dtype != np.int64:
        findings.append(error(
            PASS, LOCATION,
            f"{cfg.name}: snapshot meta is {meta.dtype}{meta.shape}, the fleet "
            f"handoff parser expects int64 ({F.META_LEN},) — read_snapshot_host "
            f"would reject every snapshot",
        ))
    elif [int(m) for m in meta[:5]] != [batch, 4, 32, 7, 0]:
        findings.append(error(
            PASS, LOCATION,
            f"{cfg.name}: snapshot meta field order changed "
            f"({meta.tolist()[:5]} for b=2 k=4 iw=32 n=7 seed=0) — the handoff "
            f"validator reads the request count at index 3 and would trust the "
            f"wrong field",
        ))

    if not findings:
        findings.append(info(
            PASS, LOCATION,
            f"{cfg.name}: {len(CHECKSUM_ENTRIES)} replica dispatches return their "
            f"checksum rows, every dispatch kind a replica issues is registered, "
            f"the shadow checksum is read-only, handoff meta layout matches the "
            f"fleet parser",
            checksum_entries=len(CHECKSUM_ENTRIES),
        ))
    return findings

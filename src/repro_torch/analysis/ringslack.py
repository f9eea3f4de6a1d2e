"""Local-attention ring-slack checker: windowed decode must never wrap.

A window of ``t`` tokens inserted into a local-attention ring of ``S``
slots is exact iff ``S >= attn_window + t - 1`` — or the ring is capped at
``max_len`` and can never wrap at all.  ``init_decode_state`` sizes the
slack through ``insert_window``; building a state too small fails
silently (earlier in-window queries attend to evicted slots: corrupt
logits, no error).

The rule lives in the model (``model/model.py:_check_ring_slack``, which
``decode_step`` runs on every window and which raises on a violation);
this pass runs that same function, so the serving path and the audit
cannot disagree.
"""

from __future__ import annotations

from repro_torch.analysis.findings import Finding, error, info

PASS = "ringslack"
LOCATION = "src/repro_torch/model/model.py:_check_ring_slack"


def ring_slack_violations(cfg, state, t: int, max_len: int | None) -> list[str]:
    """The ring contract's violation for ``state`` and a ``t``-token
    window, as a message (empty list = the contract holds): the model's
    own check, whose ``ValueError`` is the violation."""
    from repro_torch.model import model as M

    try:
        M._check_ring_slack(cfg, state, t, max_len)
    except ValueError as e:
        return [str(e)]
    return []


def run(cfg, *, batch: int = 2, max_len: int = 128,
        windows: tuple[int, ...] = (1, 4, 8)) -> list[Finding]:
    """Audit the ring contract for every window size a serve loop uses.

    Builds decode states the way the engine does — ``init_decode_state``
    with ``insert_window=t``, on the ``meta`` device (nothing allocated) —
    and requires zero violations; then probes the negative direction (a
    state built *without* slack must be rejected for multi-token windows),
    so the guard itself is proven live, not just never-triggered."""
    from repro_torch.model import model as M

    rcfg = cfg.reduced()
    findings: list[Finding] = []
    if rcfg.attn_window is None:
        return [info(
            PASS, LOCATION,
            f"{cfg.name}: no local-attention layers — ring contract "
            f"trivially holds",
        )]

    for t in windows:
        state = M.init_decode_state(rcfg, batch, max_len, insert_window=t, device="meta")
        msgs = ring_slack_violations(rcfg, state, t, max_len)
        if msgs:
            findings.append(error(
                PASS, LOCATION,
                f"{cfg.name}: state built with insert_window={t} still "
                f"violates the ring contract: {msgs[0]}",
                window=t,
            ))
    # The guard must actually fire: a slack-less ring + a window wider
    # than the remaining slack, with no max_len vouching for the cap.
    t_probe = max(windows)
    if t_probe > 1:
        bare = M.init_decode_state(rcfg, batch, max_len, insert_window=1, device="meta")
        ring = min(max_len, rcfg.attn_window)
        if ring < max_len and not ring_slack_violations(rcfg, bare, t_probe, None):
            findings.append(error(
                PASS, LOCATION,
                f"{cfg.name}: guard did not flag a {t_probe}-token window "
                f"into a slack-less ring of {ring} slots — the decode-time "
                f"check is dead",
                window=t_probe,
            ))
    if not findings:
        findings.append(info(
            PASS, LOCATION,
            f"{cfg.name}: ring contract holds for windows {windows} "
            f"(attn_window={rcfg.attn_window}, max_len={max_len}) and the "
            f"guard fires on slack-less states",
            windows=list(windows),
        ))
    return findings

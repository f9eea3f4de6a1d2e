"""Dispatch-shape sentinel: serve-loop dispatches must see one shape per
bucket (counterpart of ``repro.analysis.retrace``).

The reference's engine jits each piece and counts on compiling it once
per shape bucket; a shape leak — a Python int that should have been
bucketed, a state whose shape depends on the exact prompt length —
silently turns every dispatch into a recompile.  The port compiles
nothing at dispatch, but a leak costs it the same way: every new shape is
a new plan for each kernel (the planners' ``lru_cache``s grow), and a
CUDA graph captured over a serve window at fixed (B, K) replays only if
the window's shapes never change.

This pass runs a *tiny real* serve session (smoke-reduced config) with
deliberately ragged prompt lengths spanning two admission buckets, then
one lockstep ``generate``, and records the shapes each dispatch receives:
the token windows of every ``model.decode_step`` it makes and the decode
state's leaf shapes.  Then:

* serve windows: exactly one (B, K) for one sampling configuration;
* admissions: at most one shape per *declared* prompt bucket (the
  32-multiple rounding), re-declared here (:data:`PROMPT_BUCKET`) rather
  than imported from the engine, so an engine that stops bucketing cannot
  fool its own audit;
* ``generate()``: at most two window shapes (interior + last) and one
  prefill shape;
* the planners' ``lru_cache``s grow by no more entries than the distinct
  token shapes the session dispatched (on the CPU the plain versions run
  and nothing is planned).

It executes, but only at smoke scale (two slots, < 100 positions).
"""

from __future__ import annotations

import collections
import contextlib

from repro_torch.analysis.findings import Finding, error, info

PASS = "retrace"
LOCATION = "src/repro_torch/serve/engine.py:ServeEngine"

#: The auditor's own declaration of the admission bucket width.  The
#: engine has an equivalent ``_bucket32``; keeping an independent copy
#: here is deliberate — the audit is the spec, the engine the
#: implementation, and they must agree through behavior, not imports.
PROMPT_BUCKET = 32


def _bucket(n: int) -> int:
    return -(-max(int(n), 1) // PROMPT_BUCKET) * PROMPT_BUCKET


def planners() -> dict:
    """Every cached planner of the port's kernels (a module function named
    ``plan*`` with an ``lru_cache``): ``"module.name" -> function``."""
    import importlib
    import pkgutil

    import repro_torch.kernels as K

    out = {}
    for mod in pkgutil.walk_packages(K.__path__, K.__name__ + "."):
        m = importlib.import_module(mod.name)
        for name, fn in vars(m).items():
            if (name.startswith("plan") and hasattr(fn, "cache_info")
                    and getattr(fn, "__module__", None) == m.__name__):
                out[f"{m.__name__}.{name}"] = fn
    return out


class _Shapes:
    """Per dispatch kind, the distinct signatures its dispatches had: the
    token shapes of the ``decode_step`` calls one dispatch made, and the
    decode state's leaf shapes."""

    def __init__(self):
        self.kind: str | None = None
        self.current: list = []
        self.by_kind: dict[str, set] = collections.defaultdict(set)
        self.tokens: set = set()

    def begin(self, kind: str):
        self.kind, self.current = kind, []

    def end(self):
        if self.kind is not None and self.current:
            self.by_kind[self.kind].add(tuple(self.current))
        self.kind = None

    def decode_step(self, tokens, state):
        from repro_torch.tree import tree_leaves

        shape = tuple(tokens.shape)
        self.tokens.add(shape)
        self.current.append((shape, tuple(tuple(x.shape) for x in tree_leaves(state))))


@contextlib.contextmanager
def _recording(eng):
    """Record the shapes every dispatch of ``eng`` receives: the session's
    through ``engine.dispatch_hook``, ``generate``'s by wrapping the
    engine's prefill and window, each ``model.decode_step`` by wrapping
    the module function."""
    from repro_torch.model import model as M
    from repro_torch.serve import engine as E

    rec = _Shapes()
    decode_step, hook, prefill = M.decode_step, E.dispatch_hook, eng._prefill

    def recorded(params, cfg, state, tokens, lengths, **kw):
        rec.decode_step(tokens, state)
        return decode_step(params, cfg, state, tokens, lengths, **kw)

    def session_hook(phase, kind):
        if phase == "pre":
            rec.begin("serve_window" if kind == "window" else kind)
        else:
            rec.end()

    def tagged(kind, fn):
        def call(*args, **kw):
            rec.begin(kind)
            try:
                return fn(*args, **kw)
            finally:
                rec.end()
        return call

    M.decode_step, E.dispatch_hook = recorded, session_hook
    eng._prefill, eng._window = tagged("prefill", prefill), tagged("window", eng._window)
    try:
        yield rec
    finally:
        M.decode_step, E.dispatch_hook, eng._prefill = decode_step, hook, prefill
        del eng._window           # the instance attribute; the method shows again


def audit_serve(eng, requests, prompts, new_tokens: int, *, slots: int,
                what: str) -> list[Finding]:
    """Serve ``requests`` through ``eng`` on ``slots`` slots, then one
    ``generate`` of ``new_tokens`` from ``prompts``, and audit the shapes
    the dispatches received (``what`` names the config in the findings)."""
    import numpy as np

    prompt_lens = tuple(int(np.asarray(r.tokens).size) for r in requests)
    cached = planners()
    before = {n: fn.cache_info().currsize for n, fn in cached.items()}
    with _recording(eng) as rec:
        eng.serve(requests, slots=slots)
        eng.generate(prompts, new_tokens)
    grown = {n: fn.cache_info().currsize - before[n] for n, fn in cached.items()}

    findings: list[Finding] = []
    buckets = {_bucket(pl) for pl in prompt_lens}
    shapes = {k: rec.by_kind.get(k, set())
              for k in ("admit", "serve_window", "window", "prefill")}

    if len(shapes["serve_window"]) != 1:
        findings.append(error(
            PASS, LOCATION,
            f"{what}: {len(shapes['serve_window'])} serve-window shapes for one "
            f"sampling configuration (expected 1: one (B, K)) — the window leaked "
            f"a non-shape value into its shapes",
            windows=len(shapes["serve_window"]),
        ))
    if len(shapes["admit"]) > len(buckets):
        widths = sorted({sig[0][0][1] for sig in shapes["admit"]})
        findings.append(error(
            PASS, LOCATION,
            f"{what}: {len(shapes['admit'])} admission shapes (widths {widths}) "
            f"for prompt lengths {prompt_lens} spanning {len(buckets)} declared "
            f"{PROMPT_BUCKET}-buckets {sorted(buckets)} — admission stopped bucketing "
            f"prompt shapes",
            admits=len(shapes["admit"]), buckets=len(buckets),
        ))
    if len(shapes["window"]) > 2:
        findings.append(error(
            PASS, LOCATION,
            f"{what}: {len(shapes['window'])} decode-window shapes after one "
            f"generate() (expected <= 2: interior + last)",
            windows=len(shapes["window"]),
        ))
    if len(shapes["prefill"]) > 1:
        findings.append(error(
            PASS, LOCATION,
            f"{what}: {len(shapes['prefill'])} prefill shapes after one "
            f"generate() (expected 1)",
            prefills=len(shapes["prefill"]),
        ))
    over = {n: g for n, g in grown.items() if g > len(rec.tokens)}
    if over:
        findings.append(error(
            PASS, LOCATION,
            f"{what}: kernel planners planned {over} new launches for "
            f"{len(rec.tokens)} distinct token shapes — a plan key leaks a "
            f"non-shape value",
            plans=sum(over.values()), token_shapes=len(rec.tokens),
        ))

    if not findings:
        findings.append(info(
            PASS, LOCATION,
            f"{what}: serve session over prompts {prompt_lens} dispatched "
            f"{len(shapes['admit'])} admit / {len(shapes['serve_window'])} "
            f"serve-window / {len(shapes['window'])} window / "
            f"{len(shapes['prefill'])} prefill shapes; planners grew by "
            f"{sum(grown.values())} for {len(rec.tokens)} token shapes",
            admits=len(shapes["admit"]), buckets=len(buckets),
        ))
    return findings


def run(cfg, *, prompt_lens: tuple[int, ...] = (3, 5, 33, 7), max_new: int = 4,
        slots: int = 2, device=None) -> list[Finding]:
    """Serve ``prompt_lens`` through a smoke engine on ``device`` (``None``:
    the card) and audit the shapes its dispatches received."""
    import numpy as np
    import torch

    from repro_torch.kernels.common import resolve_device
    from repro_torch.model import model as M
    from repro_torch.serve.engine import Request, ServeEngine

    rcfg = cfg.reduced()
    if rcfg.frontend or rcfg.is_enc_dec:
        return [info(
            PASS, LOCATION,
            f"{cfg.name}: frontend/enc-dec serving not audited by the "
            f"retrace sentinel (token-only engine)",
        )]

    dev = resolve_device(device)
    params = M.init_params(rcfg, 0, device=dev)
    eng = ServeEngine(rcfg, params, max_len=96, decode_window=2, device=dev)
    rng = np.random.default_rng(0)
    reqs = [
        Request(tokens=rng.integers(1, rcfg.vocab_size, size=(pl,)).astype(np.int32),
                max_new_tokens=max_new)
        for pl in prompt_lens
    ]
    prompts = torch.as_tensor(rng.integers(1, rcfg.vocab_size, size=(2, 16)), device=dev)
    return audit_serve(eng, reqs, prompts, 2 * max_new, slots=slots, what=cfg.name)

"""Host-tier safety audit: lock discipline and in-place hazards, pure AST.

The device tier is audited elsewhere (launch geometry and shared memory in
``resources``, the page tables in ``paging``) — but the worst bugs of the
reference's history lived in the *host* code that drives the kernels: a
stale watchdog thread writing an abandoned step's result past the
generation fence, and a fleet no-progress guard sampling ``busy`` before
the round it was guarding.  Both were invisible to tier-1 because thread
interleavings are nondeterministic.  This pass walks the host source as an
AST — no torch import, nothing runs — and checks two families of
invariant:

**(a) updating state in place.**  The reference donates its decode and
train state to its jits; the port updates the same state in place, which
trades the reference's use-after-donate hazard for two of its own:

* ``[retry-after-start]`` — in a dispatch wrapper (``DISPATCH_WRAPPERS``),
  re-running ``fn`` after it began writing the state in place corrupts it.
  ``fn``'s caller sets a start flag under a gate's lock before it calls
  ``fn``; every ``except`` path of the wrapper's retry loop that can loop
  back to that call must, under the gate's lock, read the flag and raise
  when it is set.  A path that catches only exceptions the gate itself
  raises before setting the flag is exempt (nothing started).
* ``[unsnapshotted-thread-arg]`` — a ``threading.Thread(target=...,
  args=...)`` must not be handed a parameter of the enclosing function
  that its caller may go on updating in place: hand it a host copy.  A
  parameter whose annotation names only immutable types (``str``, ``int``,
  a ``Path``, a ``tuple``, ``None``...) may be handed over as it is.

**(b) lock discipline**, the reference's rules unchanged: inventories
``threading.Lock``/``Thread`` use, builds the lock-acquisition-order graph
(a cycle is a deadlock finding), and flags: writes to shared state (self
attributes, closure names) inside a thread target but outside any lock;
attributes written both by a thread target and, un-locked, by other
methods; result writes in an *abandonable* thread (its launcher joins with
a timeout) whose lock region has no generation fence; and loop guards that
``raise`` on a mix of state sampled before and after the loop's mutating
call.

Intentional patterns carry a ``# hostsafety: ok(<reason>)`` waiver on (or
one comment line above) the flagged line; waived findings are listed in
the table as INFO.  The dynamic complement is
:mod:`repro_torch.serve.interleave`, which forces preemption at exactly the
boundaries audited here.

API for mutation tests: :func:`run_on_sources` takes a mapping of
repo-path labels to source text, so fixture copies with reintroduced bugs
audit under their real locations without touching the tree.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path

from repro_torch.analysis.findings import Finding, Severity, error, info, warn

PASS = "hostsafety"

#: This pass is pure AST: the CLI runs it without importing torch, so it
#: must stay importable and runnable torch-free.
TORCH_FREE = True

_REPO = Path(__file__).resolve().parents[3]

#: Host modules under audit, repo-relative.  Order is display order.
HOST_MODULES = (
    "src/repro_torch/serve/engine.py",
    "src/repro_torch/serve/fleet.py",
    "src/repro_torch/serve/health.py",
    "src/repro_torch/serve/chaos.py",
    "src/repro_torch/serve/paging.py",
    "src/repro_torch/serve/interleave.py",
    "src/repro_torch/ft/watchdog.py",
    "src/repro_torch/checkpoint/checkpoint.py",
    "src/repro_torch/train/step.py",
    "src/repro_torch/launch/serve.py",
    "src/repro_torch/launch/train.py",
)

WAIVER_RE = re.compile(r"#\s*hostsafety:\s*ok\(([^)]*)\)")

#: Dispatch wrappers, by qualified name: ``<fn_param>()`` (in a function
#: nested in the wrapper) runs the dispatched function, which updates state
#: in place.
DISPATCH_WRAPPERS = {
    "ServeEngine._dispatch": {"fn_param": "fn"},
}

#: Annotation names of types a thread cannot see change under it.
_IMMUTABLE = frozenset({
    "str", "int", "float", "bool", "bytes", "complex", "tuple", "frozenset",
    "Path", "PurePath", "PathLike", "None", "Optional", "Union",
})

#: A callee whose name matches this makes a host copy (``_host_copy``,
#: ``copy.deepcopy``, ``.clone()``).
_COPY_RE = re.compile(r"copy|clone", re.IGNORECASE)

#: Method names that mutate their receiver in place (shared-write rule).
_MUTATORS = frozenset({
    "append", "appendleft", "extend", "add", "update", "insert", "pop",
    "popleft", "remove", "discard", "clear", "setdefault", "put",
})

#: Receiver constructors recognized as locks.
_LOCK_CTORS = frozenset({"Lock", "RLock", "make_lock"})


# --------------------------------------------------------------------------
# small AST helpers
# --------------------------------------------------------------------------

def _key_of(node) -> str | None:
    """Canonical dotted key for a Name/Attribute chain, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _key_of(node.value)
        return None if base is None else f"{base}.{node.attr}"
    return None


def _own_walk(fn):
    """Walk ``fn``'s body without descending into nested function/lambda
    scopes (their statements belong to the nested scope)."""
    stack = list(fn.body)
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(n))



def _lock_ctor_name(node) -> bool:
    """True if ``node`` is a call to a recognized lock constructor."""
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    name = f.attr if isinstance(f, ast.Attribute) else (
        f.id if isinstance(f, ast.Name) else None)
    return name in _LOCK_CTORS



# --------------------------------------------------------------------------
# per-module audit context
# --------------------------------------------------------------------------

class _ModuleCtx:
    """Shared per-module facts: source lines (for waivers), path label."""

    def __init__(self, path: str, src: str):
        self.path = path
        self.lines = src.splitlines()

    def waiver(self, line: int) -> str | None:
        """Waiver reason if ``# hostsafety: ok(<reason>)`` sits on
        ``line`` or anywhere in the contiguous comment block directly
        above it (comments are invisible to the AST, so this reads the
        raw source)."""
        if not 1 <= line <= len(self.lines):
            return None
        m = WAIVER_RE.search(self.lines[line - 1])
        if m:
            return m.group(1).strip()
        ln = line - 1
        while ln >= 1 and self.lines[ln - 1].lstrip().startswith("#"):
            m = WAIVER_RE.search(self.lines[ln - 1])
            if m:
                return m.group(1).strip()
            ln -= 1
        return None


class _Reporter:
    """Finding sink with waiver handling and per-(rule, line) dedup."""

    def __init__(self, ctx: _ModuleCtx, qual: str, out: list[Finding],
                 waived: list[str]):
        self.ctx = ctx
        self.qual = qual
        self.out = out
        self.waived = waived
        self._seen: set[tuple] = set()

    def flag(self, rule: str, node, message: str,
             severity: Severity = Severity.ERROR):
        line = getattr(node, "lineno", 0)
        dkey = (rule, line, self.qual)
        if dkey in self._seen:
            return
        self._seen.add(dkey)
        loc = f"{self.ctx.path}:{self.qual}"
        reason = self.ctx.waiver(line)
        if reason is not None:
            self.waived.append(f"{loc} line {line} [{rule}]: {reason}")
            self.out.append(info(
                PASS, loc,
                f"[{rule}] line {line}: waived — {reason}", line=line))
            return
        mk = error if severity >= Severity.ERROR else warn
        self.out.append(mk(PASS, loc, f"[{rule}] line {line}: {message}",
                           line=line))




# --------------------------------------------------------------------------
# pass (a): updating state in place
# --------------------------------------------------------------------------

def _callee_name(call) -> str | None:
    f = call.func
    return f.attr if isinstance(f, ast.Attribute) else (
        f.id if isinstance(f, ast.Name) else None)


def _calls(node, names) -> bool:
    """Whether ``node`` contains a call of a plain name in ``names``."""
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
               and n.func.id in names for n in ast.walk(node))


def _raised_names(nodes) -> set[str]:
    """The exception classes ``raise X`` / ``raise X(...)`` name in
    ``nodes``."""
    out = set()
    for n in nodes:
        if isinstance(n, ast.Raise) and n.exc is not None:
            e = n.exc.func if isinstance(n.exc, ast.Call) else n.exc
            key = _key_of(e)
            if key is not None:
                out.add(key.rsplit(".", 1)[-1])
    return out


@dataclass
class _StartGate:
    """The start gate of a dispatch wrapper: the function that calls
    ``fn``, the flag it sets (``<obj>.<flag> = True``) under a lock
    (``<obj>.<lock>``) before that call, and the exceptions it raises
    itself before setting it."""

    runner: object
    flag: str
    lock: str
    pre_start: set[str]
    line: int


def _start_gate(wrapper, fn_param: str) -> _StartGate | None:
    for sub in _local_defs(wrapper).values():
        calls = [n for n in ast.walk(sub) if isinstance(n, ast.Call)
                 and isinstance(n.func, ast.Name) and n.func.id == fn_param]
        if not calls:
            continue
        call_line = min(c.lineno for c in calls)
        for w in ast.walk(sub):
            if not isinstance(w, ast.With) or w.lineno > call_line:
                continue
            locks = [_key_of(i.context_expr) for i in w.items]
            for st in ast.walk(w):
                if (isinstance(st, ast.Assign) and len(st.targets) == 1
                        and isinstance(st.targets[0], ast.Attribute)
                        and isinstance(st.value, ast.Constant)
                        and st.value.value is True and st.lineno < call_line
                        and locks and locks[0] is not None):
                    before = [n for n in ast.walk(sub)
                              if getattr(n, "lineno", call_line) < st.lineno]
                    return _StartGate(sub, st.targets[0].attr,
                                      locks[0].rsplit(".", 1)[-1],
                                      _raised_names(before), st.lineno)
    return None


def _exits(body) -> bool:
    """Whether a handler body leaves the loop on every path through its top
    level (``raise``, ``return`` or ``break``)."""
    return any(isinstance(st, (ast.Raise, ast.Return, ast.Break)) for st in body)


def _handler_names(h) -> list[str]:
    if h.type is None:
        return []
    types = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
    keys = [_key_of(t) for t in types]
    return [] if None in keys else [k.rsplit(".", 1)[-1] for k in keys]


def _guarded(h, gate: _StartGate) -> bool:
    """The handler reads the start flag under the gate's lock and raises
    when it is set."""
    reads = set()
    for w in ast.walk(h):
        if not isinstance(w, ast.With):
            continue
        if not any((_key_of(i.context_expr) or "").rsplit(".", 1)[-1] == gate.lock
                   for i in w.items):
            continue
        for st in ast.walk(w):
            if isinstance(st, ast.Attribute) and st.attr == gate.flag:
                reads.add(gate.flag)
            if (isinstance(st, ast.Assign) and isinstance(st.value, ast.Attribute)
                    and st.value.attr == gate.flag):
                reads.update(t.id for t in st.targets if isinstance(t, ast.Name))
    if not reads:
        return False
    for st in ast.walk(h):
        if not isinstance(st, ast.If):
            continue
        test = {n.id for n in ast.walk(st.test) if isinstance(n, ast.Name)}
        test |= {n.attr for n in ast.walk(st.test) if isinstance(n, ast.Attribute)}
        if test & reads and any(isinstance(x, ast.Raise) for x in ast.walk(st)):
            return True
    return False


def _audit_retry(ctx: _ModuleCtx, tree, out: list[Finding], waived: list[str],
                 tally: dict):
    """``[retry-after-start]`` over every dispatch wrapper in the module."""
    def visit(node, prefix):
        for child in getattr(node, "body", ()):
            if isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}.{child.name}" if prefix else child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}.{child.name}" if prefix else child.name
                if qual in DISPATCH_WRAPPERS:
                    check(child, qual, DISPATCH_WRAPPERS[qual])

    def check(fn, qual, spec):
        tally["wrappers"] += 1
        rep = _Reporter(ctx, qual, out, waived)
        gate = _start_gate(fn, spec["fn_param"])
        if gate is None:
            rep.flag("retry-after-start", fn,
                     f"no start flag: nothing set under a lock before "
                     f"'{spec['fn_param']}()' runs, so no except path can tell "
                     "a failure before the in-place update from one after it")
            return
        tally["flags"].add(gate.flag)
        runners = {spec["fn_param"], gate.runner.name}
        for loop in _own_walk(fn):
            if not isinstance(loop, (ast.While, ast.For)) or not _calls(loop, runners):
                continue
            for tr in ast.walk(loop):
                if not isinstance(tr, ast.Try):
                    continue
                for h in tr.handlers:
                    if _exits(h.body):
                        continue
                    tally["handlers"] += 1
                    names = _handler_names(h)
                    if names and all(n in gate.pre_start for n in names):
                        tally["exempt"].update(names)
                        continue
                    if _guarded(h, gate):
                        tally["guarded"] += 1
                        continue
                    rep.flag(
                        "retry-after-start", h,
                        f"except {'/'.join(names) or '(any)'} loops back to "
                        f"'{spec['fn_param']}()' without reading the start flag "
                        f"'{gate.flag}' (set at line {gate.line}) under the "
                        f"gate's '{gate.lock}' and raising when it is set — a "
                        "retry after the in-place update began corrupts the state")

    visit(tree, "")


def _immutable(annotation) -> bool:
    """Whether an annotation names only types a thread cannot see change."""
    if annotation is None:
        return False
    leaves = [n.id for n in ast.walk(annotation) if isinstance(n, ast.Name)]
    leaves += [n.attr for n in ast.walk(annotation) if isinstance(n, ast.Attribute)]
    leaves += ["None" for n in ast.walk(annotation)
               if isinstance(n, ast.Constant) and n.value is None]
    mods = {_key_of(n.value) for n in ast.walk(annotation) if isinstance(n, ast.Attribute)}
    return bool(leaves) and all(x in _IMMUTABLE or x in mods for x in leaves)


def _audit_thread_args(ctx: _ModuleCtx, tree, out: list[Finding], waived: list[str],
                       tally: dict):
    """``[unsnapshotted-thread-arg]`` over every function in the module."""
    def visit(node, prefix):
        for child in getattr(node, "body", ()):
            if isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}.{child.name}" if prefix else child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}.{child.name}" if prefix else child.name
                check(child, qual)
                visit(child, qual)

    def check(fn, qual):
        a = fn.args
        params = {p.arg: p.annotation for p in (list(a.posonlyargs) + list(a.args)
                                                + list(a.kwonlyargs))
                  if p.arg not in ("self", "cls")}
        alias, copies = {}, set()
        for st in _own_walk(fn):
            if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                    and isinstance(st.targets[0], ast.Name):
                v, name = st.value, st.targets[0].id
                if isinstance(v, ast.Name) and v.id in params:
                    alias[name] = v.id
                elif isinstance(v, ast.Call) and _COPY_RE.search(_callee_name(v) or ""):
                    copies.add(name)
        rep = _Reporter(ctx, qual, out, waived)
        for call in _own_walk(fn):
            if not (isinstance(call, ast.Call) and _callee_name(call) == "Thread"):
                continue
            tally["threads"] += 1
            handed = []
            for kw in call.keywords:
                if kw.arg == "args" and isinstance(kw.value, (ast.Tuple, ast.List)):
                    handed += kw.value.elts
                elif kw.arg == "kwargs" and isinstance(kw.value, ast.Dict):
                    handed += kw.value.values
            for e in handed:
                if not isinstance(e, ast.Name):
                    continue
                if e.id in copies:
                    tally["copies"] += 1
                    continue
                param = alias.get(e.id, e.id)
                if param not in params:
                    continue
                tally["params"] += 1
                if _immutable(params[param]):
                    tally["immutable"] += 1
                    continue
                rep.flag(
                    "unsnapshotted-thread-arg", call,
                    f"parameter '{param}' is handed to a background thread as "
                    "it is: the caller may update it in place while the thread "
                    "reads it — hand the thread a host copy")

    visit(tree, "")


# --------------------------------------------------------------------------
# pass (b): lock discipline
# --------------------------------------------------------------------------

@dataclass
class _ClassLocks:
    qual: str
    locks: set[str] = field(default_factory=set)       # self.<attr> locks
    thread_targets: dict[str, object] = field(default_factory=dict)
    abandonable: bool = False    # some launcher joins with a timeout


def _collect_class_locks(cls: ast.ClassDef, prefix: str) -> _ClassLocks:
    qual = f"{prefix}.{cls.name}" if prefix else cls.name
    cl = _ClassLocks(qual=qual)
    methods = {m.name: m for m in cls.body
               if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
    for m in methods.values():
        for node in ast.walk(m):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t, v = node.targets[0], node.value
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self" and _lock_ctor_name(v):
                    cl.locks.add(t.attr)
            if isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr == "Thread":
                    for kw in node.keywords:
                        if kw.arg != "target":
                            continue
                        tgt = kw.value
                        if isinstance(tgt, ast.Name) \
                                and tgt.id in _local_defs(m):
                            cl.thread_targets[f"{m.name}.{tgt.id}"] = (
                                _local_defs(m)[tgt.id])
                        elif isinstance(tgt, ast.Attribute) \
                                and tgt.attr in methods:
                            cl.thread_targets[tgt.attr] = methods[tgt.attr]
                if isinstance(f, ast.Attribute) and f.attr == "join":
                    timed = bool(node.args) or any(
                        kw.arg == "timeout" for kw in node.keywords)
                    if timed:
                        cl.abandonable = True
    return cl


def _local_defs(fn) -> dict[str, object]:
    return {n.name: n for n in _own_walk(fn)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


class _LockWalk:
    """Walk one thread-target function: writes to shared state must hold
    a lock; abandonable threads need a generation fence in the locked
    result-write region."""

    def __init__(self, ctx: _ModuleCtx, cl: _ClassLocks, fn, qual: str,
                 rep: _Reporter):
        self.ctx = ctx
        self.cl = cl
        self.fn = fn
        self.qual = qual
        self.rep = rep
        self.local: set[str] = set()
        self.shared_writes: set[str] = set()   # self attrs written here

    def run(self):
        args = self.fn.args
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)):
            self.local.add(a.arg)
        # Names assigned anywhere in the target are locals (Python scoping:
        # assignment without nonlocal makes the name local).
        for n in _own_walk(self.fn):
            if isinstance(n, ast.Assign):
                for t in n.targets:
                    self._collect_local(t)
            elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
                self._collect_local(n.target)
            elif isinstance(n, ast.Nonlocal):
                for name in n.names:
                    self.local.discard(name)
        self.walk_block(self.fn.body, held=())

    def _collect_local(self, t):
        if isinstance(t, ast.Name):
            self.local.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self._collect_local(e)
        elif isinstance(t, ast.Starred):
            self._collect_local(t.value)

    def _is_lock_key(self, key: str | None) -> bool:
        return key is not None and key.startswith("self.") \
            and key.split(".")[1] in self.cl.locks

    def _shared_write_key(self, t) -> str | None:
        """Dotted key if ``t`` is a write to shared state (self attr /
        subscript on one, or a closure name), else None."""
        node = t.value if isinstance(t, ast.Subscript) else t
        key = _key_of(node)
        if key is None:
            return None
        root = key.split(".", 1)[0]
        if root == "self":
            return key
        if root not in self.local:
            return key
        return None

    def walk_block(self, stmts, held):
        for st in stmts:
            self.walk_stmt(st, held)

    def walk_stmt(self, st, held):
        if isinstance(st, ast.With):
            new = list(held)
            for item in st.items:
                key = _key_of(item.context_expr)
                if self._is_lock_key(key):
                    new.append(key)
            if len(new) > len(held) and new[-1] not in held:
                block_writes: list[tuple] = []
                self._scan_locked_block(st.body, block_writes)
                if self.cl.abandonable and block_writes \
                        and not self._has_fence(st.body):
                    self.rep.flag(
                        "stale-thread-write", st,
                        "result write in an abandonable thread (its "
                        "launcher joins with a timeout) lacks a generation "
                        "fence: a timed-out, abandoned run can still "
                        "publish its result — the abandoned-watchdog race")
            self.walk_block(st.body, tuple(new))
            return
        targets = []
        if isinstance(st, ast.Assign):
            targets = st.targets
        elif isinstance(st, (ast.AugAssign, ast.AnnAssign)):
            targets = [st.target]
        for t in targets:
            self._flag_write(t, st, held)
        if isinstance(st, ast.Expr) and isinstance(st.value, ast.Call):
            f = st.value.func
            if isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
                key = self._shared_write_key(f.value)
                if key is not None and not held:
                    self._unlocked(key, st)
        for child in ast.iter_child_nodes(st):
            if isinstance(child, ast.stmt):
                self.walk_stmt(child, held)
            elif hasattr(child, "body") and isinstance(
                    child, (ast.ExceptHandler,)):
                self.walk_block(child.body, held)

    def _flag_write(self, t, st, held):
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self._flag_write(e, st, held)
            return
        key = self._shared_write_key(t)
        if key is None:
            return
        self.shared_writes.add(key)
        if not held:
            self._unlocked(key, st)

    def _unlocked(self, key, st):
        self.rep.flag(
            "unlocked-thread-write", st,
            f"'{key}' is written inside a background thread with no lock "
            "held — racing every reader in the launching thread")

    def _scan_locked_block(self, stmts, out):
        for n in stmts:
            for t in ([*n.targets] if isinstance(n, ast.Assign)
                      else [n.target] if isinstance(n, (ast.AugAssign,
                                                        ast.AnnAssign))
                      else []):
                key = self._shared_write_key(t) if not isinstance(
                    t, (ast.Tuple, ast.List)) else None
                if key is not None:
                    out.append((key, n))
            if isinstance(n, ast.Expr) and isinstance(n.value, ast.Call):
                f = n.value.func
                if isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
                    key = self._shared_write_key(f.value)
                    if key is not None:
                        out.append((key, n))
            for child in ast.iter_child_nodes(n):
                if isinstance(child, ast.stmt):
                    self._scan_locked_block([child], out)
                elif isinstance(child, ast.ExceptHandler):
                    self._scan_locked_block(child.body, out)

    def _has_fence(self, stmts) -> bool:
        """A generation fence: an If comparing a plain name against
        shared state, whose body bails out (return/continue/raise)."""
        for n in stmts:
            if not isinstance(n, ast.If):
                continue
            cmp_ok = any(
                isinstance(c, ast.Compare)
                and any(isinstance(x, ast.Name)
                        for x in [c.left, *c.comparators])
                and any(isinstance(x, ast.Attribute)
                        for x in [c.left, *c.comparators])
                for c in ast.walk(n.test))
            bails = any(isinstance(x, (ast.Return, ast.Continue, ast.Raise))
                        for x in ast.walk(n))
            if cmp_ok and bails:
                return True
        return False


def _audit_guard_epochs(ctx: _ModuleCtx, fn, qual: str, rep: _Reporter):
    """The no-progress-guard class: a loop guard that raises on a mix of state sampled
    *before* the round's mutating call and state sampled after it."""
    for loop in ast.walk(fn):
        if not isinstance(loop, (ast.While, ast.For)):
            continue
        seq = loop.body
        assigned_at: dict[str, int] = {}
        mut_at: list[int] = []
        for i, st in enumerate(seq):
            if isinstance(st, ast.Expr) and isinstance(st.value, ast.Call):
                f = st.value.func
                if isinstance(f, ast.Attribute):
                    root = f.value
                    while isinstance(root, (ast.Attribute, ast.Subscript)):
                        root = root.value
                    if isinstance(root, ast.Name) and (
                            root.id == "self" or root.id in assigned_at):
                        mut_at.append(i)
            if isinstance(st, ast.Assign):
                for t in st.targets:
                    if isinstance(t, ast.Name):
                        assigned_at[t.id] = i
            if not isinstance(st, ast.If):
                continue
            if not any(isinstance(x, ast.Raise) for x in ast.walk(st)):
                continue
            muts_before = [m for m in mut_at if m < i]
            if not muts_before:
                continue
            last_mut = muts_before[-1]
            test = st.test
            conjuncts = (test.values if isinstance(test, ast.BoolOp)
                         and isinstance(test.op, ast.And) else [test])
            stale, fresh = [], False
            for c in conjuncts:
                names = {n.id for n in ast.walk(c)
                         if isinstance(n, ast.Name)
                         and not self_attr_root(n, c)}
                attrs = any(isinstance(n, ast.Attribute)
                            for n in ast.walk(c))
                stale_names = {n for n in names
                               if n in assigned_at
                               and assigned_at[n] < last_mut}
                fresh_names = {n for n in names
                               if n in assigned_at
                               and assigned_at[n] > last_mut}
                if attrs or fresh_names:
                    fresh = True
                    continue  # delta compares (before vs after) count fresh
                if stale_names:
                    stale.append((c, sorted(stale_names)))
            if stale and fresh:
                c, names = stale[0]
                mut_line = seq[last_mut].lineno
                rep.flag(
                    "guard-epoch-mix", st,
                    f"loop guard raises on {'/'.join(names)!s} sampled "
                    f"before the round's mutating call at line {mut_line}, "
                    "mixed with state sampled after it — the "
                    "no-progress-guard race; sample every conjunct after "
                    "the round")


def self_attr_root(name_node, within):
    """True if ``name_node`` is the root of an Attribute chain (so it is
    the receiver, e.g. ``self`` in ``self.shared``, not a value read)."""
    for n in ast.walk(within):
        if isinstance(n, ast.Attribute) and n.value is name_node:
            return True
    return False


def _audit_locks(ctx: _ModuleCtx, tree, out: list[Finding],
                 waived: list[str], edges: set[tuple[str, str]],
                 inventory: dict):
    n_locks = n_threads = 0

    def walk_edges(fn, qual, lock_keys, cls_qual):
        # Lexical lock-nesting edges for the acquisition-order graph,
        # plus bare acquire() discipline lint — over *every* method.
        rep = _Reporter(ctx, qual, out, waived)

        def rec(stmts, held):
            for st in stmts:
                if isinstance(st, ast.With):
                    new = list(held)
                    for item in st.items:
                        key = _key_of(item.context_expr)
                        if key in lock_keys:
                            full = f"{cls_qual}.{key.split('.', 1)[1]}"
                            if held:
                                edges.add((held[-1], full))
                            new.append(full)
                    rec(st.body, tuple(new))
                    continue
                for node in ast.walk(st):
                    if isinstance(node, ast.Call) \
                            and isinstance(node.func, ast.Attribute) \
                            and node.func.attr in ("acquire", "release") \
                            and _key_of(node.func.value) in lock_keys:
                        rep.flag(
                            "bare-acquire", node,
                            f"bare .{node.func.attr}() on a lock — use a "
                            "with-block so the discipline is statically "
                            "checkable (and exception-safe)",
                            severity=Severity.WARN)
                for child in ast.iter_child_nodes(st):
                    if isinstance(child, ast.stmt):
                        rec([child], held)
                    elif isinstance(child, ast.ExceptHandler):
                        rec(child.body, held)

        rec(fn.body, ())

    def visit(node, prefix):
        nonlocal n_locks, n_threads
        for child in node.body if hasattr(node, "body") else ():
            if isinstance(child, ast.ClassDef):
                cl = _collect_class_locks(child, prefix)
                n_locks += len(cl.locks)
                n_threads += len(cl.thread_targets)
                lock_keys = {f"self.{a}" for a in cl.locks}
                for m in child.body:
                    if isinstance(m, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                        qual = f"{cl.qual}.{m.name}"
                        walk_edges(m, qual, lock_keys, cl.qual)
                        rep = _Reporter(ctx, qual, out, waived)
                        _audit_guard_epochs(ctx, m, qual, rep)
                for tname, tfn in cl.thread_targets.items():
                    qual = f"{cl.qual}.{tname}"
                    rep = _Reporter(ctx, qual, out, waived)
                    lw = _LockWalk(ctx, cl, tfn, qual, rep)
                    lw.run()
                    _check_cross_thread(ctx, child, cl, lw, out, waived)
                visit(child, cl.qual)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}.{child.name}" if prefix else child.name
                rep = _Reporter(ctx, qual, out, waived)
                _audit_guard_epochs(ctx, child, qual, rep)

    visit(tree, "")
    inventory["locks"] = inventory.get("locks", 0) + n_locks
    inventory["threads"] = inventory.get("threads", 0) + n_threads


def _check_cross_thread(ctx, cls, cl, lw: _LockWalk, out, waived):
    """Attributes written by the thread target AND, un-locked, by other
    methods of the class: both sides of the race must hold the lock."""
    thread_attrs = {k for k in lw.shared_writes if k.startswith("self.")}
    if not thread_attrs:
        return
    target_names = {getattr(fn, "name", "") for fn in
                    cl.thread_targets.values()}
    for m in cls.body:
        if not isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if m.name in target_names:
            continue
        # Constructors run before any thread of this object can exist.
        if m.name in ("__init__", "__post_init__"):
            continue
        qual = f"{cl.qual}.{m.name}"
        rep = _Reporter(ctx, qual, out, waived)

        def rec(stmts, held, m=m, rep=rep):
            for st in stmts:
                if isinstance(st, ast.With):
                    new = held or any(
                        _key_of(item.context_expr) is not None
                        and _key_of(item.context_expr).startswith("self.")
                        and _key_of(item.context_expr).split(".")[1]
                        in cl.locks
                        for item in st.items)
                    rec(st.body, new)
                    continue
                targets = ([*st.targets] if isinstance(st, ast.Assign)
                           else [st.target]
                           if isinstance(st, (ast.AugAssign, ast.AnnAssign))
                           else [])
                flat = []
                for t in targets:
                    flat.extend(t.elts if isinstance(t, (ast.Tuple,
                                                         ast.List)) else [t])
                for t in flat:
                    node = t.value if isinstance(t, ast.Subscript) else t
                    key = _key_of(node)
                    if key in thread_attrs and not held:
                        rep.flag(
                            "unlocked-shared-write", st,
                            f"'{key}' is written by thread target "
                            f"'{cl.qual}' and here without the lock — "
                            "both sides of a cross-thread write must "
                            "synchronize")
                for child in ast.iter_child_nodes(st):
                    if isinstance(child, ast.stmt):
                        rec([child], held)
                    elif isinstance(child, ast.ExceptHandler):
                        rec(child.body, held)

        rec(m.body, False)


def _cycle(edges: set[tuple[str, str]]) -> list[str] | None:
    graph: dict[str, set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    seen: dict[str, int] = {}  # 1 = in stack, 2 = done

    def dfs(n, path):
        seen[n] = 1
        for m in graph.get(n, ()):
            if seen.get(m) == 1:
                return path[path.index(n):] + [m] if n in path else [n, m]
            if seen.get(m) is None:
                got = dfs(m, path + [m])
                if got:
                    return got
        seen[n] = 2
        return None

    for n in list(graph):
        if seen.get(n) is None:
            got = dfs(n, [n])
            if got:
                return got
    return None


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def run_on_sources(sources: dict[str, str]) -> list[Finding]:
    """Audit a {repo-path: source-text} mapping (real tree or fixtures)."""
    out: list[Finding] = []
    waived: list[str] = []
    edges: set[tuple[str, str]] = set()
    inventory: dict = {}
    retry = {"wrappers": 0, "handlers": 0, "guarded": 0, "exempt": set(), "flags": set()}
    threads = {"threads": 0, "params": 0, "immutable": 0, "copies": 0}
    for rel, src in sources.items():
        try:
            tree = ast.parse(src)
        except SyntaxError as e:
            out.append(error(PASS, f"{rel}:<module>",
                             f"[parse] source does not parse: {e}"))
            continue
        ctx = _ModuleCtx(rel, src)
        n_before = len(out)
        _audit_retry(ctx, tree, out, waived, retry)
        retry_errs = sum(1 for f in out[n_before:] if f.severity >= Severity.ERROR)
        retry["violations"] = retry.get("violations", 0) + retry_errs
        n_before = len(out)
        _audit_thread_args(ctx, tree, out, waived, threads)
        thread_errs = sum(1 for f in out[n_before:] if f.severity >= Severity.ERROR)
        threads["violations"] = threads.get("violations", 0) + thread_errs
        _audit_locks(ctx, tree, out, waived, edges, inventory)

    cyc = _cycle(edges)
    if cyc:
        out.append(error(
            PASS, "src/repro_torch/analysis/hostsafety.py:lock-order",
            f"[lock-cycle] lock acquisition order has a cycle: "
            f"{' -> '.join(cyc)} — two threads taking these in opposite "
            "order deadlock"))
    exempt = sorted(retry["exempt"])
    out.append(info(
        PASS, "src/repro_torch/analysis/hostsafety.py:retry-after-start",
        f"{retry['wrappers']} dispatch wrapper(s), start flag "
        f"{'/'.join(sorted(retry['flags'])) or '(none)'}; {retry['handlers']} except "
        f"path(s) looping back to the dispatched function: {retry['guarded']} read the "
        f"flag under the gate's lock and raise when it is set, the rest catch only "
        f"exceptions raised before it is set ({', '.join(exempt) or 'none'}); "
        f"{retry.get('violations', 0)} violations",
        wrappers=retry["wrappers"], handlers=retry["handlers"],
        guarded=retry["guarded"], violations=retry.get("violations", 0)))
    out.append(info(
        PASS, "src/repro_torch/analysis/hostsafety.py:thread-args",
        f"{threads['threads']} thread launch(es); {threads['copies']} host cop"
        f"{'y' if threads['copies'] == 1 else 'ies'} handed over, {threads['params']} "
        f"parameter(s) handed over as they are ({threads['immutable']} immutable by "
        f"annotation); {threads.get('violations', 0)} violations",
        threads=threads["threads"], copies=threads["copies"], params=threads["params"],
        violations=threads.get("violations", 0)))
    out.append(info(
        PASS, "src/repro_torch/analysis/hostsafety.py:lock-discipline",
        f"{inventory.get('locks', 0)} locks, "
        f"{inventory.get('threads', 0)} thread targets inventoried; "
        f"{len(edges)} nested acquisition edge(s), "
        f"{'CYCLE' if cyc else 'acyclic'}",
        locks=inventory.get("locks", 0),
        threads=inventory.get("threads", 0), edges=len(edges)))
    for w in waived:
        out.append(info(PASS,
                        "src/repro_torch/analysis/hostsafety.py:waivers",
                        f"waiver: {w}"))
    return out


def _read_tree_sources() -> dict[str, str]:
    sources = {}
    for rel in HOST_MODULES:
        p = _REPO / rel
        if p.exists():
            sources[rel] = p.read_text()
    return sources


def run(cfg=None) -> list[Finding]:
    """Audit the real tree.  ``cfg`` is ignored: host-tier safety is a
    property of the source, not of any model configuration."""
    del cfg
    return run_on_sources(_read_tree_sources())

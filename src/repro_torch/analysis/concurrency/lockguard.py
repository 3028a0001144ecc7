"""Lock-discipline linter: lockset analysis over the annotated shared state.

Counterpart of `repro.analysis.concurrency.lockguard`.  The threaded
executor (`sched/runtime.py`) and the telemetry recorder
(`obs/recorder.py`) both follow a single-lock discipline: every mutation
of shared state happens inside one ``with <lock>:`` block.  That
discipline is exactly the kind of invariant that silently rots -- a new
code path appends to ``state.events`` outside the lock and nothing fails
until a trace shows overlapping events on one worker.  This module makes
the discipline checked, three rules strong:

  guarded-by
      Attributes declared with a ``# repro: guarded-by=<lock>`` comment on
      their initialization line form the registry.  Any later mutation of
      a registered attribute -- plain/augmented/subscript assignment, a
      mutating method call (``.append``/``.clear``/...), or a ``heapq``
      operation on it -- must sit lexically inside a ``with`` block whose
      context expression's trailing name is the declared lock (a Condition
      constructed over the lock counts: ``with state.cond:`` guards
      ``guarded-by=cond`` attributes).  Exemptions: ``__init__`` /
      ``__post_init__`` bodies (construction happens-before publication)
      and functions named ``*_locked`` (contract: caller holds the lock).
      Calling a ``*_locked`` function outside the lock is itself a finding.

  cv-wait-loop
      Every condition-variable ``.wait()`` must sit inside a ``while``
      loop (re-check the predicate after wakeup: spurious wakeups and
      notify_all races are real).  An ``if``-guarded wait is a finding.

  lock-dispatch
      No work for the card while holding a registered lock: inside a
      ``with <registered lock>:`` block, or in the body of a ``*_locked``
      function (which runs under it), calls into ``torch.*``,
      ``kernels.run(...)``, the stream and event calls ``.synchronize()``,
      ``.record(...)``, ``.wait_event(...)`` and ``.record_stream(...)``,
      and the host syncs ``.item()``, ``.cpu()`` and ``.tolist()`` are
      findings.  An ATen call under the scheduler lock holds every other
      worker off the ready queue for its whole dispatch (and a sync for
      the device's whole queue); the executor enqueues outside the lock and
      publishes inside it.  This replaces the reference's JAX dispatch
      (``jnp``/``jax``/``lax``, ``.block_until_ready()``).

Findings reuse `analysis.lint`'s `Finding` type, per-line ``# repro:
disable=<rule> -- reason`` pragmas, and the committed baseline, so the
CLI gate (`python -m repro_torch.analysis --check --concurrency`) treats
them exactly like precision-flow findings.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from ..lint import Finding, pragma_lines, _suppressed

LOCKGUARD_RULES = ("guarded-by", "cv-wait-loop", "lock-dispatch")

#: files the lock discipline applies to (relative to src/)
LOCKGUARD_FILES = ("repro_torch/sched/runtime.py", "repro_torch/obs/recorder.py")

_GUARD_RE = re.compile(r"#\s*repro:\s*guarded-by=([A-Za-z_][A-Za-z0-9_]*)")

# method names that mutate their receiver in place
MUTATOR_METHODS = frozenset({
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "add", "discard", "update", "setdefault", "appendleft", "popleft",
    "sort", "reverse",
})
# module-level functions whose FIRST argument is mutated in place
ARG_MUTATORS = frozenset({"heappush", "heappop", "heapify", "heapreplace",
                          "heappushpop"})

DISPATCH_MODULES = frozenset({"torch"})
DISPATCH_METHODS = frozenset({
    "synchronize", "record", "wait_event", "record_stream",   # streams, events
    "item", "cpu", "tolist",                                   # host syncs
})


def _trailing_name(node: ast.AST) -> str | None:
    """`state.cond` -> "cond", `self._lock` -> "_lock", `cond` -> "cond"."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _root_name(node: ast.AST) -> str | None:
    """`torch.cuda.Event` -> "torch", `a.b.c` -> "a"."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def guarded_registry(source: str) -> dict[str, str]:
    """attr name -> lock name, from `# repro: guarded-by=<lock>` comments.

    The comment must sit on a line that assigns `<obj>.<attr>` (the
    declaration site, normally in __init__).
    """
    registry: dict[str, str] = {}
    guards = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _GUARD_RE.search(text)
        if m:
            guards[i] = m.group(1)
    if not guards:
        return registry
    tree = ast.parse(source)
    for node in ast.walk(tree):
        if not isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            continue
        lock = None
        for ln in range(node.lineno, (node.end_lineno or node.lineno) + 1):
            if ln in guards:
                lock = guards[ln]
                break
        if lock is None:
            continue
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for tgt in targets:
            if isinstance(tgt, ast.Attribute):
                registry[tgt.attr] = lock
    return registry


# ---------------------------------------------------------------------------
# the analysis
# ---------------------------------------------------------------------------

class _Analyzer:
    def __init__(self, source: str, relpath: str):
        self.relpath = relpath
        self.lines = source.splitlines()
        self.pragmas = pragma_lines(source)
        self.registry = guarded_registry(source)
        self.tree = ast.parse(source)
        self.findings: list[Finding] = []
        self.parents: dict[int, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[id(child)] = parent

    def flag(self, rule: str, node: ast.AST, msg: str) -> None:
        if _suppressed(self.pragmas, node, rule):
            return
        self.findings.append(Finding(
            rule, self.relpath, node.lineno, msg,
            self.lines[node.lineno - 1].strip()))

    # --- context helpers ---------------------------------------------------
    def _ancestors(self, node: ast.AST):
        cur = self.parents.get(id(node))
        while cur is not None:
            yield cur
            cur = self.parents.get(id(cur))

    def _held_locks(self, node: ast.AST) -> set[str]:
        """Trailing names of every `with`-context lock held at `node`."""
        held: set[str] = set()
        for anc in self._ancestors(node):
            if isinstance(anc, (ast.With, ast.AsyncWith)):
                for item in anc.items:
                    name = _trailing_name(item.context_expr)
                    if name:
                        held.add(name)
        return held

    def _enclosing_function(self, node: ast.AST):
        for anc in self._ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return None

    def _exempt_context(self, node: ast.AST) -> bool:
        fn = self._enclosing_function(node)
        return fn is not None and (
            fn.name in ("__init__", "__post_init__")
            or fn.name.endswith("_locked"))

    # --- mutation extraction ----------------------------------------------
    def _mutated_attr(self, node: ast.AST) -> tuple[str, ast.AST] | None:
        """Registered attribute this node mutates, or None.

        Recognizes `x.attr = v`, `x.attr += v`, `x.attr[k] = v`,
        `x.attr.append(v)` (and friends), and `heappush(x.attr, v)`.
        """
        def attr_of(tgt: ast.AST) -> str | None:
            if isinstance(tgt, ast.Subscript):
                tgt = tgt.value
            if isinstance(tgt, ast.Attribute) and tgt.attr in self.registry:
                return tgt.attr
            return None

        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for tgt in targets:
                a = attr_of(tgt)
                if a:
                    return a, node
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in MUTATOR_METHODS:
                a = attr_of(node.func.value)
                if a:
                    return a, node
            fname = _trailing_name(node.func)
            if fname in ARG_MUTATORS and node.args:
                a = attr_of(node.args[0])
                if a:
                    return a, node
        return None

    # --- rule passes -------------------------------------------------------
    def check_guarded_by(self) -> None:
        for node in ast.walk(self.tree):
            hit = self._mutated_attr(node)
            if hit is None:
                continue
            attr, site = hit
            if self._exempt_context(site):
                continue
            lock = self.registry[attr]
            if lock not in self._held_locks(site):
                self.flag(
                    "guarded-by", site,
                    f"mutation of {attr!r} outside `with {lock}:` "
                    f"(declared # repro: guarded-by={lock})")
        # *_locked helpers must themselves be called under a registered lock
        # (any lock where the file registers none); a stream context such
        # as `with torch.cuda.stream(s):` is not one
        locks = set(self.registry.values())
        locked_fns = {
            fn.name for fn in ast.walk(self.tree)
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
            and fn.name.endswith("_locked")}
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            fname = _trailing_name(node.func)
            if fname not in locked_fns:
                continue
            held = self._held_locks(node)
            if self._exempt_context(node) or (held & locks if locks else held):
                continue
            self.flag(
                "guarded-by", node,
                f"call of lock-held-contract helper {fname!r} outside any "
                "`with <lock>:` block")

    def check_cv_wait(self) -> None:
        for node in ast.walk(self.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("wait", "wait_for")):
                continue
            recv = _trailing_name(node.func.value) or ""
            if "cond" not in recv and recv not in self.registry.values():
                continue
            if node.func.attr == "wait_for":
                continue     # wait_for re-checks its predicate internally
            if not any(isinstance(a, ast.While) for a in self._ancestors(node)):
                self.flag(
                    "cv-wait-loop", node,
                    f"{recv}.wait() outside a while loop -- condition waits "
                    "must re-check their predicate after wakeup (spurious "
                    "wakeups, notify_all races)")

    def check_lock_dispatch(self) -> None:
        lock_names = set(self.registry.values())
        if not lock_names:
            return
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            held = self._held_locks(node) & lock_names
            fn = self._enclosing_function(node)
            if not held and fn is not None and fn.name.endswith("_locked"):
                held = lock_names            # runs under its caller's lock
            if not held:
                continue
            func = node.func
            is_dispatch = (
                _root_name(func) in DISPATCH_MODULES
                or (isinstance(func, ast.Attribute)
                    and func.attr in DISPATCH_METHODS)
                or (isinstance(func, ast.Attribute) and func.attr == "run"
                    and _trailing_name(func.value) == "kernels"))
            if is_dispatch:
                self.flag(
                    "lock-dispatch", node,
                    f"device work under the {sorted(held)[0]!r} lock -- "
                    "enqueue outside the lock, publish inside it")

    def run(self) -> list[Finding]:
        self.check_guarded_by()
        self.check_cv_wait()
        self.check_lock_dispatch()
        return self.findings


def lockguard_source(source: str, relpath: str) -> list[Finding]:
    """Lint one module's source text against the three lockset rules."""
    return _Analyzer(source, relpath).run()


def lockguard_files(src_root: Path, files=LOCKGUARD_FILES) -> list[Finding]:
    """Lint the registered concurrency-critical modules under src_root
    (the .../src/repro_torch directory)."""
    src_root = Path(src_root)
    findings: list[Finding] = []
    for rel in files:
        path = src_root.parent / rel
        if not path.exists():
            findings.append(Finding(
                "guarded-by", rel, 1,
                "registered lockguard file is missing", ""))
            continue
        findings.extend(lockguard_source(path.read_text(), rel))
    return findings

"""Concurrency model shared by the threadlint rules (R101–R105).

The serving/resilience core coordinates eight threaded modules through
locks, conditions, futures, and claim protocols — discipline that PR 9's
review showed is easy to break and expensive to re-derive by hand. This
module gives the rules a semantic model of that discipline, in the same
flow-light spirit as :mod:`waternet_tpu_torch.analysis.core`: prefer missing a
hazard to crying wolf, because tier-1 pins the tree at zero unsuppressed
findings.

Annotation convention (the JAX package's docs/LINT.md, "Concurrency rules"):

* ``# guarded-by: self._lock`` on an attribute's declaring assignment
  (normally in ``__init__``) declares that every later write to the
  attribute must hold that lock (R101 enforces it).
* ``# guarded-by: self._lock`` on a ``def`` line declares a helper whose
  CALLERS hold the lock for the whole call — its body counts as locked
  (the ``_retire_generation``-style "caller holds the pool lock" idiom).
* Module-level globals declare the same way against module-level locks
  (``# guarded-by: _SERVE_LOCK`` in resilience/faults.py).

Lock identity is the *declaration site*: ``self._lock`` in class ``C`` of
module ``m`` is one lock for every instance of ``C`` — exactly the
granularity lock-ORDER discipline is defined at. A ``threading.Condition``
built from a known lock aliases to that lock (holding the condition IS
holding the lock).

:func:`build_lock_graph` merges per-module acquisition sites (nested
``with`` blocks, ``.acquire()`` calls, and calls made while holding a
lock, resolved through a repo-wide may-acquire fixpoint) into one static
graph; R102 flags its cycles and the CLI's ``--lock-graph`` renders it as
DOT.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from pathlib import Path
from typing import Dict, Iterator, List, NamedTuple, Optional, Set, Tuple

from waternet_tpu_torch.analysis.core import (
    ModuleModel,
    ancestors,
    enclosing_class,
    ref_key,
)

#: Factory callables whose result is a lock-like synchronization object.
LOCK_FACTORIES = {
    "threading.Lock": "lock",
    "threading.RLock": "rlock",
    "threading.Semaphore": "semaphore",
    "threading.BoundedSemaphore": "semaphore",
    "threading.Condition": "condition",
    "asyncio.Lock": "lock",
    "asyncio.Condition": "condition",
}

#: Factory callables that make a class "thread-bearing": its instances
#: run code on more than one thread, so its shared attributes need a
#: declared guard (R101).
THREAD_SPAWNERS = {
    "threading.Thread",
    "concurrent.futures.ThreadPoolExecutor",
}

#: Mutable-container initializers tracked for the undeclared-mutation arm
#: of R101 (queue.Queue is deliberately absent: it locks internally).
_MUTABLE_FACTORIES = {
    "dict", "list", "set", "collections.deque", "collections.defaultdict",
    "collections.OrderedDict", "collections.Counter",
}
_MUTATOR_METHODS = {
    "append", "extend", "add", "update", "insert", "remove", "discard",
    "pop", "popitem", "clear", "setdefault", "appendleft", "popleft",
}

_GUARD_RE = re.compile(r"guarded-by:\s*(?P<lock>[A-Za-z_][A-Za-z0-9_.]*)")

_FUNCTION_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
_WITH_NODES = (ast.With, ast.AsyncWith)


class LockKey(NamedTuple):
    """Identity of one lock: its declaration site (module, class, name).

    ``cls`` is ``""`` for module-level locks. ``display`` is the short
    human name used in findings and DOT output."""

    path: str
    cls: str
    name: str

    @property
    def display(self) -> str:
        stem = Path(self.path).stem
        owner = f"{stem}.{self.cls}" if self.cls else stem
        return f"{owner}.{self.name}"


def guard_comments(source: str) -> Dict[int, str]:
    """``{line: lock-expression-text}`` from ``# guarded-by: <expr>``
    comments (tokenize-based, like suppression parsing, so a ``#`` inside
    a string never counts)."""
    out: Dict[int, str] = {}
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return out
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _GUARD_RE.search(tok.string)
        if m:
            out[tok.start[0]] = m.group("lock")
    return out


class ClassInfo:
    """Per-class concurrency facts: locks it owns, guard declarations,
    mutable shared containers, and whether it bears threads."""

    def __init__(self, node: ast.ClassDef):
        self.node = node
        self.name = node.name
        self.locks: Dict[str, str] = {}  # attr -> kind
        self.cond_locks: Dict[str, LockKey] = {}  # condition attr -> lock
        self.guarded: Dict[str, LockKey] = {}  # attr -> declared lock
        self.guard_text: Dict[str, str] = {}  # attr -> declaration text
        self.mutable_attrs: Set[str] = set()
        self.thread_bearing = False
        self.spawn_reason: Optional[str] = None


class ConcurrencyModel:
    """Concurrency view of one :class:`ModuleModel` (pure AST)."""

    def __init__(self, model: ModuleModel):
        self.model = model
        self.guards = guard_comments(model.source)
        self.classes: Dict[ast.ClassDef, ClassInfo] = {}
        self.module_locks: Dict[str, str] = {}  # name -> kind
        self.module_cond_locks: Dict[str, LockKey] = {}
        self.module_guarded: Dict[str, LockKey] = {}
        self.module_guard_text: Dict[str, str] = {}
        self.fn_requires: Dict[ast.AST, Set[LockKey]] = {}
        self._collect_locks()
        self._collect_guards()

    # -- collection ------------------------------------------------------

    def _lock_kind(self, value: ast.AST) -> Optional[str]:
        if isinstance(value, ast.Call):
            return LOCK_FACTORIES.get(self.model.resolve(value.func) or "")
        return None

    def _collect_locks(self) -> None:
        tree = self.model.tree
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                self.classes[node] = ClassInfo(node)
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [node.target]
            else:
                continue
            kind = self._lock_kind(node.value)
            cls = enclosing_class(node)
            info = self.classes.get(cls) if cls is not None else None
            for target in targets:
                key = ref_key(target)
                if key is None:
                    continue
                if key[0] == "self" and info is not None:
                    if kind is not None:
                        info.locks[key[1]] = kind
                        if kind == "condition":
                            under = self._condition_underlying(node.value, cls)
                            if under is not None:
                                info.cond_locks[key[1]] = under
                    elif self._is_mutable_init(node.value):
                        info.mutable_attrs.add(key[1])
                elif key[0] == "local" and cls is None and kind is not None:
                    # module-level lock (only at module scope)
                    scope = next(
                        (a for a in ancestors(node)
                         if isinstance(a, _FUNCTION_NODES + (ast.Module,))),
                        None,
                    )
                    if isinstance(scope, ast.Module):
                        self.module_locks[key[1]] = kind
                        if kind == "condition":
                            under = self._condition_underlying(node.value, None)
                            if under is not None:
                                self.module_cond_locks[key[1]] = under
        # thread-bearing: a class whose body constructs threads/executors
        # or registers cross-thread future callbacks.
        for cls, info in self.classes.items():
            for node in ast.walk(cls):
                if enclosing_class(node) is not cls:
                    continue
                if isinstance(node, ast.Call):
                    resolved = self.model.resolve(node.func)
                    if resolved in THREAD_SPAWNERS:
                        info.thread_bearing = True
                        info.spawn_reason = resolved
                        break
                    if (
                        isinstance(node.func, ast.Attribute)
                        and node.func.attr == "add_done_callback"
                    ):
                        info.thread_bearing = True
                        info.spawn_reason = "add_done_callback"
                        break

    def _condition_underlying(
        self, value: ast.Call, cls: Optional[ast.ClassDef]
    ) -> Optional[LockKey]:
        """The lock a ``threading.Condition(<lock>)`` wraps, if named."""
        if not value.args:
            return None
        return self._resolve_lock_parts(value.args[0], cls)

    def _is_mutable_init(self, value: ast.AST) -> bool:
        if isinstance(value, (ast.Dict, ast.List, ast.Set, ast.DictComp,
                              ast.ListComp, ast.SetComp)):
            return True
        if isinstance(value, ast.Call):
            return (self.model.resolve(value.func) or "") in _MUTABLE_FACTORIES
        return False

    def _collect_guards(self) -> None:
        if not self.guards:
            return
        for node in ast.walk(self.model.tree):
            lines = range(
                getattr(node, "lineno", 0),
                (getattr(node, "end_lineno", 0) or 0) + 1,
            )
            text = next(
                (self.guards[ln] for ln in lines if ln in self.guards), None
            )
            if text is None:
                continue
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a def-line guard means: callers hold this lock for the
                # whole call — the body counts as locked.
                if node.lineno in self.guards:
                    key = self._resolve_lock_text(text, enclosing_class(node))
                    if key is not None:
                        self.fn_requires.setdefault(node, set()).add(key)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target]
                )
                cls = enclosing_class(node)
                key = self._resolve_lock_text(text, cls)
                if key is None:
                    continue
                for target in targets:
                    tk = ref_key(target)
                    if tk is None:
                        continue
                    if tk[0] == "self" and cls is not None:
                        info = self.classes[cls]
                        info.guarded[tk[1]] = key
                        info.guard_text[tk[1]] = text
                    elif tk[0] == "local" and cls is None:
                        self.module_guarded[tk[1]] = key
                        self.module_guard_text[tk[1]] = text

    # -- lock resolution -------------------------------------------------

    def _class_lock_names(self, info: ClassInfo) -> Set[str]:
        """Attrs of a class that name a lock: constructed locks plus any
        lock named in a guard declaration (a lock built by a helper
        factory still counts once something declares against it)."""
        names = set(info.locks)
        for key in info.guarded.values():
            if key.cls == info.name and key.path == self.model.path:
                names.add(key.name)
        return names

    def _resolve_lock_parts(
        self, expr: ast.AST, cls: Optional[ast.ClassDef]
    ) -> Optional[LockKey]:
        """``self.X`` / bare ``X`` -> LockKey, honoring condition->lock
        aliasing. None for anything not statically known to be a lock."""
        path = self.model.path
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and cls is not None
        ):
            info = self.classes.get(cls)
            if info is None:
                return None
            attr = expr.attr
            if attr in info.cond_locks:
                return info.cond_locks[attr]
            if attr in self._class_lock_names(info):
                return LockKey(path, info.name, attr)
            return None
        if isinstance(expr, ast.Name):
            name = expr.id
            if name in self.module_cond_locks:
                return self.module_cond_locks[name]
            if name in self.module_locks or name in {
                k.name for k in self.module_guarded.values() if not k.cls
            }:
                return LockKey(path, "", name)
        return None

    def _resolve_lock_text(
        self, text: str, cls: Optional[ast.ClassDef]
    ) -> Optional[LockKey]:
        try:
            expr = ast.parse(text, mode="eval").body
        except SyntaxError:
            return None
        # a declaration DEFINES the lock name — resolve leniently.
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and cls is not None
        ):
            info = self.classes.get(cls)
            if info is not None and expr.attr in info.cond_locks:
                return info.cond_locks[expr.attr]
            return LockKey(self.model.path, cls.name, expr.attr)
        if isinstance(expr, ast.Name):
            if expr.id in self.module_cond_locks:
                return self.module_cond_locks[expr.id]
            return LockKey(self.model.path, "", expr.id)
        return None

    def lock_key_of_expr(self, expr: ast.AST) -> Optional[LockKey]:
        return self._resolve_lock_parts(expr, enclosing_class(expr))

    # -- held-lock computation -------------------------------------------

    def held_locks(self, node: ast.AST) -> Set[LockKey]:
        """Locks lexically held at ``node``: enclosing ``with`` blocks on
        known locks, plus a def-line guard on the enclosing function.
        Stops at the function boundary — a closure defined under a lock
        does not RUN under it."""
        held: Set[LockKey] = set()
        child = node
        for anc in ancestors(node):
            if isinstance(anc, _WITH_NODES) and child in anc.body:
                for item in anc.items:
                    key = self.lock_key_of_expr(item.context_expr)
                    if key is not None:
                        held.add(key)
            elif isinstance(anc, _FUNCTION_NODES):
                held |= self.fn_requires.get(anc, set())
                break
            child = anc
        return held

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        for anc in ancestors(node):
            if isinstance(anc, _FUNCTION_NODES):
                return anc
        return None

    # -- acquisition + call events (R102 feedstock) ----------------------

    def acquisition_events(self) -> Iterator[Tuple[ast.AST, LockKey, Set[LockKey]]]:
        """Yield ``(site, acquired, held_before)`` for every static
        acquisition: ``with`` items (multi-item withs acquire left to
        right) and explicit ``.acquire()`` calls on resolvable locks."""
        for node in ast.walk(self.model.tree):
            if isinstance(node, _WITH_NODES):
                held = self.held_locks(node)
                acquired_here: Set[LockKey] = set()
                for item in node.items:
                    key = self.lock_key_of_expr(item.context_expr)
                    if key is None:
                        continue
                    yield item.context_expr, key, held | acquired_here
                    acquired_here.add(key)
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "acquire"
            ):
                key = self.lock_key_of_expr(node.func.value)
                if key is not None:
                    yield node, key, self.held_locks(node)

    def call_events(self) -> Iterator[Tuple[ast.Call, tuple, Set[LockKey]]]:
        """Yield ``(call, descriptor, held)`` for calls the project pass
        may resolve to repo functions. Descriptors:
        ``("self_method", ClassDef, name)``, ``("module_fn", name)``,
        ``("method_name", name)`` (resolved only if repo-unique)."""
        for node in ast.walk(self.model.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = self.enclosing_function(node)
            if fn is None:
                continue
            held = self.held_locks(node)
            f = node.func
            if isinstance(f, ast.Attribute):
                if (
                    isinstance(f.value, ast.Name)
                    and f.value.id == "self"
                    and enclosing_class(node) is not None
                ):
                    yield node, ("self_method", enclosing_class(node), f.attr), held
                else:
                    yield node, ("method_name", f.attr), held
            elif isinstance(f, ast.Name):
                yield node, ("module_fn", f.id), held


# ---------------------------------------------------------------------------
# Whole-repo static lock-acquisition graph (R102 / --lock-graph)
# ---------------------------------------------------------------------------


class LockGraph:
    """Directed graph over :class:`LockKey`s: an edge A -> B means some
    code path acquires B while holding A. ``sites[(A, B)]`` names one
    witness per edge."""

    def __init__(self):
        self.edges: Dict[LockKey, Set[LockKey]] = {}
        self.sites: Dict[Tuple[LockKey, LockKey], Tuple[str, int]] = {}

    def add(self, a: LockKey, b: LockKey, path: str, line: int) -> None:
        if a == b:
            return  # reentrancy is R103/R101 territory, not ordering
        self.edges.setdefault(a, set()).add(b)
        self.edges.setdefault(b, set())
        self.sites.setdefault((a, b), (path, line))

    def cycles(self) -> List[List[LockKey]]:
        """One simple cycle per strongly connected component with > 1
        node (iterative Tarjan; deterministic order)."""
        index: Dict[LockKey, int] = {}
        low: Dict[LockKey, int] = {}
        on_stack: Set[LockKey] = set()
        stack: List[LockKey] = []
        sccs: List[List[LockKey]] = []
        counter = [0]

        for root in sorted(self.edges):
            if root in index:
                continue
            work = [(root, iter(sorted(self.edges.get(root, ()))))]
            index[root] = low[root] = counter[0]
            counter[0] += 1
            stack.append(root)
            on_stack.add(root)
            while work:
                node, it = work[-1]
                advanced = False
                for nxt in it:
                    if nxt not in index:
                        index[nxt] = low[nxt] = counter[0]
                        counter[0] += 1
                        stack.append(nxt)
                        on_stack.add(nxt)
                        work.append(
                            (nxt, iter(sorted(self.edges.get(nxt, ()))))
                        )
                        advanced = True
                        break
                    if nxt in on_stack:
                        low[node] = min(low[node], index[nxt])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index[node]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        comp.append(w)
                        if w == node:
                            break
                    if len(comp) > 1:
                        sccs.append(sorted(comp))
        return [self._cycle_in(scc) for scc in sccs]

    def _cycle_in(self, scc: List[LockKey]) -> List[LockKey]:
        """A concrete simple cycle inside one SCC, for the finding."""
        members = set(scc)
        start = scc[0]
        path = [start]
        seen = {start}
        node = start
        while True:
            nxt = next(
                n for n in sorted(self.edges.get(node, ()))
                if n in members
            )
            if nxt == start:
                return path
            if nxt in seen:
                i = path.index(nxt)
                return path[i:]
            path.append(nxt)
            seen.add(nxt)
            node = nxt

    def to_dot(self) -> str:
        lines = [
            "digraph lock_order {",
            "  rankdir=LR;",
            '  node [shape=box, fontname="monospace"];',
        ]
        nodes = sorted(self.edges)
        for n in nodes:
            lines.append(f'  "{n.display}";')
        for a in nodes:
            for b in sorted(self.edges[a]):
                path, line = self.sites[(a, b)]
                label = f"{Path(path).name}:{line}"
                lines.append(
                    f'  "{a.display}" -> "{b.display}" [label="{label}"];'
                )
        lines.append("}")
        return "\n".join(lines)


def build_lock_graph(models) -> LockGraph:
    """The static lock-acquisition graph over a set of modules.

    Direct edges come from nested ``with``/``acquire`` sites; indirect
    edges from calls made while holding a lock, through a repo-wide
    may-acquire fixpoint (``self.m()`` resolves in-class, ``f()``
    in-module, and ``obj.m()`` only when the method name is unique across
    every scanned class — ambiguity resolves to nothing, by design)."""
    cms = [ConcurrencyModel(m) for m in models]
    graph = LockGraph()

    # function tables ----------------------------------------------------
    method_index: Dict[str, List[ast.AST]] = {}
    fn_direct: Dict[ast.AST, Set[LockKey]] = {}
    fn_calls: Dict[ast.AST, List[tuple]] = {}
    module_fns: Dict[int, Dict[str, ast.AST]] = {}

    for cm in cms:
        tree = cm.model.tree
        fns_by_name: Dict[str, ast.AST] = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fn_direct.setdefault(node, set())
                fn_calls.setdefault(node, [])
                cls = enclosing_class(node)
                if cls is not None:
                    method_index.setdefault(node.name, []).append(node)
                else:
                    fns_by_name.setdefault(node.name, node)
        module_fns[id(cm)] = fns_by_name

    for cm in cms:
        for site, key, held in cm.acquisition_events():
            fn = cm.enclosing_function(site)
            if fn is not None and fn in fn_direct:
                fn_direct[fn].add(key)
            for h in held:
                graph.add(h, key, cm.model.path, getattr(site, "lineno", 0))
        class_methods: Dict[ast.ClassDef, Dict[str, ast.AST]] = {}
        for call, desc, held in cm.call_events():
            fn = cm.enclosing_function(call)
            if fn is None or fn not in fn_calls:
                continue
            target: Optional[ast.AST] = None
            if desc[0] == "self_method":
                _, cls, name = desc
                if cls not in class_methods:
                    class_methods[cls] = {
                        n.name: n
                        for n in ast.walk(cls)
                        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and enclosing_class(n) is cls
                    }
                target = class_methods[cls].get(name)
            elif desc[0] == "module_fn":
                target = module_fns[id(cm)].get(desc[1])
            elif desc[0] == "method_name":
                candidates = method_index.get(desc[1], [])
                if len(candidates) == 1:
                    target = candidates[0]
            if target is not None:
                fn_calls[fn].append((call, target, held, cm.model.path))

    # may-acquire fixpoint ----------------------------------------------
    may: Dict[ast.AST, Set[LockKey]] = {
        fn: set(direct) for fn, direct in fn_direct.items()
    }
    changed = True
    while changed:
        changed = False
        for fn, calls in fn_calls.items():
            acc = may[fn]
            before = len(acc)
            for _, target, _, _ in calls:
                acc |= may.get(target, set())
            if len(acc) != before:
                changed = True

    # call-propagated edges ---------------------------------------------
    for fn, calls in fn_calls.items():
        for call, target, held, path in calls:
            if not held:
                continue
            for h in held:
                for k in may.get(target, ()):
                    graph.add(h, k, path, getattr(call, "lineno", 0))
    return graph

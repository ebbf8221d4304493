"""R101–R105 — the threadlint concurrency rule family (the JAX package's
docs/LINT.md).

Five rules over the :mod:`waternet_tpu_torch.analysis.concurrency` model:

* **R101 unguarded-shared-mutation** — a write to an attribute declared
  ``# guarded-by: <lock>`` outside a ``with`` on that lock, or an
  undeclared read-modify-write / container mutation of shared state in a
  thread-bearing class with no lock held.
* **R102 lock-order-inversion** — a cycle in the whole-repo static
  lock-acquisition graph (project-scope: it sees every scanned module).
* **R103 blocking-call-under-lock** — ``Future.result()``,
  ``Thread.join()``, ``queue.get()``, host syncs (``torch.cuda.
  synchronize()``, ``Event``/``Stream.synchronize()``, ``.item()``/
  ``.cpu()``/``.tolist()``/``.numpy()`` of a device tensor), and
  ``sleep`` inside a held lock: every contending thread stalls for the
  blocked one.
* **R104 condition-wait-without-predicate** — ``Condition.wait()`` whose
  predicate is not re-checked in a ``while`` loop (spurious/missed
  wakeups are part of the condition contract).
* **R105 unjoined-thread** — a non-daemon ``Thread`` started with no
  ``join``, later ``daemon`` set, or leak-guard registration in sight.

Same precision-first stance as R001–R005: unresolvable receivers are
skipped, not guessed, because tier-1 pins the tree at zero unsuppressed
findings and a noisy rule would be suppressed into uselessness.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Set

from waternet_tpu_torch.analysis.concurrency import (
    ConcurrencyModel,
    LockKey,
    _MUTATOR_METHODS,
    build_lock_graph,
)
from waternet_tpu_torch.analysis.core import (
    DEVICE,
    Finding,
    ModuleModel,
    ancestors,
    enclosing_class,
    flatten_targets,
    ref_key,
    tensor_kind,
)
from waternet_tpu_torch.analysis.registry import Rule, register


def _nearest_function(node: ast.AST):
    for anc in ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return anc
    return None


def _in_init_of(node: ast.AST, cls: ast.ClassDef) -> bool:
    """True when the nearest enclosing function is ``cls.__init__`` —
    construction happens-before any thread the object spawns, so
    declaring writes there are exempt."""
    fn = _nearest_function(node)
    return (
        isinstance(fn, ast.FunctionDef)
        and fn.name == "__init__"
        and enclosing_class(fn) is cls
    )


def _self_attr_base(node: ast.AST) -> Optional[str]:
    """``self.X`` -> ``X`` (exactly one attribute deep), else None."""
    key = ref_key(node)
    return key[1] if key is not None and key[0] == "self" else None


@register
class UnguardedSharedMutation(Rule):
    id = "R101"
    name = "unguarded-shared-mutation"
    description = (
        "a `# guarded-by:` declared attribute is written outside its "
        "lock, or shared mutable state in a thread-bearing class is "
        "mutated with no lock held and no declaration"
    )

    def check(self, model: ModuleModel) -> Iterator[Finding]:
        cm = ConcurrencyModel(model)
        yield from self._check_classes(model, cm)
        yield from self._check_module_globals(model, cm)

    # -- class attributes -----------------------------------------------

    def _mutations(self, cm: ConcurrencyModel):
        """Yield ``(node, attr, how)`` for every self-attribute mutation:
        how in {"write", "augmented write", "item write", "mutating
        call"}."""
        for node in ast.walk(cm.model.tree):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for t in targets:
                    for leaf in flatten_targets(t):
                        attr = _self_attr_base(leaf)
                        if attr is not None:
                            yield node, attr, "write"
                        elif isinstance(leaf, ast.Subscript):
                            attr = _self_attr_base(leaf.value)
                            if attr is not None:
                                yield node, attr, "item write"
            elif isinstance(node, ast.AugAssign):
                attr = _self_attr_base(node.target)
                if attr is not None:
                    yield node, attr, "augmented write"
                elif isinstance(node.target, ast.Subscript):
                    attr = _self_attr_base(node.target.value)
                    if attr is not None:
                        yield node, attr, "item write"
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    if isinstance(t, ast.Subscript):
                        attr = _self_attr_base(t.value)
                        if attr is not None:
                            yield node, attr, "item write"
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _MUTATOR_METHODS
            ):
                attr = _self_attr_base(node.func.value)
                if attr is not None:
                    yield node, attr, "mutating call"

    def _check_classes(
        self, model: ModuleModel, cm: ConcurrencyModel
    ) -> Iterator[Finding]:
        for node, attr, how in self._mutations(cm):
            cls = enclosing_class(node)
            info = cm.classes.get(cls) if cls is not None else None
            if info is None or _in_init_of(node, cls):
                continue
            held = cm.held_locks(node)
            if attr in info.guarded:
                want = info.guarded[attr]
                if want not in held:
                    yield self.finding(
                        model,
                        node,
                        f"self.{attr} is declared `# guarded-by: "
                        f"{info.guard_text[attr]}` but this {how} does not "
                        f"hold {want.display}; wrap it in `with "
                        f"{info.guard_text[attr]}:` (or mark the enclosing "
                        f"def `# guarded-by: {info.guard_text[attr]}` if "
                        "callers hold it)",
                    )
                continue
            if not info.thread_bearing or attr in info.locks:
                continue
            # Undeclared shared mutation: read-modify-writes always count;
            # item writes / mutating calls only on known mutable containers
            # (a queue.Queue attr locks internally and stays exempt).
            if how == "augmented write" or (
                how in ("item write", "mutating call")
                and attr in info.mutable_attrs
            ):
                if not held:
                    yield self.finding(
                        model,
                        node,
                        f"unguarded {how} of shared self.{attr}: class "
                        f"{info.name} runs threads ({info.spawn_reason}) "
                        "and no lock is held here; guard the mutation and "
                        "declare the attribute `# guarded-by: <lock>` "
                        "(docs/LINT.md 'Concurrency rules')",
                    )

    # -- module-level globals --------------------------------------------

    def _check_module_globals(
        self, model: ModuleModel, cm: ConcurrencyModel
    ) -> Iterator[Finding]:
        if not cm.module_guarded:
            return
        for fn in ast.walk(model.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            declared_global: Set[str] = set()
            for stmt in ast.walk(fn):
                if isinstance(stmt, ast.Global):
                    declared_global.update(stmt.names)
            watched = declared_global & set(cm.module_guarded)
            if not watched:
                continue
            for node in ast.walk(fn):
                if _nearest_function(node) is not fn:
                    continue
                names = []
                if isinstance(node, ast.Assign):
                    names = [
                        leaf.id
                        for t in node.targets
                        for leaf in flatten_targets(t)
                        if isinstance(leaf, ast.Name)
                    ]
                elif isinstance(node, ast.AugAssign) and isinstance(
                    node.target, ast.Name
                ):
                    names = [node.target.id]
                for name in names:
                    if name not in watched:
                        continue
                    want = cm.module_guarded[name]
                    if want not in cm.held_locks(node):
                        yield self.finding(
                            model,
                            node,
                            f"global {name} is declared `# guarded-by: "
                            f"{cm.module_guard_text[name]}` but this write "
                            f"does not hold {want.display}",
                        )


@register
class LockOrderInversion(Rule):
    id = "R102"
    name = "lock-order-inversion"
    description = (
        "the static lock-acquisition graph (nested with/acquire sites "
        "plus calls made under a lock) contains a cycle: two threads "
        "taking the locks in opposite order can deadlock"
    )
    scope = "project"

    def check(self, model: ModuleModel) -> Iterator[Finding]:
        yield from self.check_project([model])

    def check_project(self, models) -> Iterator[Finding]:
        graph = build_lock_graph(models)
        for cycle in graph.cycles():
            ring = cycle + [cycle[0]]
            hops = []
            first_site = None
            for a, b in zip(ring, ring[1:]):
                path, line = graph.sites.get((a, b), (cycle[0].path, 0))
                hops.append(f"{a.display} -> {b.display} at {path}:{line}")
                if first_site is None:
                    first_site = (path, line)
            yield Finding(
                rule=self.id,
                path=first_site[0],
                line=first_site[1],
                col=0,
                message=(
                    "lock-order inversion: "
                    + "; ".join(hops)
                    + " — impose one global order (or drop to a single "
                    "lock) so no two threads can hold these in opposite "
                    "order"
                ),
            )


#: Blocking attribute calls and the exemption shapes that keep dict.get /
#: str.join quiet: see _blocking_reason.
_BLOCKING_RESOLVED = {
    "time.sleep": "time.sleep() parks the thread",
    "torch.cuda.synchronize": "torch.cuda.synchronize() waits for all of the device's work",
    # The JAX package's entries stay, so that code and fixtures written
    # for it read the same under both analyzers.
    "jax.device_get": "jax.device_get() forces a device->host transfer",
    "jax.block_until_ready": "jax.block_until_ready() drains the device queue",
}
#: Methods of a device tensor that copy it to the host and wait.
_TENSOR_READBACKS = ("item", "cpu", "tolist", "numpy")


def _is_timeoutish(call: ast.Call) -> bool:
    """Zero positional args, or a single numeric constant, plus only
    block/timeout keywords — the Thread.join()/queue.get() shapes (and
    never str.join(iterable) / dict.get(key))."""
    if any(k.arg not in ("timeout", "block") for k in call.keywords):
        return False
    if not call.args:
        return True
    if len(call.args) == 1 and isinstance(call.args[0], ast.Constant):
        return isinstance(call.args[0].value, (int, float))
    return False


def _blocking_reason(cm: ConcurrencyModel, call: ast.Call) -> Optional[str]:
    resolved = cm.model.resolve(call.func)
    if resolved in _BLOCKING_RESOLVED:
        return _BLOCKING_RESOLVED[resolved]
    if not isinstance(call.func, ast.Attribute):
        return None
    attr = call.func.attr
    if attr == "result":
        if not call.args and all(k.arg == "timeout" for k in call.keywords):
            return "Future.result() blocks until the worker resolves it"
    elif attr == "join" and _is_timeoutish(call):
        return "Thread.join() blocks until the thread exits"
    elif attr == "get" and _is_timeoutish(call):
        for k in call.keywords:
            if (
                k.arg == "block"
                and isinstance(k.value, ast.Constant)
                and not k.value.value
            ):
                return None
        return "queue get() blocks until an item arrives"
    elif attr == "wait" and _is_timeoutish(call):
        return "wait() parks the thread until another thread signals"
    elif attr == "block_until_ready" and not call.args:
        return ".block_until_ready() drains the device queue"
    elif attr == "synchronize" and not call.args and not call.keywords:
        return ".synchronize() blocks until the CUDA event or stream completes"
    elif (
        attr in _TENSOR_READBACKS
        and not call.args
        and tensor_kind(cm.model, call.func.value) == DEVICE
    ):
        return f".{attr}() copies a device tensor to the host and waits for the device"
    return None


@register
class BlockingCallUnderLock(Rule):
    id = "R103"
    name = "blocking-call-under-lock"
    description = (
        "a blocking call (Future.result, Thread.join, queue get, "
        "host sync, sleep, wait) runs while a lock is held, stalling "
        "every thread that contends for it"
    )

    def check(self, model: ModuleModel) -> Iterator[Finding]:
        cm = ConcurrencyModel(model)
        for node in ast.walk(model.tree):
            if not isinstance(node, ast.Call):
                continue
            reason = _blocking_reason(cm, node)
            if reason is None:
                continue
            held = cm.held_locks(node)
            if not held:
                continue
            # Condition.wait under its own condition's `with` is THE
            # sanctioned pattern (wait releases the lock): exempt.
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "wait"
            ):
                receiver = cm.lock_key_of_expr(node.func.value)
                if receiver is not None and receiver in held:
                    continue
            names = ", ".join(sorted(k.display for k in held))
            yield self.finding(
                model,
                node,
                f"blocking call while holding {names}: {reason}. Move the "
                "blocking step outside the locked region (snapshot under "
                "the lock, block after releasing)",
            )


@register
class ConditionWaitWithoutPredicate(Rule):
    id = "R104"
    name = "condition-wait-without-predicate"
    description = (
        "Condition.wait() whose predicate is not re-checked in a while "
        "loop: spurious and missed wakeups are part of the condition "
        "contract, so an if (or no check) loses signals"
    )

    def _condition_receiver(
        self, cm: ConcurrencyModel, expr: ast.AST
    ) -> bool:
        """True when ``expr`` statically names a Condition: a class/module
        attr constructed via threading/asyncio.Condition, or a local
        assigned one in the same function."""
        cls = enclosing_class(expr)
        attr = _self_attr_base(expr)
        if attr is not None and cls is not None:
            info = cm.classes.get(cls)
            return info is not None and info.locks.get(attr) == "condition"
        if isinstance(expr, ast.Name):
            if cm.module_locks.get(expr.id) == "condition":
                return True
            fn = _nearest_function(expr)
            if fn is not None:
                for node in ast.walk(fn):
                    if (
                        isinstance(node, ast.Assign)
                        and cm._lock_kind(node.value) == "condition"
                        and any(
                            isinstance(leaf, ast.Name) and leaf.id == expr.id
                            for t in node.targets
                            for leaf in flatten_targets(t)
                        )
                    ):
                        return True
        return False

    def check(self, model: ModuleModel) -> Iterator[Finding]:
        cm = ConcurrencyModel(model)
        for node in ast.walk(model.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "wait"
            ):
                continue
            if not self._condition_receiver(cm, node.func.value):
                continue
            in_while = False
            for anc in ancestors(node):
                if isinstance(anc, ast.While):
                    in_while = True
                    break
                if isinstance(
                    anc, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
                ):
                    break
            if not in_while:
                yield self.finding(
                    model,
                    node,
                    "Condition.wait() outside a while loop: re-check the "
                    "predicate in `while not <pred>: cond.wait()` (or use "
                    "cond.wait_for(pred)) — wakeups can be spurious and "
                    "signals sent before the wait are lost",
                )


@register
class UnjoinedThread(Rule):
    id = "R105"
    name = "unjoined-thread"
    description = (
        "a non-daemon Thread is started with no join, daemon flag, or "
        "leak-guard registration anywhere in the module: process exit "
        "hangs on it and tests leak it"
    )

    _REGISTER_CALLS = {"append", "extend", "add", "register"}

    def _daemon_kw(self, call: ast.Call) -> Optional[bool]:
        for k in call.keywords:
            if k.arg == "daemon" and isinstance(k.value, ast.Constant):
                return bool(k.value.value)
        return None

    def _handled_elsewhere(self, root: ast.AST, key) -> bool:
        """Is this thread ref joined, daemonized, or registered anywhere
        under ``root``? ``self.attr`` refs search the whole module
        (close() joining what __init__ spawned is the normal shape);
        local refs search only their own function."""
        for node in ast.walk(root):
            if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ):
                if (
                    node.func.attr == "join"
                    and ref_key(node.func.value) == key
                ):
                    return True
                if node.func.attr == "setDaemon" and ref_key(
                    node.func.value
                ) == key:
                    return True
                if node.func.attr in self._REGISTER_CALLS and any(
                    ref_key(a) == key
                    or (
                        isinstance(a, (ast.List, ast.Tuple))
                        and any(ref_key(e) == key for e in a.elts)
                    )
                    for a in node.args
                ):
                    return True
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and t.attr == "daemon"
                        and ref_key(t.value) == key
                    ):
                        return True
        return False

    def check(self, model: ModuleModel) -> Iterator[Finding]:
        for node in ast.walk(model.tree):
            if not (
                isinstance(node, ast.Call)
                and model.resolve(node.func) == "threading.Thread"
            ):
                continue
            daemon = self._daemon_kw(node)
            if daemon:
                continue
            parent = getattr(node, "_jl_parent", None)
            key = None
            if isinstance(parent, ast.Assign):
                for t in parent.targets:
                    key = ref_key(t)
                    if key is not None:
                        break
            if key is not None:
                root = model.tree
                if key[0] == "local":
                    root = _nearest_function(node) or model.tree
                if self._handled_elsewhere(root, key):
                    continue
            where = (
                "bound but never joined"
                if key is not None
                else "not bound to anything, so it can never be joined"
            )
            yield self.finding(
                model,
                node,
                f"non-daemon Thread {where}: join it on the shutdown "
                "path, register it with a leak guard, or mark it "
                "daemon=True if abandonment is really intended",
            )

"""R201–R205 — the asynclint event-loop rule family (the JAX package's
docs/LINT.md); R201's blocking taxonomy includes the device syncs.

Five rules over the :mod:`waternet_tpu_torch.analysis.asyncio_model` model:

* **R201 blocking-call-in-coroutine** — a call reached on the event
  loop inside an ``async def`` that blocks the thread (``time.sleep``,
  cv2 codec work, lock ``.acquire()``, ``queue.get()``, file/socket
  I/O, ``Future.result()``, host syncs) or may block transitively
  through the repo-wide may-block fixpoint — without an executor wrap
  (project-scope: the fixpoint crosses modules).
* **R202 fire-and-forget-task** — a ``create_task``/``ensure_future``
  whose result is neither stored nor awaited (the loop holds only a
  weak reference: GC can cancel it mid-flight), plus a bare un-awaited
  call of a known coroutine function.
* **R203 cross-thread-loop-access** — loop-only methods or loop-future
  ``set_result`` reached from the off-loop closure (thread targets,
  executor workers, done-callbacks) without ``call_soon_threadsafe``
  (project-scope: the closure crosses modules).
* **R204 await-under-threading-lock** — an ``await`` while lexically
  holding a ``threading.Lock``/``RLock``/etc.: the suspension point
  keeps the lock held for an unbounded time, stalling every thread
  contending for it and inverting against the R102 lock graph.
  ``asyncio`` locks are exempt — suspending under them is their point.
* **R205 swallowed-cancellation** — an ``except`` inside a coroutine
  catching ``CancelledError`` / ``BaseException`` / everything (bare)
  without re-raising: cancellation is how disconnect cleanup and drain
  propagate, and eating it leaves the task running. The cancel-and-reap
  idiom (``t.cancel()`` then ``try: await t except CancelledError:
  pass``) is recognized and exempt.

Same precision-first stance as R001–R105: unresolvable receivers are
skipped, not guessed, because tier-1 pins the tree at zero unsuppressed
findings and a noisy rule would be suppressed into uselessness.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from waternet_tpu_torch.analysis.asyncio_model import AsyncioModel, AsyncProject
from waternet_tpu_torch.analysis.core import (
    Finding,
    ModuleModel,
    ancestors,
    parent,
)
from waternet_tpu_torch.analysis.registry import Rule, register

_FUNCTION_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)

#: Exception names that catch cancellation when named in an ``except``.
_CANCEL_CATCHERS = {
    "asyncio.CancelledError",
    "concurrent.futures.CancelledError",
    "CancelledError",
    "BaseException",
}


def _nearest_function(node: ast.AST):
    for anc in ancestors(node):
        if isinstance(anc, _FUNCTION_NODES):
            return anc
    return None


@register
class BlockingCallInCoroutine(Rule):
    id = "R201"
    name = "blocking-call-in-coroutine"
    description = (
        "a coroutine calls something that blocks the loop thread "
        "(sleep, codec work, lock acquire, queue get, file/socket I/O, "
        "Future.result, host sync — directly or through the may-block "
        "fixpoint) without an executor wrap"
    )
    scope = "project"

    def check(self, model: ModuleModel) -> Iterator[Finding]:
        yield from self.check_project([model])

    def check_project(self, models) -> Iterator[Finding]:
        project = AsyncProject(models)
        for path, node, message in project.blocking_call_findings():
            yield Finding(
                rule=self.id,
                path=path,
                line=node.lineno,
                col=node.col_offset,
                message=message,
            )


@register
class FireAndForgetTask(Rule):
    id = "R202"
    name = "fire-and-forget-task"
    description = (
        "create_task/ensure_future result neither stored nor awaited "
        "(the loop keeps only a weak ref — GC can cancel the task), or "
        "a coroutine function called bare without await"
    )

    def check(self, model: ModuleModel) -> Iterator[Finding]:
        am = AsyncioModel(model)
        coro_names = {c.name for c in am.coroutines}
        for node in ast.walk(model.tree):
            if not isinstance(node, ast.Call):
                continue
            if not isinstance(parent(node), ast.Expr):
                continue  # stored, awaited, or part of an expression
            resolved = model.resolve(node.func) or ""
            is_spawn = resolved in {"asyncio.create_task", "asyncio.ensure_future"}
            if not is_spawn and isinstance(node.func, ast.Attribute):
                is_spawn = (
                    node.func.attr in {"create_task", "ensure_future"}
                    and am.looks_like_loop(node.func.value)
                )
            if is_spawn:
                yield self.finding(
                    model, node,
                    "task is neither stored nor awaited — the loop holds "
                    "only a weak reference, so GC can cancel it mid-flight; "
                    "keep the handle and reap it",
                )
                continue
            # bare un-awaited coroutine call: `self.flush()` where flush
            # is an async def builds a coroutine object and drops it.
            name: Optional[str] = None
            if isinstance(node.func, ast.Name):
                name = node.func.id
            elif isinstance(node.func, ast.Attribute):
                name = node.func.attr
            if name in coro_names and _nearest_function(node) is not None:
                yield self.finding(
                    model, node,
                    f"'{name}' is a coroutine function: calling it bare "
                    "builds a coroutine object and drops it — await it or "
                    "hand it to create_task",
                )


@register
class CrossThreadLoopAccess(Rule):
    id = "R203"
    name = "cross-thread-loop-access"
    description = (
        "a function in the off-loop closure (Thread target, executor "
        "worker, done-callback) touches the loop or a loop future "
        "without call_soon_threadsafe"
    )
    scope = "project"

    def check(self, model: ModuleModel) -> Iterator[Finding]:
        yield from self.check_project([model])

    def check_project(self, models) -> Iterator[Finding]:
        project = AsyncProject(models)
        for path, node, message in project.off_loop_findings():
            yield Finding(
                rule=self.id,
                path=path,
                line=node.lineno,
                col=node.col_offset,
                message=message,
            )


@register
class AwaitUnderThreadingLock(Rule):
    id = "R204"
    name = "await-under-threading-lock"
    description = (
        "an await suspends while holding a threading.* lock — the lock "
        "stays held for an unbounded suspension, stalling every "
        "contending thread (asyncio locks are exempt)"
    )

    def check(self, model: ModuleModel) -> Iterator[Finding]:
        am = AsyncioModel(model)
        for node in ast.walk(model.tree):
            if not isinstance(node, ast.Await):
                continue
            for key in sorted(am.cm.held_locks(node)):
                factory = am.lock_factory.get(key)
                if factory is None or not factory.startswith("threading."):
                    continue  # asyncio lock, or provenance unknown: skip
                yield self.finding(
                    model, node,
                    f"await while holding {key.display} (built by "
                    f"{factory}): the suspension keeps the lock held for "
                    "an unbounded time — release before awaiting, or use "
                    "asyncio.Lock",
                )


@register
class SwallowedCancellation(Rule):
    id = "R205"
    name = "swallowed-cancellation"
    description = (
        "an except inside a coroutine catches CancelledError/"
        "BaseException (or everything, bare) without re-raising — "
        "cancellation is how disconnect cleanup and drain propagate"
    )

    def check(self, model: ModuleModel) -> Iterator[Finding]:
        for node in ast.walk(model.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not isinstance(_nearest_function(node), ast.AsyncFunctionDef):
                continue
            caught = self._catches_cancellation(model, node)
            if caught is None:
                continue
            if self._reraises(node):
                continue
            if self._is_cancel_and_reap(node):
                continue
            yield self.finding(
                model, node,
                f"'except {caught}' in a coroutine swallows cancellation "
                "— re-raise CancelledError (or narrow the except) so "
                "disconnect cleanup and drain can propagate",
            )

    def _catches_cancellation(
        self, model: ModuleModel, handler: ast.ExceptHandler
    ) -> Optional[str]:
        """The display name of the cancellation-catching clause, or None."""
        if handler.type is None:
            return ""  # bare except — rendered as plain 'except'
        exprs = (
            handler.type.elts
            if isinstance(handler.type, ast.Tuple)
            else [handler.type]
        )
        for expr in exprs:
            resolved = model.resolve(expr)
            if resolved in _CANCEL_CATCHERS:
                return resolved
        return None

    def _reraises(self, handler: ast.ExceptHandler) -> bool:
        """Any ``raise`` in the handler body (not inside a nested def)."""
        todo = list(handler.body)
        while todo:
            node = todo.pop()
            if isinstance(node, ast.Raise):
                return True
            if isinstance(node, _FUNCTION_NODES):
                continue
            todo.extend(ast.iter_child_nodes(node))
        return False

    def _is_cancel_and_reap(self, handler: ast.ExceptHandler) -> bool:
        """The sanctioned reap idiom, exempt by shape::

            t.cancel()
            try:
                await t
            except (asyncio.CancelledError, ...):
                pass

        The coroutine cancelled its own child and awaits it purely to
        reap — swallowing the child's CancelledError is the contract.
        Requires exactly that shape: the statement before the try
        cancels the same name the try body awaits."""
        try_stmt = parent(handler)
        if not isinstance(try_stmt, ast.Try) or len(try_stmt.body) != 1:
            return False
        body_stmt = try_stmt.body[0]
        if not (
            isinstance(body_stmt, ast.Expr)
            and isinstance(body_stmt.value, ast.Await)
            and isinstance(body_stmt.value.value, ast.Name)
        ):
            return False
        awaited = body_stmt.value.value.id
        holder = parent(try_stmt)
        for field in ("body", "orelse", "finalbody"):
            stmts = getattr(holder, field, None)
            if stmts and try_stmt in stmts:
                i = stmts.index(try_stmt)
                if i == 0:
                    return False
                prev = stmts[i - 1]
                return (
                    isinstance(prev, ast.Expr)
                    and isinstance(prev.value, ast.Call)
                    and isinstance(prev.value.func, ast.Attribute)
                    and prev.value.func.attr == "cancel"
                    and isinstance(prev.value.func.value, ast.Name)
                    and prev.value.func.value.id == awaited
                )
        return False

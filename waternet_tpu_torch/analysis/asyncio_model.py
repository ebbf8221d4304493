"""Coroutine/event-loop model shared by the asynclint rules (R201–R205).

The serving front door, stream sessions, fleet router, and reuse layer
are asyncio-based: one blocking call inside a coroutine stalls the whole
event loop and silently moves every concurrent stream's p99 — exactly
the signal the burn-rate SLO engine pages on. This module gives the
rules a semantic model of that discipline, in the same flow-light spirit
as :mod:`waternet_tpu_torch.analysis.core` and
:mod:`waternet_tpu_torch.analysis.concurrency`: prefer missing a hazard to
crying wolf, because tier-1 pins the tree at zero unsuppressed findings.

Annotation convention (the JAX package's docs/LINT.md, "Asyncio rules"):

* ``# loop-blocking: <why>`` on a ``def`` line declares that the
  function does work too heavy for the event loop (a full-frame numpy
  warp, a large encode) even though its body names nothing in the
  blocking taxonomy. The may-block fixpoint treats it exactly like a
  ``time.sleep`` — any coroutine reaching it without an executor wrap
  trips R201.

What the model knows, per module (:class:`AsyncioModel`):

* the coroutine inventory (every ``async def``, including nested ones);
* lock *provenance* — which declared lock attrs were built by
  ``threading.*`` factories vs ``asyncio.*`` ones (R204 only cares
  about the former: holding an asyncio lock across an ``await`` is the
  point of asyncio locks);
* task-retention facts — names assigned from ``create_task`` /
  ``ensure_future`` (calling ``.result()`` on a reaped task is fine;
  on a ``concurrent.futures.Future`` it blocks);
* loop-future provenance — refs assigned from ``<loop>.create_future()``
  (their ``set_result`` from a worker thread is the R203 hazard).

And per project (:class:`AsyncProject`), mirroring the lock graph's
call resolution: a repo-wide may-block fixpoint over *sync* functions
(``self.m()`` resolves in-class, ``f()`` in-module, imported names
through the alias table when the target module is in the scan set, and
``obj.m()`` only when the method name is repo-unique), plus the
off-loop closure — functions reachable from ``Thread(target=...)``,
``run_in_executor`` / ``to_thread`` arguments, and
``add_done_callback`` registrations, i.e. code that must not touch the
loop without ``call_soon_threadsafe`` (R203).
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from typing import Dict, Iterator, List, NamedTuple, Optional, Set, Tuple

from waternet_tpu_torch.analysis.concurrency import (
    LOCK_FACTORIES,
    LockKey,
    ConcurrencyModel,
)
from waternet_tpu_torch.analysis.core import (
    DEVICE,
    ModuleModel,
    dotted_module,
    ancestors,
    enclosing_class,
    parent,
    ref_key,
    tensor_kind,
)

_FUNCTION_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)

#: Canonical dotted names that block the calling thread — reaching one
#: of these from a coroutine without an executor wrap stalls the loop.
BLOCKING_CALLS = {
    "time.sleep": "time.sleep() suspends the loop thread",
    "torch.cuda.synchronize": "torch.cuda.synchronize() waits for all of the device's work",
    # The JAX package's entries stay, so that code and fixtures written
    # for it read the same under both analyzers.
    "jax.device_get": "jax.device_get() synchronizes with the device",
    "jax.block_until_ready": "block_until_ready() synchronizes with the device",
    "cv2.imdecode": "cv2.imdecode() is CPU-bound decode work",
    "cv2.imencode": "cv2.imencode() is CPU-bound encode work",
    "cv2.cvtColor": "cv2.cvtColor() is CPU-bound image work",
    "cv2.resize": "cv2.resize() is CPU-bound image work",
    "cv2.GaussianBlur": "cv2.GaussianBlur() is CPU-bound image work",
    "open": "open() is blocking file I/O",
    "socket.create_connection": "socket.create_connection() is blocking network I/O",
    "urllib.request.urlopen": "urlopen() is blocking network I/O",
    "requests.get": "requests.get() is blocking network I/O",
    "requests.post": "requests.post() is blocking network I/O",
    "subprocess.run": "subprocess.run() waits on a child process",
    "subprocess.call": "subprocess.call() waits on a child process",
    "subprocess.check_call": "subprocess.check_call() waits on a child process",
    "subprocess.check_output": "subprocess.check_output() waits on a child process",
}

#: Canonical names whose *argument* is scheduled, not called here —
#: ``ensure_future(coro())`` is retention, not a bare call.
ASYNC_WRAPPERS = {
    "asyncio.create_task",
    "asyncio.ensure_future",
    "asyncio.gather",
    "asyncio.wait",
    "asyncio.wait_for",
    "asyncio.shield",
    "asyncio.as_completed",
    "asyncio.run",
}

#: Loop methods that are only safe from the loop thread itself.
LOOP_ONLY_METHODS = {
    "call_soon",
    "call_later",
    "call_at",
    "create_task",
    "create_future",
    "stop",
    "close",
}

_LOOP_BLOCKING_RE = re.compile(r"loop-blocking:\s*(?P<why>.*\S)")


def loop_blocking_comments(source: str) -> Dict[int, str]:
    """``{line: why-text}`` from ``# loop-blocking: <why>`` comments
    (tokenize-based, like suppression parsing, so a ``#`` inside a
    string never counts)."""
    out: Dict[int, str] = {}
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return out
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _LOOP_BLOCKING_RE.search(tok.string)
        if m:
            out[tok.start[0]] = m.group("why")
    return out




def _is_false(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value is False


class AsyncioModel:
    """Asyncio view of one :class:`ModuleModel` (pure AST)."""

    def __init__(self, model: ModuleModel):
        self.model = model
        self.cm = ConcurrencyModel(model)
        self.loop_blocking = loop_blocking_comments(model.source)
        #: Every ``async def`` in the module, nested ones included.
        self.coroutines: List[ast.AsyncFunctionDef] = [
            n for n in ast.walk(model.tree)
            if isinstance(n, ast.AsyncFunctionDef)
        ]
        #: LockKey -> canonical factory name ("threading.Lock", ...) for
        #: every lock declaration whose constructor is visible. R204
        #: flags only threading-built locks held across an ``await``.
        self.lock_factory: Dict[LockKey, str] = {}
        #: ("self", attr) keys assigned from ``<loop>.create_future()``
        #: anywhere in the class — class name -> key set.
        self.loop_future_attrs: Dict[str, Set[str]] = {}
        self._collect()

    def _collect(self) -> None:
        for node in ast.walk(self.model.tree):
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [node.target]
            else:
                continue
            value = node.value
            factory = None
            if isinstance(value, ast.Call):
                resolved = self.model.resolve(value.func) or ""
                if resolved in LOCK_FACTORIES:
                    factory = resolved
            cls = enclosing_class(node)
            for target in targets:
                key = ref_key(target)
                if key is None:
                    continue
                if factory is not None:
                    if key[0] == "self" and cls is not None:
                        self.lock_factory[
                            LockKey(self.model.path, cls.name, key[1])
                        ] = factory
                    elif key[0] == "local" and cls is None:
                        self.lock_factory[
                            LockKey(self.model.path, "", key[1])
                        ] = factory
                if (
                    key[0] == "self"
                    and cls is not None
                    and self._is_create_future(value)
                ):
                    self.loop_future_attrs.setdefault(cls.name, set()).add(key[1])

    @staticmethod
    def _is_create_future(value: ast.AST) -> bool:
        return (
            isinstance(value, ast.Call)
            and isinstance(value.func, ast.Attribute)
            and value.func.attr == "create_future"
        )

    # -- per-function ref provenance -------------------------------------

    def task_refs(self, fn: ast.AST) -> Set[tuple]:
        """Ref keys assigned from ``create_task`` / ``ensure_future``
        within ``fn`` — an awaited/reaped task's ``.result()`` is
        non-blocking, unlike a ``concurrent.futures.Future``'s."""
        refs: Set[tuple] = set()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            if self.enclosing_function(node) is not fn:
                continue
            value = node.value
            if not isinstance(value, ast.Call):
                continue
            resolved = self.model.resolve(value.func) or ""
            is_spawn = resolved in {"asyncio.create_task", "asyncio.ensure_future"}
            if not is_spawn and isinstance(value.func, ast.Attribute):
                is_spawn = value.func.attr in {"create_task", "ensure_future"}
            if not is_spawn:
                continue
            for target in node.targets:
                key = ref_key(target)
                if key is not None:
                    refs.add(key)
        return refs

    def loop_future_refs(self, fn: ast.AST) -> Set[tuple]:
        """Ref keys within ``fn`` assigned from ``.create_future()``,
        plus the enclosing class's tracked ``self.X`` loop futures."""
        refs: Set[tuple] = set()
        cls = enclosing_class(fn)
        if cls is not None:
            refs |= {
                ("self", a)
                for a in self.loop_future_attrs.get(cls.name, ())
            }
        for node in ast.walk(fn):
            if (
                isinstance(node, ast.Assign)
                and self.enclosing_function(node) is fn
                and self._is_create_future(node.value)
            ):
                for target in node.targets:
                    key = ref_key(target)
                    if key is not None:
                        refs.add(key)
        return refs

    # -- structural helpers ----------------------------------------------

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        for anc in ancestors(node):
            if isinstance(anc, _FUNCTION_NODES):
                return anc
        return None

    def is_awaited(self, call: ast.Call) -> bool:
        return isinstance(parent(call), ast.Await)

    def in_async_wrapper_arg(self, call: ast.Call) -> bool:
        """True when ``call`` is a direct argument of an asyncio
        scheduling wrapper — ``ensure_future(ev.wait())`` hands the
        coroutine/awaitable to the loop; nothing blocks here."""
        p = parent(call)
        if not isinstance(p, ast.Call) or call is p.func:
            return False
        resolved = self.model.resolve(p.func) or ""
        if resolved in ASYNC_WRAPPERS:
            return True
        return (
            isinstance(p.func, ast.Attribute)
            and p.func.attr in {"create_task", "ensure_future", "run_until_complete"}
        )

    def blocking_reason(self, call: ast.Call) -> Optional[str]:
        """Why this call blocks the calling thread, or None. Direct
        taxonomy only — transitive reach is the project pass's job."""
        resolved = self.model.resolve(call.func)
        if resolved in BLOCKING_CALLS:
            return BLOCKING_CALLS[resolved]
        f = call.func
        if not isinstance(f, ast.Attribute):
            return None
        kwargs = {k.arg: k.value for k in call.keywords if k.arg}
        if f.attr == "acquire":
            # lock.acquire(False) / acquire(blocking=False) polls.
            if call.args and _is_false(call.args[0]):
                return None
            if _is_false(kwargs.get("blocking", None)):
                return None
            return ".acquire() blocks until the lock is free"
        if f.attr == "wait" and not call.args and not kwargs:
            return ".wait() blocks until the event/condition fires"
        if f.attr == "join" and not call.args and not kwargs:
            # zero-arg only: str.join(it) always has an argument.
            return ".join() blocks until the thread/queue drains"
        if f.attr == "get" and not call.args:
            # dict.get() needs a key, so zero-positional .get() is a
            # queue read; block=False polls.
            if _is_false(kwargs.get("block", None)):
                return None
            return ".get() blocks until an item arrives"
        if f.attr == "result" and not call.args and not kwargs:
            return ".result() blocks until the future resolves"
        if f.attr == "synchronize" and not call.args and not kwargs:
            return ".synchronize() blocks until the CUDA event or stream completes"
        if (
            f.attr in ("item", "cpu", "tolist", "numpy")
            and not call.args
            and tensor_kind(self.model, f.value) == DEVICE
        ):
            return f".{f.attr}() copies a device tensor to the host and waits for the device"
        return None

    def looks_like_loop(self, expr: ast.AST) -> bool:
        """Heuristic receiver check: ``loop`` / ``self._loop`` /
        anything whose terminal name ends with ``loop``."""
        if isinstance(expr, ast.Name):
            return expr.id == "loop" or expr.id.endswith("_loop")
        if isinstance(expr, ast.Attribute):
            return expr.attr == "loop" or expr.attr.endswith("_loop")
        return False


class BlockingInfo(NamedTuple):
    """Why a function may block: the root reason and the first call hop
    (empty for a direct reason), for finding messages."""

    reason: str
    via: str


class AsyncProject:
    """Project-wide asyncio facts over a set of modules: the may-block
    fixpoint (R201) and the off-loop closure (R203), built on the same
    call-resolution scheme as :func:`build_lock_graph`."""

    def __init__(self, models):
        self.ams = [AsyncioModel(m) for m in models]
        self.am_of_fn: Dict[ast.AST, AsyncioModel] = {}
        self.fn_name: Dict[ast.AST, str] = {}
        self.fn_calls: Dict[ast.AST, List[Tuple[ast.Call, ast.AST]]] = {}
        self.may_block: Dict[ast.AST, BlockingInfo] = {}
        self.off_loop: Dict[ast.AST, str] = {}  # fn -> provenance text
        self._build()

    # -- construction ----------------------------------------------------

    def _build(self) -> None:
        method_index: Dict[str, List[ast.AST]] = {}
        module_fns: Dict[int, Dict[str, ast.AST]] = {}
        fns_by_dotted: Dict[str, ast.AST] = {}
        all_fns: List[ast.AST] = []

        for am in self.ams:
            fns_by_name: Dict[str, ast.AST] = {}
            dotted = dotted_module(am.model.path)
            for node in ast.walk(am.model.tree):
                if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                all_fns.append(node)
                self.am_of_fn[node] = am
                self.fn_name[node] = node.name
                self.fn_calls[node] = []
                cls = enclosing_class(node)
                if cls is not None:
                    method_index.setdefault(node.name, []).append(node)
                else:
                    fns_by_name.setdefault(node.name, node)
                    if dotted is not None:
                        fns_by_dotted[f"{dotted}.{node.name}"] = node
            module_fns[id(am)] = fns_by_name

        # direct blocking facts ------------------------------------------
        for fn in all_fns:
            am = self.am_of_fn[fn]
            if fn.lineno in am.loop_blocking:
                self.may_block[fn] = BlockingInfo(
                    f"declared loop-blocking: {am.loop_blocking[fn.lineno]}", ""
                )
                continue
            if isinstance(fn, ast.AsyncFunctionDef):
                # A coroutine's own blocking calls are its own R201
                # findings; awaiting it never blocks the caller.
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                if am.enclosing_function(node) is not fn:
                    continue
                reason = am.blocking_reason(node)
                if reason is not None:
                    self.may_block.setdefault(fn, BlockingInfo(reason, ""))
                    break

        # call resolution (build_lock_graph's scheme + imported names) ---
        for am in self.ams:
            class_methods: Dict[ast.ClassDef, Dict[str, ast.AST]] = {}
            for call, desc, _held in am.cm.call_events():
                fn = am.enclosing_function(call)
                if fn not in self.fn_calls:
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
                    target = module_fns[id(am)].get(desc[1])
                    if target is None:
                        resolved = am.model.resolve(call.func)
                        if resolved is not None:
                            target = fns_by_dotted.get(resolved)
                elif desc[0] == "method_name":
                    candidates = method_index.get(desc[1], [])
                    if len(candidates) == 1:
                        target = candidates[0]
                if target is not None:
                    self.fn_calls[fn].append((call, target))

        # may-block fixpoint over sync functions -------------------------
        # (never *into* or *through* coroutines: calling a coroutine
        # function just builds the coroutine object.)
        changed = True
        while changed:
            changed = False
            for fn, calls in self.fn_calls.items():
                if isinstance(fn, ast.AsyncFunctionDef) or fn in self.may_block:
                    continue
                for call, target in calls:
                    if isinstance(target, ast.AsyncFunctionDef):
                        continue
                    info = self.may_block.get(target)
                    if info is not None:
                        self.may_block[fn] = BlockingInfo(
                            info.reason, info.via or f"{self.fn_name[target]}()"
                        )
                        changed = True
                        break

        # off-loop closure (R203 feedstock) ------------------------------
        roots: Dict[ast.AST, str] = {}
        for am in self.ams:
            for fn, why in self._off_loop_roots(am, module_fns[id(am)],
                                                method_index):
                roots.setdefault(fn, why)
        self.off_loop = dict(roots)
        changed = True
        while changed:
            changed = False
            for fn, why in list(self.off_loop.items()):
                for _call, target in self.fn_calls.get(fn, ()):
                    if isinstance(target, ast.AsyncFunctionDef):
                        continue
                    if target not in self.off_loop:
                        self.off_loop[target] = (
                            f"reached from {why} via {self.fn_name[fn]}()"
                        )
                        changed = True

    def _off_loop_roots(
        self,
        am: AsyncioModel,
        fns_by_name: Dict[str, ast.AST],
        method_index: Dict[str, List[ast.AST]],
    ) -> Iterator[Tuple[ast.AST, str]]:
        """Functions handed to another thread: ``Thread(target=f)``,
        ``run_in_executor(None, f, ...)``, ``to_thread(f, ...)``,
        ``fut.add_done_callback(f)`` (completion threads)."""

        def resolve_fn_expr(expr: ast.AST, site: ast.AST) -> Optional[ast.AST]:
            if isinstance(expr, ast.Name):
                target = fns_by_name.get(expr.id)
                if target is not None:
                    return target
                return am.model._find_def(expr.id, site)
            if (
                isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"
            ):
                cls = enclosing_class(site)
                if cls is not None:
                    for n in ast.walk(cls):
                        if (
                            isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                            and n.name == expr.attr
                            and enclosing_class(n) is cls
                        ):
                            return n
            if isinstance(expr, ast.Attribute):
                candidates = method_index.get(expr.attr, [])
                if len(candidates) == 1:
                    return candidates[0]
            return None

        for node in ast.walk(am.model.tree):
            if not isinstance(node, ast.Call):
                continue
            resolved = am.model.resolve(node.func) or ""
            fn_expr = None
            why = ""
            if resolved == "threading.Thread":
                kw = {k.arg: k.value for k in node.keywords if k.arg}
                fn_expr = kw.get("target")
                why = "a Thread target"
            elif resolved == "asyncio.to_thread" and node.args:
                fn_expr = node.args[0]
                why = "a to_thread worker"
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "run_in_executor"
                and len(node.args) >= 2
            ):
                fn_expr = node.args[1]
                why = "an executor worker"
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_done_callback"
                and node.args
            ):
                fn_expr = node.args[0]
                why = "a done-callback (completion thread)"
            if fn_expr is None:
                continue
            target = resolve_fn_expr(fn_expr, node)
            if target is not None and not isinstance(target, ast.AsyncFunctionDef):
                yield target, why

    # -- rule feedstock ---------------------------------------------------

    def blocking_call_findings(self) -> Iterator[Tuple[str, ast.Call, str]]:
        """R201 feedstock: ``(path, call, message)`` for every call made
        directly on the loop inside a coroutine that blocks (taxonomy)
        or may block (fixpoint), with executor/await/scheduling-wrapper
        exemptions applied."""
        for am in self.ams:
            for coro in am.coroutines:
                task_refs = am.task_refs(coro)
                for node in ast.walk(coro):
                    if not isinstance(node, ast.Call):
                        continue
                    if am.enclosing_function(node) is not coro:
                        continue
                    if am.is_awaited(node) or am.in_async_wrapper_arg(node):
                        continue
                    reason = am.blocking_reason(node)
                    if reason is not None:
                        # .result() on a retained asyncio task is a
                        # post-await read, not a blocking join.
                        if (
                            isinstance(node.func, ast.Attribute)
                            and node.func.attr == "result"
                            and ref_key(node.func.value) in task_refs
                        ):
                            reason = None
                    if reason is None:
                        reason = self._transitive_reason(node)
                    if reason is None:
                        continue
                    yield am.model.path, node, (
                        f"blocking call in coroutine '{coro.name}': {reason} "
                        "— wrap it in run_in_executor/to_thread"
                    )

    def _transitive_reason(self, call: ast.Call) -> Optional[str]:
        fn = None
        for anc in ancestors(call):
            if isinstance(anc, _FUNCTION_NODES):
                fn = anc
                break
        for c, target in self.fn_calls.get(fn, ()):
            if c is call and target in self.may_block:
                info = self.may_block[target]
                hop = f" via {info.via}" if info.via else ""
                return (
                    f"{self.fn_name[target]}() may block{hop} ({info.reason})"
                )
        return None

    def off_loop_findings(self) -> Iterator[Tuple[str, ast.AST, str]]:
        """R203 feedstock: loop-only operations performed by functions in
        the off-loop closure without ``call_soon_threadsafe``."""
        for am in self.ams:
            for fn, why in self.off_loop.items():
                if self.am_of_fn.get(fn) is not am:
                    continue
                future_refs = am.loop_future_refs(fn)
                for node in ast.walk(fn):
                    if not isinstance(node, ast.Call):
                        continue
                    if am.enclosing_function(node) is not fn:
                        continue
                    f = node.func
                    if not isinstance(f, ast.Attribute):
                        continue
                    if f.attr in LOOP_ONLY_METHODS and am.looks_like_loop(f.value):
                        yield am.model.path, node, (
                            f"'{self.fn_name[fn]}' runs off the event loop "
                            f"({why}) but calls loop.{f.attr}() — only "
                            "call_soon_threadsafe() is thread-safe"
                        )
                    elif (
                        f.attr in {"set_result", "set_exception"}
                        and ref_key(f.value) in future_refs
                    ):
                        yield am.model.path, node, (
                            f"'{self.fn_name[fn]}' runs off the event loop "
                            f"({why}) but calls {f.attr}() on a loop future "
                            "— marshal through call_soon_threadsafe()"
                        )

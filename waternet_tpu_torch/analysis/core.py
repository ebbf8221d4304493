"""Shared AST infrastructure for the port's lint rules.

The linter is a pure-AST pass: it imports none of the linted code and no
torch, so it runs on any host, the CUDA-only modules included. The
machinery here is what every rule needs:

* :class:`Finding`: one diagnostic, with suppression state;
* :func:`suppressions`: ``# jaxlint: disable=R00x`` comment parsing
  (tokenize-based, so a ``#`` inside a string literal never counts). The
  comment keeps the JAX package's name on purpose: the port's files are
  also linted by the JAX package's analyzer (its R1xx and R2xx rules read
  the same comments), so one written suppression serves both linters;
* :class:`ModuleModel`: a per-file semantic model: parent links, import
  alias resolution (``nn`` -> ``torch.nn``), and the **launch registry**,
  the statically known callables that enqueue device work:

  - names and ``self`` attributes bound to ``torch.nn.Module`` instances
    (``torch.nn.*`` layers, and every class deriving from ``nn.Module``,
    the project's own included: :func:`link_project` resolves the bases
    across the scanned modules);
  - the training engines' step methods (``train_step*``/``eval_step*`` on
    any receiver) and the ``dispatch`` argument of ``_drive_train_epoch``;
  - the kernel wrappers of ``waternet_tpu_torch/ops/kernels.py``;

* :func:`tensor_kind`: a flow-light guess at whether an expression holds a
  tensor that may live on the device, resolved through assignments where
  the AST can (``np.flatnonzero(...).tolist()`` is numpy; ``torch.
  as_tensor(w).cpu()`` is a host copy; a step's metrics are device
  values).

Everything is intentionally flow-light: rules prefer missing a hazard to
crying wolf, because the tier-1 tests assert the tree is clean and a noisy
rule would be suppressed into uselessness.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path
from typing import Iterable, Iterator, Optional

PACKAGE = "waternet_tpu_torch"

#: Wrappers of ``ops/kernels.py`` that launch a hand-written kernel.
KERNEL_WRAPPERS = frozenset(
    f"{PACKAGE}.ops.kernels.{name}"
    for name in (
        "tile_histogram",
        "tile_lut",
        "clahe_lut_planes",
        "clahe_lut_blend",
        "dct8_dequant_idct",
        "dct8_decode_u8",
    )
)

#: Methods of the training engines that run one step on the device.
LAUNCH_METHOD_RE = re.compile(r"^(train_step|eval_step)\w*$")

#: Parameters that carry a step callable: ``{function name: {param}}``.
LAUNCH_PARAMS = {"_drive_train_epoch": frozenset({"dispatch"})}

#: Bases that make a class an ``nn.Module``.
NN_MODULE_BASES = frozenset({"torch.nn.Module", "torch.nn.modules.module.Module"})

#: ``torch.nn`` callables that start with a capital but are no module.
_NN_NOT_MODULES = frozenset({"Parameter", "ParameterList", "ParameterDict", "Buffer"})

SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.Module)
FUNCTION_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)
LOOP_NODES = (ast.For, ast.AsyncFor, ast.While)


@dataclasses.dataclass
class Finding:
    """One diagnostic: rule id, location, message, suppression state."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule}{tag} {self.message}"


_SUPPRESS_RE = re.compile(
    r"jaxlint:\s*disable(?P<next>-next)?\s*=\s*(?P<rules>[A-Za-z0-9_,\s]+)"
)


def suppressions(source: str) -> dict:
    """``{line: {rule ids}}`` from ``# jaxlint: disable=R00x[,R00y]`` and
    ``# jaxlint: disable-next=R00x`` comments. ``all`` suppresses every
    rule on that line. Free-form justification text after the rule list is
    encouraged and ignored (the first token that isn't an id ends the
    list), e.g. ``# jaxlint: disable=R003 the one read of the window``.
    """
    out: dict = {}
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return out
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        rules = set()
        for part in re.split(r"[\s,]+", m.group("rules").strip()):
            if re.fullmatch(r"[Rr]\d{3}", part):
                rules.add(part.upper())
            elif part.lower() == "all":
                rules.add("ALL")
            else:
                break  # justification text starts here
        if not rules:
            continue
        line = tok.start[0] + (1 if m.group("next") else 0)
        out.setdefault(line, set()).update(rules)
    return out


def is_suppressed(finding: Finding, supp: dict) -> bool:
    rules = supp.get(finding.line, ())
    return finding.rule in rules or "ALL" in rules


def collect_py_files(paths: Iterable) -> list:
    """Expand files/directories into a sorted list of ``.py`` paths."""
    files = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.is_file():
            files.append(p)
        else:
            raise FileNotFoundError(f"lint: no such file or directory: {p}")
    # De-dup while keeping order (a dir arg may repeat an explicit file).
    seen, out = set(), []
    for f in files:
        key = str(f)
        if key not in seen and "__pycache__" not in key:
            seen.add(key)
            out.append(f)
    return out


def dotted_module(path: str) -> Optional[str]:
    """Import path of a scanned file: ``.../waternet_tpu_torch/ops/
    kernels.py`` -> ``waternet_tpu_torch.ops.kernels``; a repo-root script
    like ``chip_smoke.py`` -> ``chip_smoke``; None otherwise."""
    parts = Path(path).with_suffix("").parts
    if PACKAGE in parts:
        parts = parts[parts.index(PACKAGE):]
    elif len(parts) != 1:
        return None
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) if parts else None


# ---------------------------------------------------------------------------
# AST helpers
# ---------------------------------------------------------------------------


def annotate_parents(tree: ast.Module) -> None:
    tree._jl_parent = None  # type: ignore[attr-defined]
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._jl_parent = node  # type: ignore[attr-defined]


def parent(node: ast.AST) -> Optional[ast.AST]:
    return getattr(node, "_jl_parent", None)


def ancestors(node: ast.AST) -> Iterator[ast.AST]:
    cur = parent(node)
    while cur is not None:
        yield cur
        cur = parent(cur)


def enclosing(node: ast.AST, types) -> Optional[ast.AST]:
    for anc in ancestors(node):
        if isinstance(anc, types):
            return anc
    return None


def enclosing_scope(node: ast.AST) -> Optional[ast.AST]:
    """Nearest enclosing function/lambda/module (skips ClassDef: class
    bodies don't form a name scope visible from methods)."""
    return enclosing(node, SCOPE_NODES)


def enclosing_class(node: ast.AST) -> Optional[ast.ClassDef]:
    return enclosing(node, ast.ClassDef)


def scope_chain(node: ast.AST) -> Iterator[ast.AST]:
    """Enclosing name scopes, innermost first, ending at the module."""
    cur = enclosing_scope(node)
    while cur is not None:
        yield cur
        if isinstance(cur, ast.Module):
            return
        cur = enclosing_scope(cur)


def dotted_parts(node: ast.AST) -> Optional[list]:
    """``a.b.c`` attribute chain as ``["a", "b", "c"]``; None otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return None


def ref_key(node: ast.AST):
    """A stable key for "the same storage location": local names become
    ``("local", name)``, ``self.attr`` becomes ``("self", attr)``; anything
    deeper (``a.b.c``, subscripts) is None — not tracked."""
    if isinstance(node, ast.Name):
        return ("local", node.id)
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return ("self", node.attr)
    return None


def flatten_targets(target: ast.AST) -> Iterator[ast.AST]:
    """Assignment target(s) flattened through tuple/list/star nesting."""
    if isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from flatten_targets(elt)
    elif isinstance(target, ast.Starred):
        yield from flatten_targets(target.value)
    else:
        yield target


def iter_body(node: ast.AST) -> Iterator[ast.AST]:
    """Every node under ``node``, not descending into nested function
    definitions (defining a closure executes nothing)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        cur = stack.pop()
        yield cur
        if isinstance(cur, SCOPE_NODES):
            continue
        stack.extend(ast.iter_child_nodes(cur))


def kwarg(call: ast.Call, name: str) -> Optional[ast.AST]:
    for k in call.keywords:
        if k.arg == name:
            return k.value
    return None


def is_true(node: Optional[ast.AST]) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


def in_context(node: ast.AST, model: "ModuleModel", names) -> bool:
    """True when ``node`` sits lexically inside ``with <one of names>(...)``
    in its own function, or in a function decorated with one of them."""
    for anc in ancestors(node):
        if isinstance(anc, (ast.With, ast.AsyncWith)):
            for item in anc.items:
                expr = item.context_expr
                target = expr.func if isinstance(expr, ast.Call) else expr
                if model.resolve(target) in names:
                    return True
        if isinstance(anc, FUNCTION_NODES):
            for dec in anc.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                if model.resolve(target) in names:
                    return True
            return False
        if isinstance(anc, ast.Lambda):
            return False
    return False


@dataclasses.dataclass
class LaunchInfo:
    """One statically known launch: what kind, and a display name."""

    kind: str  # "module" | "step" | "dispatch" | "kernel"
    binding: str


class ModuleModel:
    """Semantic model of one parsed module, shared by all rules."""

    def __init__(self, path, source: str, tree: ast.Module):
        self.path = str(path)
        self.source = source
        self.tree = tree
        self.dotted = dotted_module(self.path)
        annotate_parents(tree)
        self.aliases: dict = {}
        self._collect_imports()
        #: Canonical names of the classes deriving from ``nn.Module`` that
        #: this module can see: its own, and (after :func:`link_project`)
        #: the scanned project's.
        self.nn_classes: set = set()
        self.nn_classes |= self.local_nn_classes(NN_MODULE_BASES)
        self._bindings: Optional[dict] = None
        self._assigns: dict = {}

    # -- imports ---------------------------------------------------------

    def _collect_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.aliases[a.asname or a.name] = f"{node.module}.{a.name}"

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Canonical dotted name of an expression through the module's
        import aliases: with ``import torch.nn as nn``, ``nn.Conv2d``
        resolves to ``"torch.nn.Conv2d"``. None for non-name expressions."""
        parts = dotted_parts(node)
        if not parts:
            return None
        head = self.aliases.get(parts[0], parts[0])
        return ".".join([head] + parts[1:])

    def qualify(self, node: ast.AST) -> Optional[str]:
        """:meth:`resolve`, and a module-level definition of this module
        (not shadowed by an import) to its qualified name."""
        parts = dotted_parts(node)
        if not parts:
            return None
        if (
            parts[0] not in self.aliases
            and self.dotted is not None
            and parts[0] in self._module_defs()
        ):
            return ".".join([self.dotted] + parts)
        return self.resolve(node)

    def _find_def(self, name: str, from_node: ast.AST) -> Optional[ast.AST]:
        """The FunctionDef named ``name`` visible from ``from_node``'s
        scope chain (nearest enclosing scope wins)."""
        for scope in scope_chain(from_node):
            for stmt in ast.walk(scope):
                if (
                    isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and stmt.name == name
                    and enclosing_scope(stmt) is scope
                ):
                    return stmt
        return None

    def _module_defs(self) -> set:
        if not hasattr(self, "_defs"):
            self._defs = {
                s.name for s in self.tree.body
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            }
        return self._defs

    # -- nn.Module classes -------------------------------------------------

    def local_nn_classes(self, known) -> set:
        """Qualified names of this module's classes whose bases (through
        the module's aliases) reach ``known`` or each other."""
        out: set = set()
        classes = [n for n in self.tree.body if isinstance(n, ast.ClassDef)]
        changed = True
        while changed:
            changed = False
            for cls in classes:
                name = f"{self.dotted}.{cls.name}" if self.dotted else cls.name
                if name in out:
                    continue
                for base in cls.bases:
                    b = self.qualify(base)
                    if b in known or b in out:
                        out.add(name)
                        changed = True
                        break
        return out

    def is_module_ctor(self, func: ast.AST) -> bool:
        name = self.qualify(func)
        if name is None:
            return False
        if name in self.nn_classes:
            return True
        if name.startswith("torch.nn.") and name not in NN_MODULE_BASES:
            last = name.rsplit(".", 1)[-1]
            return last[:1].isupper() and last not in _NN_NOT_MODULES
        return False

    # -- the launch registry ---------------------------------------------

    def _collect_bindings(self) -> dict:
        """``("name", scope, name)`` / ``("self", class, attr)`` ->
        LaunchInfo for every binding of an nn.Module instance."""
        out: dict = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Assign):
                value, targets = node.value, node.targets
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                value, targets = node.value, [node.target]
            else:
                continue
            if not (isinstance(value, ast.Call) and self.is_module_ctor(value.func)):
                continue
            for target in targets:
                key = ref_key(target)
                if key is None:
                    continue
                if key[0] == "local":
                    out[("name", enclosing_scope(node), key[1])] = LaunchInfo("module", key[1])
                else:
                    cls = enclosing_class(node)
                    if cls is not None:
                        out[("self", cls, key[1])] = LaunchInfo("module", f"self.{key[1]}")
        return out

    @property
    def module_bindings(self) -> dict:
        if self._bindings is None:
            self._bindings = self._collect_bindings()
        return self._bindings

    def launch_info_for_call(self, call: ast.Call) -> Optional[LaunchInfo]:
        """LaunchInfo when ``call`` statically enqueues device work (see the
        module docstring), else None."""
        f = call.func
        name = self.qualify(f)
        if name in KERNEL_WRAPPERS:
            return LaunchInfo("kernel", name.rsplit(".", 1)[-1])
        if isinstance(f, ast.Attribute) and LAUNCH_METHOD_RE.match(f.attr):
            return LaunchInfo("step", ast.unparse(f))
        if isinstance(f, ast.Call) and self.is_module_ctor(f.func):
            return LaunchInfo("module", ast.unparse(f))
        key = ref_key(f)
        if key is None:
            return None
        if key[0] == "self":
            cls = enclosing_class(call)
            return self.module_bindings.get(("self", cls, key[1])) if cls else None
        for scope in scope_chain(call):
            info = self.module_bindings.get(("name", scope, key[1]))
            if info is not None:
                return info
            if isinstance(scope, FUNCTION_NODES) and key[1] in LAUNCH_PARAMS.get(scope.name, ()):
                params = {a.arg for a in scope.args.args + scope.args.kwonlyargs}
                if key[1] in params:
                    return LaunchInfo("dispatch", key[1])
            if binds_param(scope, key[1]):
                return None  # shadowed by a local of another kind
        return None

    def module_call(self, call: ast.Call) -> bool:
        info = self.launch_info_for_call(call)
        return info is not None and info.kind == "module"

    # -- local assignments -------------------------------------------------

    def assignments(self, scope: ast.AST) -> dict:
        """``{name: [value expr, ...]}`` of plain and unpacked assignments
        made directly in ``scope`` (unpacked ones map to ``("unpack",
        value, index)`` tuples)."""
        if scope in self._assigns:
            return self._assigns[scope]
        out: dict = {}
        nodes = iter_body(scope) if not isinstance(scope, ast.Module) else _module_level(scope)
        for node in nodes:
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, (ast.AnnAssign, ast.NamedExpr)) and node.value is not None:
                targets, value = [node.target], node.value
            else:
                continue
            for t in targets:
                if isinstance(t, ast.Name):
                    out.setdefault(t.id, []).append(value)
                elif isinstance(t, (ast.Tuple, ast.List)):
                    for i, e in enumerate(t.elts):
                        if isinstance(e, ast.Name):
                            out.setdefault(e.id, []).append(("unpack", value, i))
        self._assigns[scope] = out
        return out


def _module_level(tree: ast.Module) -> Iterator[ast.AST]:
    for node in ast.walk(tree):
        if enclosing_scope(node) is tree:
            yield node


def binds_param(scope: ast.AST, name: str) -> bool:
    """True when ``name`` is a parameter of ``scope`` (a function)."""
    if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        a = scope.args
        params = a.args + a.posonlyargs + a.kwonlyargs
        params += [x for x in (a.vararg, a.kwarg) if x is not None]
        return any(p.arg == name for p in params)
    return False


def link_project(models) -> None:
    """Share the project's ``nn.Module`` classes between the scanned
    modules: a class whose base is another module's nn.Module subclass
    (imported by name) is one too, and so is a re-export of one."""
    known = set(NN_MODULE_BASES)
    changed = True
    while changed:
        changed = False
        for m in models:
            found = m.local_nn_classes(known)
            for alias, target in m.aliases.items():
                if target in known and m.dotted:
                    found.add(f"{m.dotted}.{alias}")
            new = found - known
            if new:
                known |= new
                changed = True
    for m in models:
        m.nn_classes = known - NN_MODULE_BASES
        m._bindings = None


# ---------------------------------------------------------------------------
# Tensor kinds
# ---------------------------------------------------------------------------

#: torch factories that make a host tensor unless given ``device=``.
_HOST_FACTORIES = frozenset(
    f"torch.{n}"
    for n in (
        "from_numpy", "as_tensor", "tensor", "zeros", "ones", "empty", "full",
        "arange", "linspace", "eye", "rand", "randn", "randint", "randperm",
        "frombuffer",
    )
)
#: torch callables whose result is no tensor.
_NOT_TENSOR = (
    "torch.device", "torch.Generator", "torch.dtype", "torch.Size",
    "torch.no_grad", "torch.inference_mode", "torch.enable_grad",
    "torch.autocast", "torch.is_tensor", "torch.is_grad_enabled",
    "torch.get_default_dtype", "torch.manual_seed", "torch.cuda.",
    "torch.backends.", "torch.random.", "torch.distributed.", "torch.nn.",
    "torch.utils.", "torch.export.", "torch.jit.", "torch.compile",
    "torch.set_", "torch.use_", "torch.are_", "torch.get_", "torch.load",
    "torch.save", "torch.profiler.", "torch.finfo", "torch.iinfo", "torch.equal",
    "torch.allclose", "torch.is_nonzero",
)
#: Tensor methods whose result lives on the host (or is no tensor).
_HOST_METHODS = frozenset({"cpu", "numpy", "tolist", "item", "pin_memory"})
#: Attributes of a tensor that are metadata, not data.
_META_ATTRS = frozenset({"shape", "dtype", "device", "ndim", "is_cuda", "requires_grad", "layout", "grad_fn"})
#: Methods of a tensor that return metadata or no tensor.
_META_METHODS = frozenset({
    "size", "dim", "numel", "element_size", "data_ptr", "stride", "is_contiguous",
    "storage_offset", "get_device", "nelement", "record_stream", "register_hook",
    "backward", "copy_", "keys", "values", "items", "get",
})

DEVICE, HOST = "device", "host"


def _device_arg(call: ast.Call) -> Optional[str]:
    """DEVICE/HOST for a ``device=`` keyword (a ``"cpu"`` constant is host),
    None without one."""
    dev = kwarg(call, "device")
    if dev is None:
        return None
    if isinstance(dev, ast.Constant) and isinstance(dev.value, str) and dev.value.startswith("cpu"):
        return HOST
    return DEVICE


def _to_target(call: ast.Call) -> Optional[str]:
    """Where ``x.to(...)`` moves a tensor: HOST for ``"cpu"``, DEVICE for
    another device or ``device=``, None for a dtype-only move."""
    if call.keywords and kwarg(call, "device") is not None:
        return _device_arg(call)
    if not call.args:
        return None
    a = call.args[0]
    if isinstance(a, ast.Constant) and isinstance(a.value, str):
        return HOST if a.value.startswith("cpu") else DEVICE
    if isinstance(a, ast.Attribute) and a.attr in {"float32", "float16", "bfloat16", "int64", "int32",
                                                    "uint8", "bool", "float", "long", "half", "float64"}:
        return None
    return DEVICE


def tensor_kind(model: ModuleModel, expr: ast.AST, _depth: int = 0) -> Optional[str]:
    """DEVICE when ``expr`` statically holds a tensor that may live on the
    device, HOST when it holds a host tensor, None when it is not known to
    hold a tensor. Names resolve through the assignments of their scope
    chain (:func:`_name_kind`); a launch's result, a subscript of it, and
    torch arithmetic on device values are device values. A torch call on
    inputs of unknown kind is taken to be on the device."""
    if _depth > 12 or expr is None:
        return None
    d = _depth + 1
    if isinstance(expr, ast.Call):
        f = expr.func
        if model.launch_info_for_call(expr) is not None:
            return DEVICE
        name = model.resolve(f)
        if name is not None and name.startswith("torch."):
            if name.startswith(_NOT_TENSOR):
                return None
            if name in _HOST_FACTORIES:
                placed = _device_arg(expr)
                if placed is not None:
                    return placed
                if name in ("torch.as_tensor", "torch.tensor") and expr.args:
                    inner = tensor_kind(model, expr.args[0], d)
                    return inner if inner == DEVICE else HOST
                return HOST
            kinds = [tensor_kind(model, a, d) for a in _tensor_args(expr)]
            if HOST in kinds and DEVICE not in kinds:
                return HOST
            return DEVICE
        if name is not None and (name.startswith("numpy.") or name in ("float", "int", "bool", "len", "str")):
            return None
        if isinstance(f, ast.Attribute):
            recv = tensor_kind(model, f.value, d)
            if f.attr == "cuda":
                return DEVICE if recv is not None else None
            if recv is None:
                return None
            if f.attr in _HOST_METHODS:
                return HOST if f.attr in ("cpu", "pin_memory") else None
            if f.attr in _META_METHODS:
                return None
            if f.attr == "to":
                moved = _to_target(expr)
                return recv if moved is None else moved
            return recv
        return None
    if isinstance(expr, ast.Name):
        return _name_kind(model, expr, d)
    if isinstance(expr, ast.Subscript):
        return tensor_kind(model, expr.value, d)
    if isinstance(expr, ast.Attribute):
        if expr.attr in _META_ATTRS:
            return None
        if expr.attr in ("T", "mT", "real", "imag", "data", "grad"):
            return tensor_kind(model, expr.value, d)
        return None
    if isinstance(expr, ast.BinOp):
        kinds = (tensor_kind(model, expr.left, d), tensor_kind(model, expr.right, d))
        if DEVICE in kinds:
            return DEVICE
        return HOST if HOST in kinds else None
    if isinstance(expr, ast.UnaryOp):
        return tensor_kind(model, expr.operand, d)
    if isinstance(expr, ast.Compare):
        kinds = [tensor_kind(model, e, d) for e in [expr.left, *expr.comparators]]
        if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in expr.ops):
            return None
        if DEVICE in kinds:
            return DEVICE
        return HOST if HOST in kinds else None
    if isinstance(expr, ast.IfExp):
        kinds = {tensor_kind(model, expr.body, d), tensor_kind(model, expr.orelse, d)}
        return kinds.pop() if len(kinds) == 1 else None
    return None


def _tensor_args(call: ast.Call) -> list:
    out = []
    for a in call.args:
        if isinstance(a, (ast.List, ast.Tuple)):
            out.extend(a.elts)
        elif isinstance(a, (ast.ListComp, ast.GeneratorExp)):
            out.append(a.elt)
        elif isinstance(a, ast.Starred):
            continue
        else:
            out.append(a)
    return out


def _name_kind(model: ModuleModel, node: ast.Name, depth: int) -> Optional[str]:
    """The kind of a name from its assignments in the nearest scope that
    binds it: DEVICE or HOST when the assignments that decide anything
    agree (``x = self.net(x)`` after ``x = load(...)`` is DEVICE), None
    for a parameter or a disagreement. A name met again while it is being
    resolved (``x = x + 1``) decides nothing."""
    busy = model.__dict__.setdefault("_kind_busy", set())
    for scope in scope_chain(node):
        if binds_param(scope, node.id):
            return None  # a parameter: unknown
        values = model.assignments(scope).get(node.id)
        if not values:
            continue
        key = (id(scope), node.id)
        if key in busy:
            return None
        busy.add(key)
        try:
            kinds = set()
            for v in values:
                if isinstance(v, tuple):  # ("unpack", value, index)
                    _, value, i = v
                    if isinstance(value, ast.Call) and model.launch_info_for_call(value) is not None:
                        kinds.add(DEVICE)
                    elif isinstance(value, (ast.Tuple, ast.List)) and i < len(value.elts):
                        kinds.add(tensor_kind(model, value.elts[i], depth))
                else:
                    kinds.add(tensor_kind(model, v, depth))
        finally:
            busy.discard(key)
        kinds.discard(None)
        return kinds.pop() if len(kinds) == 1 else None
    return None


# ---------------------------------------------------------------------------
# Call resolution over the project
# ---------------------------------------------------------------------------


class FunctionIndex:
    """Every function definition of a set of modules, and the static
    resolution of a call to one of them: ``f()`` to a nested or
    module-level def (or, through the import aliases, another scanned
    module's), ``self.m()`` to a method of the enclosing class, and
    ``mod.f()`` through the aliases. Anything else is not resolved."""

    def __init__(self, models):
        self.model_of: dict = {}
        self.by_dotted: dict = {}
        for m in models:
            for node in ast.walk(m.tree):
                if isinstance(node, FUNCTION_NODES):
                    self.model_of[node] = m
            if m.dotted is None:
                continue
            for stmt in m.tree.body:
                if isinstance(stmt, FUNCTION_NODES):
                    self.by_dotted[f"{m.dotted}.{stmt.name}"] = stmt
                elif isinstance(stmt, ast.ClassDef):
                    for item in stmt.body:
                        if isinstance(item, FUNCTION_NODES):
                            self.by_dotted[f"{m.dotted}.{stmt.name}.{item.name}"] = item

    def resolve(self, model: ModuleModel, call: ast.Call):
        f = call.func
        if isinstance(f, ast.Name):
            for scope in scope_chain(call):
                if binds_param(scope, f.id):
                    return None
                body = scope.body if isinstance(scope, (ast.Module, *FUNCTION_NODES)) else []
                for stmt in _defs_in(body):
                    if stmt.name == f.id:
                        return stmt
        if (
            isinstance(f, ast.Attribute)
            and isinstance(f.value, ast.Name)
            and f.value.id == "self"
        ):
            cls = enclosing_class(call)
            if cls is None:
                return None
            for item in cls.body:
                if isinstance(item, FUNCTION_NODES) and item.name == f.attr:
                    return item
            return None
        name = model.qualify(f)
        return self.by_dotted.get(name) if name else None


def _defs_in(body) -> Iterator[ast.AST]:
    """Function definitions among ``body``'s statements, also those nested
    in its ``if``/``try``/``with`` blocks (not in nested scopes)."""
    stack = list(body)
    while stack:
        stmt = stack.pop()
        if isinstance(stmt, FUNCTION_NODES):
            yield stmt
        elif isinstance(stmt, (ast.If, ast.Try, ast.With, ast.For, ast.While)):
            for field in ("body", "orelse", "finalbody", "handlers"):
                for child in getattr(stmt, field, []):
                    if isinstance(child, ast.ExceptHandler):
                        stack.extend(child.body)
                    else:
                        stack.append(child)

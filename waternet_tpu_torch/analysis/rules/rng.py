"""R002 — rng-key-reuse, retargeted: a draw from a global generator.

JAX's keys are values, and its bug is consuming one twice. PyTorch's and
numpy's generators are state, and the bug of the same class is drawing
from the *process-global* one in library code: every other draw in the
process (a test, a data worker, another engine) moves the stream, so a
run's augmentation, init or shuffle is no longer a function of its seed,
and the byte-identical resume and replay guarantees
(tests/test_torch_resilience.py) hold only by luck.

The rule flags, in every scanned module:

* ``torch.rand``/``rand_like``/``randn``/``randn_like``/``randint``/
  ``randint_like``/``randperm``/``normal``/``bernoulli``/``multinomial``/
  ``poisson`` without ``generator=``;
* the in-place samplers ``Tensor.uniform_``/``normal_``/``bernoulli_``/
  ``random_``/``exponential_``/``geometric_``/``cauchy_``/``log_normal_``
  without ``generator=``, and ``torch.nn.init.*`` draws;
* ``np.random.<fn>`` draws from numpy's global ``RandomState``;
* ``torch.manual_seed``/``torch.random.manual_seed``/``torch.cuda.
  manual_seed*`` outside a ``with torch.random.fork_rng(...)`` block (it
  reseeds the caller's stream too).

The sanctioned idiom, the counterpart of ``fold_in``, is the port's own:
``with torch.random.fork_rng(devices=[]): torch.manual_seed(seed); ...``
(``training/trainer.py``, ``hub.py``, ``bench.py``). Every draw inside it
is clean, and so is parameter init in a module's constructor
(``nn.init.*`` in ``__init__``/``reset_parameters`` of an ``nn.Module``),
whose caller seeds it that way. Explicit generators (``torch.Generator``,
``np.random.default_rng``, ``np.random.Generator``) are always clean.
"""

from __future__ import annotations

import ast
from typing import Iterator

from waternet_tpu_torch.analysis.core import (
    FUNCTION_NODES,
    Finding,
    ModuleModel,
    enclosing,
    enclosing_class,
    in_context,
    kwarg,
)
from waternet_tpu_torch.analysis.registry import Rule, register

_TORCH_DRAWS = frozenset(
    f"torch.{n}"
    for n in (
        "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
        "randperm", "normal", "bernoulli", "multinomial", "poisson",
    )
)
_INPLACE_DRAWS = frozenset({
    "uniform_", "normal_", "bernoulli_", "random_", "exponential_", "geometric_",
    "cauchy_", "log_normal_",
})
#: numpy.random names that make an explicit generator (not draws).
_NP_EXPLICIT = frozenset({
    "default_rng", "Generator", "SeedSequence", "PCG64", "PCG64DXSM", "Philox",
    "SFC64", "MT19937", "RandomState", "BitGenerator",
})
_SEEDERS = frozenset({
    "torch.manual_seed", "torch.random.manual_seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all", "torch.seed",
})
FORK_RNG = frozenset({"torch.random.fork_rng", "torch.cuda.random.fork_rng"})
_INIT_NO_DRAW = frozenset({"zeros_", "ones_", "constant_", "eye_", "dirac_"})
_INIT_METHODS = frozenset({"__init__", "reset_parameters", "_reset_parameters", "_init_weights"})


def _in_module_init(model: ModuleModel, node: ast.AST) -> bool:
    """True inside ``__init__``/``reset_parameters`` of an nn.Module class."""
    fn = enclosing(node, FUNCTION_NODES)
    if fn is None or fn.name not in _INIT_METHODS:
        return False
    cls = enclosing_class(fn)
    if cls is None:
        return False
    qual = f"{model.dotted}.{cls.name}" if model.dotted else cls.name
    return qual in model.nn_classes


@register
class GlobalGeneratorDraw(Rule):
    id = "R002"
    name = "rng-key-reuse"
    description = (
        "a draw from a process-global generator (torch.rand*, in-place "
        "samplers, nn.init, np.random.<fn>) with no generator=, or "
        "torch.manual_seed outside torch.random.fork_rng"
    )

    def check(self, model: ModuleModel) -> Iterator[Finding]:
        for call in ast.walk(model.tree):
            if not isinstance(call, ast.Call):
                continue
            what = self._draw(model, call)
            if what is None or in_context(call, model, FORK_RNG):
                continue
            if what == "seed":
                yield self.finding(
                    model,
                    call,
                    f"`{model.resolve(call.func)}()` reseeds the process-global "
                    "generator, the caller's stream included; seed inside "
                    "`with torch.random.fork_rng(devices=[...]):`",
                )
                continue
            yield self.finding(
                model,
                call,
                f"{what} draws from the process-global generator: the result "
                "depends on every other draw in the process, not on a seed. "
                "Pass generator= (a seeded torch.Generator / np.random."
                "default_rng), or draw inside `with torch.random.fork_rng(): "
                "torch.manual_seed(seed)`",
            )

    @staticmethod
    def _draw(model: ModuleModel, call: ast.Call):
        name = model.resolve(call.func) or ""
        if name in _SEEDERS:
            return "seed"
        if name in _TORCH_DRAWS:
            return None if kwarg(call, "generator") is not None else f"`{name}()`"
        if name.startswith("torch.nn.init.") and name.endswith("_") and name[14:] not in _INIT_NO_DRAW:
            if kwarg(call, "generator") is not None or _in_module_init(model, call):
                return None
            return f"`{name}()`"
        if name.startswith("numpy.random."):
            fn = name[len("numpy.random."):]
            if "." in fn or fn in _NP_EXPLICIT:
                return None
            return f"`np.random.{fn}()`"
        f = call.func
        if (
            isinstance(f, ast.Attribute)
            and f.attr in _INPLACE_DRAWS
            and kwarg(call, "generator") is None
            and not name.startswith(("numpy.", "torch.nn.init."))
        ):
            if _in_module_init(model, call):
                return None
            return f"`.{f.attr}()`"
        return None

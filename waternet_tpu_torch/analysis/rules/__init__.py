"""The port's rule modules: importing this package registers every rule.

One module per rule family; see the rule table in
:mod:`waternet_tpu_torch.analysis` and the registration contract in
:mod:`waternet_tpu_torch.analysis.registry`.
"""

from waternet_tpu_torch.analysis.rules import (  # noqa: F401
    asynclint,
    concurrency,
    donation,
    hostsync,
    recompile,
    rng,
    tracerleak,
)

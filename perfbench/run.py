"""Entry point: ``python3 -m perfbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the repository's root (see
:mod:`perfbench.harness`)."""

import time

T_START = time.perf_counter()

if __name__ == "__main__":
    import os
    import sys
    from pathlib import Path

    # Kernel caches at a fixed path inside the checkout: torch's runtime-
    # compiled elementwise kernels here, the program's nvcc library in
    # build/kernels (its own fixed path).
    os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH",
                          str(Path(__file__).resolve().parent.parent / "build" / "torch_kernels"))
    from perfbench import harness

    sys.exit(harness.main(t_start=T_START))

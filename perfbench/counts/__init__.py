"""Operations and bytes the benchmark's work needs, computed from shapes:
the yardstick of every ``mfu`` and ``<kernel>_roofline`` metric, kept here
so that a change to the program cannot move it."""

"""Run one benchmark cell once:

    python3 -m tmbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of the repository, on a machine with the CUDA cards the
cell asks for. Prints the result as the last line of standard output.
"""
import sys
import time

_T = time.perf_counter()


def main(argv=None) -> int:
    """Entry point (see the module docstring)."""
    from tmbench import harness

    now, age = time.perf_counter(), harness.process_age_s()
    started = now - age if age is not None else _T
    return harness.main(argv, started=started)


if __name__ == "__main__":
    sys.exit(main())

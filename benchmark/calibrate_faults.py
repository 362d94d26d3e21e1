"""`run.py --calibrate` with the planted faults of the cell's reference
module beside the control's readings:

    python3 benchmark/calibrate_faults.py --workload <name> --seed <n> --seconds <s>

runs `benchmark/run.py` with `--calibrate` (its window, check and
`calibration` lines: the control, the half batch, the row shift, the
program), and after them prints one more `calibration {"variant": <fault>,
...}` line on standard error for each fault the configuration's reference
module names in `FAULTS`: the module's reference with that fault, put in
the program's place, against the stated reference, as the control is. A
module without `FAULTS` adds nothing. The last line of standard output is
run.py's.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    from benchmark import correct, run

    argv = list(sys.argv[1:] if argv is None else argv)
    real = correct.reference_outputs

    def with_faults(ref, snaps, variant):
        out = real(ref, snaps, variant)
        if variant == "half":  # run.py's last reference variant: the faults after it
            stated = real(ref, snaps, "stated")
            for fault in getattr(sys.modules[type(ref).__module__], "FAULTS", ()):
                got = correct.gaps(real(ref, snaps, fault), stated, snaps, None, None)
                print("calibration " + json.dumps({"variant": fault, **got}), file=sys.stderr)
        return out

    correct.reference_outputs = with_faults
    try:
        return run.main(argv + ["--calibrate"])
    finally:
        correct.reference_outputs = real


if __name__ == "__main__":
    sys.exit(main())

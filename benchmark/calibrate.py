"""The readings a cell's comparison limits are set from, on the card.

    python3 -m benchmark.calibrate --workload <cell> --seeds <n> [--faults 3]

For each seed, in one process: the program's readings (the set-up a run
of the cell makes and, for a train cell, one step after it; for an eval
one complete eval; held against the f32 reference) and the control's (the
reference computed with fp8 operands in every matrix product, in the
program's place, held against the f32 reference).  With --faults k, on
the first k seeds each fault of the cell's kind (its `FAULTS`), planted in
the program.  A state left unchanged reads 1 on the parameter change by
the measure's definition and needs no run.  One JSON line a reading; the
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from benchmark.drivers import load_kind
from benchmark.run import ROOT, cell_files, load_manifest


def readings(files, cfg, seed: int, device, control: bool,
             fault=None) -> dict:
    """{"program": numbers[, "control": numbers]} of one seed."""
    kind = load_kind(files["mix"]["kind"])
    driver = kind.Driver(files["meta"], cfg, files["mix"], seed, device)
    with (fault() if fault else contextlib.nullcontext()):
        driver.setup()
        return driver.readings(control)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--first-seed", type=int, default=3_000_000_000)
    parser.add_argument("--faults", type=int, default=3)
    parser.add_argument("--no-control", action="store_true")
    args = parser.parse_args(argv)
    from leccr_torch.config import LECCRConfig

    files = cell_files(load_manifest(ROOT), args.workload, ROOT)
    cfg = LECCRConfig.from_dict(files["meta"]["config"])
    faults = load_kind(files["mix"]["kind"]).FAULTS
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        line = {"seed": seed, **readings(files, cfg, seed, "cuda",
                                         not args.no_control)}
        print(json.dumps(line), flush=True)
        for fault in faults if i < args.faults else ():
            got = readings(files, cfg, seed, "cuda", False, fault)
            print(json.dumps({"seed": seed, "fault": fault.__name__,
                              **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

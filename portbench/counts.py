"""The frozen work counts of a configuration, taken once from its shapes on
its architecture's reference on the meta device (`count` in
portbench/archs/<arch>.py, with the helpers here), and written into the
configuration's file under "counts", with the architecture's COUNTED under
"counted":

    python -m portbench.counts portbench/configs/<config>.json

Operations: torch.utils.flop_counter.FlopCounterMode over the reference's
call (its matrix products, convolutions and attention products; a
multiply-add is 2). Bytes: every parameter and every input and output
tensor of the call once, at 2 bytes an element (bfloat16, the served
type). Every count is for one scene; a pass of N scenes does N times the
work, and a call over N scenes reads its parameters once:
bytes(N) = param_bytes + N * act_bytes. What each count covers is in the
architecture's file.
"""

from __future__ import annotations

import json
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

BYTES = 2  # bfloat16


def flops(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def numel(*ts) -> int:
    n = 0
    for t in ts:
        if isinstance(t, dict):
            n += numel(*t.values())
        elif isinstance(t, (list, tuple)):
            n += numel(*t)
        elif isinstance(t, torch.Tensor):
            n += t.numel()
    return n


def params(module) -> int:
    return sum(p.numel() for p in module.parameters())


def main(argv=None) -> int:
    from portbench import cells

    for path in argv if argv is not None else sys.argv[1:]:
        with open(path) as fp:
            config = json.load(fp)
        arch = cells.arch_of(config)
        config["counts"] = arch.count(config)
        config["counted"] = arch.COUNTED
        with open(path, "w") as fp:
            json.dump(config, fp, indent=1)
            fp.write("\n")
        print(path, json.dumps(config["counts"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())

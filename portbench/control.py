"""The readings that a cell's limits are set from, at the cell's own size:
the program's numbers over a dozen seeds or more, and the control's, the
reference computed in float8 (check.reference_model's fp8) in the
program's place, on three or more. One process reads every seed: the
program's model is built once and each seed's weights loaded into it.

    python -m portbench.control --workload gso15-b2 --seeds 101-112 \
        --control-seeds 201-203 --out control_gso15.json

For each seed the program serves the first pass of that seed's traffic
through the cell's entry, as a run's window does; the sampled scenes are
compared as a run compares them (portbench/check.py), and each seed's
numbers are judged against the cell's limits by the run's own verdict:
the program's seeds have to come out correct, the control's not. The
benchmark's runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from portbench import cells, check, weights


def parse_seeds(text: str) -> list:
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def readings(cell, seeds: list, control_seeds: list, device, log=print) -> dict:
    arch, m, inf = cell.arch, cell.config["model"], cell.config["inference"]
    N, gt = cell.traffic["scenes_per_pass"], cell.traffic["decodes_ground_truth"]
    entry = arch.ENTRIES[cell.traffic["entry"]]
    limits = cell.spec["limits"]
    out = dict(program={}, control={}, correct=dict(program={}, control={}), seconds={})
    model = None
    for seed in sorted(set(seeds) | set(control_seeds)):
        state = weights.make_state(arch, m, seed, device)
        p = arch.make_pass(m, inf, N, seed, 0, device)
        picks = [n for _, n in check.sample_scenes(cell, seed, 1)]
        t0 = time.perf_counter()
        if seed in seeds:
            model = arch.build(m, state, device) if model is None else arch.reload(model, state)
            got = entry(model, p, inf, [])
        t1 = time.perf_counter()
        ref = check.reference_model(arch, m, state, device)
        want = {n: check.reference_scene(arch, ref, inf, p, n, gt) for n in picks}
        del ref
        if seed in seeds:
            out["program"][seed] = check.worst([check.gaps(arch, {k: v[n] for k, v in got.items()}, want[n])
                                                for n in picks])
            out["correct"]["program"][seed] = check.verdict(out["program"][seed], limits)[0]
            del got
        t2 = time.perf_counter()
        if seed in control_seeds:
            ctl = check.reference_model(arch, m, state, device, fp8=True)
            out["control"][seed] = check.worst([check.gaps(arch, check.reference_scene(arch, ctl, inf, p, n, gt),
                                                           want[n])
                                                for n in picks])
            out["correct"]["control"][seed] = check.verdict(out["control"][seed], limits)[0]
            del ctl
        t3 = time.perf_counter()
        out["seconds"][seed] = dict(program=t1 - t0, reference=t2 - t1, control=t3 - t2)
        log(f"seed {seed} (scenes {picks}): program {out['program'].get(seed)} correct "
            f"{out['correct']['program'].get(seed)}; control {out['control'].get(seed)} correct "
            f"{out['correct']['control'].get(seed)}; seconds {out['seconds'][seed]}", flush=True)
        del state, p, want
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="101-112")
    ap.add_argument("--control-seeds", default="201-203")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the control's readings are taken on the card", file=sys.stderr)
        return 2
    cell = cells.load(a.workload)
    res = readings(cell, parse_seeds(a.seeds), parse_seeds(a.control_seeds), "cuda")
    res.update(workload=a.workload, device=torch.cuda.get_device_name(0))
    for side in ("program", "control"):
        vals = res[side].values()
        if vals:
            keys = next(iter(vals)).keys()
            print(side, {k: (min(v[k] for v in vals), max(v[k] for v in vals)) for k in keys},
                  "correct", sorted(set(res["correct"][side].values())), "limits", cell.spec["limits"])
    if a.out:
        with open(a.out, "w") as fp:
            json.dump(res, fp, indent=1, default=str)
    # the limits hold: every sound seed correct, every control seed not
    return int(not all(res["correct"]["program"].values()) or any(res["correct"]["control"].values()))


if __name__ == "__main__":
    sys.exit(main())

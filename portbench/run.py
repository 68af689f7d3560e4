"""Run one benchmark cell once on this machine's card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the port's model of the cell's architecture
(portbench/archs/<arch>.py) at its configuration with weights drawn on the
card from the seed, and serves one warm-up pass of the cell's traffic
(other values, the same shapes). The window then serves passes
back to back, a closed loop, until `--seconds` have passed; the pass
running at that moment finishes and counts. With --trace 1 the window is
followed by one profiled pass, whose trace the per-layer readers read.
After the window a sample of the served scenes, drawn from the seed, is
compared with the plain reference (portbench/check.py), the program freed
first. The last line of standard output is the result; the numbers
compared, each beside its limit, are the last lines of standard error.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import torch  # noqa: E402

from portbench import cells, check, program, trace, weights  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mvdfusion_tpu")


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Top-level names in sys.modules that the run must not hold, compared
    whole: mvdfusion_tpu_torch is not mvdfusion_tpu."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0


def host_clocks() -> tuple:
    """(this thread's CPU seconds, its voluntary and its involuntary context
    switches). Logged by pass, they tell a launching thread that ran slower
    from one that waited on the device or was put off its CPU."""
    ru = resource.getrusage(resource.RUSAGE_THREAD)
    return time.thread_time(), ru.ru_nvcsw, ru.ru_nivcsw


def serve(model, marks, cell, seed: int, index: int, device, purpose=weights.PASS) -> dict:
    """One pass of the cell's traffic through its entry; returns its
    outputs and timings."""
    inf = cell.config["inference"]
    p = cell.arch.make_pass(cell.config["model"], inf, cell.traffic["scenes_per_pass"], seed, index, device, purpose)
    timings = []
    marks.begin_pass()
    out = cell.arch.ENTRIES[cell.traffic["entry"]](model, p, inf, timings)
    marks.end_pass()
    return dict(outputs=out, timings=timings[0])


def profile_pass(model, marks, cell, seed: int, device) -> dict:
    """One pass under torch.profiler with the spans on; the trace's
    summary (trace.summarize) and the pass's host seconds. The trace is
    written under the cell's root, in .portbench/, while it is read."""
    from torch.profiler import ProfilerActivity, profile

    trace_dir = cell.root / ".portbench"
    trace_dir.mkdir(exist_ok=True)
    path = trace_dir / "trace.json"
    marks.spans = True
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else [])
    _sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with torch.autograd.profiler.record_function(trace.PREFIX + "pass"):
            serve(model, marks, cell, seed, 0, device, purpose=weights.TRACE)
        _sync(device)
        wall = time.perf_counter() - t0
    marks.spans = False
    prof.export_chrome_trace(str(path))
    try:
        out = trace.summarize(str(path))
    finally:
        path.unlink()
    out.update(wall_s=wall, passes=1, steps=out.get("span_calls", {}).get(trace.STEP, 0))
    return out


def run(cell, seed: int, seconds: float, traced: bool, device="cuda", t0: float = T0) -> dict:
    """One run of `cell`; returns the result's fields and the rows compared."""
    arch, m, inf = cell.arch, cell.config["model"], cell.config["inference"]
    N = cell.traffic["scenes_per_pass"]
    # ---- set-up: the kernels (built in a checkout's first run), the model
    # from the seed, one warm-up pass of every shape
    built_s = program.build_kernels(device)
    model = arch.build(m, weights.make_state(arch, m, seed, device), device)
    gc.collect()
    marks = trace.Marks(arch.modules(model), device)
    serve(model, marks, cell, seed, 0, device, purpose=weights.WARMUP)
    marks.passes.clear()
    _sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    # ---- the window
    start = time.perf_counter()
    setup_s = start - t0
    passes = []
    clocks = [host_clocks()]
    while True:
        served = serve(model, marks, cell, seed, len(passes), device)
        served["end_s"] = time.perf_counter() - start
        clocks.append(host_clocks())
        passes.append(served)
        if served["end_s"] >= seconds:
            break
    window_peak = _peak(device)
    step_ms = marks.step_ms()
    failed = sum(int(not all(bool(torch.isfinite(v[n]).all()) for v in p["outputs"].values()))
                 for p in passes for n in range(N))
    run_info = SimpleNamespace(
        cell=cell, setup_s=setup_s, window_s=passes[-1]["end_s"], passes=passes, scenes_per_pass=N,
        views=arch.views(inf), step_ms=step_ms, window_peak_bytes=window_peak, trace=None,
    )
    if traced:
        run_info.trace = profile_pass(model, marks, cell, seed, device)
    # ---- the check: the sampled scenes' outputs kept, the program freed
    t_check = time.perf_counter()
    picks = check.sample_scenes(cell, seed, len(passes))
    kept = {k: passes[k]["outputs"] for k, _ in picks}
    for p in passes:
        p.pop("outputs")
    marks.remove()
    del model, marks
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    state = weights.make_state(arch, m, seed, device)
    ref = check.reference_model(arch, m, state, device)
    del state
    gt = cell.traffic["decodes_ground_truth"]
    readings = []
    for k, n in picks:
        p = arch.make_pass(m, inf, N, seed, k, device)
        want = check.reference_scene(arch, ref, inf, p, n, gt)
        readings.append(check.gaps(arch, {key: v[n] for key, v in kept[k].items()}, want))
    numbers = check.worst(readings)
    correct, rows = check.verdict(numbers, cell.spec["limits"])
    ends = [0.0] + [p["end_s"] for p in passes]
    log("pass seconds " + " ".join(f"{b - a:.3f}" for a, b in zip(ends, ends[1:])))
    for i, what in enumerate(("host cpu seconds", "voluntary switches", "involuntary switches")):
        log(f"pass {what} " + " ".join(f"{b[i] - a[i]:.3g}" for a, b in zip(clocks, clocks[1:])))
    log(f"kernels built in {built_s:.3f} s of the set-up" if built_s else "kernels already built")
    log(f"setup {setup_s:.3f} s, window {run_info.window_s:.3f} s ({len(passes)} passes), trace "
        f"{run_info.trace['wall_s'] if run_info.trace else 0:.3f} s, check {time.perf_counter() - t_check:.3f} s "
        f"(scenes {picks})")
    return dict(info=run_info, correct=correct and failed == 0, rows=rows, attempted=len(passes) * N,
                failed=failed, peak=window_peak)


def metrics(cell, info, traced: bool) -> dict:
    """The cell's end-to-end metrics (untraced) or per-layer metrics
    (traced), each from its reader; a reader that finds nothing returns
    None and the metric is left out."""
    out = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = cells.reader(cell, m["name"])(info)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def result_line(cell, res: dict, traced: bool, device) -> dict:
    info = res["info"]
    dev = torch.device(device)
    line = dict(
        correct=bool(res["correct"]), attempted=res["attempted"], failed=res["failed"],
        metrics=metrics(cell, info, traced),
        device=dict(platform="gpu" if dev.type == "cuda" else dev.type,
                    kind=torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                    count=cell.entry["chips"] if dev.type == "cuda" else 0, memory_peak_bytes=int(res["peak"])),
    )
    if traced and info.trace:
        line["device"].update(busy_s=info.trace["busy_s"], window_s=info.trace["wall_s"])
        line["breakdown"] = dict(device_ops=info.trace["device_ops"], idle_gaps=info.trace["idle_gaps"])
    line["check"] = {k: {"value": v, "limit": lim} for k, v, lim in res["rows"]}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once on this machine's card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    # one CPU thread: OpenMP workers beside the launching thread made the
    # window slower and less steady on the card's shared host
    torch.set_num_threads(1)
    cell = cells.load(a.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"the cell needs {chips} CUDA device(s), this machine has {n}")
        return 3
    res = run(cell, a.seed, a.seconds, bool(a.trace), "cuda")
    line = result_line(cell, res, bool(a.trace), "cuda")
    found = forbidden_modules()
    if found:
        log(f"the run loaded {found}, which the program must not import")
        return 4
    for k, v in line["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(f"check correct {line['correct']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

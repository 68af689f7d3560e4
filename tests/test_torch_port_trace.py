"""The port's spans (mvdfusion_tpu_torch/utils/trace.py) on one sampler pass
of the tiny config on the CPU: what a pass records, how the records nest,
the step's launch count against ops/_lib.py's LAUNCHES, the profiler's
annotations, the step boundary events (through a stand-in for the CUDA
event on the CPU), and the ring's bound. The `gpu` tests hold the events
and eval_scenes' synchronisations on the card. This file imports no JAX:

    python -m pytest tests/test_torch_port_trace.py -m gpu -q --noconftest
"""

import collections
import json

import numpy as np
import pytest
import torch

from mvdfusion_tpu_torch.geometry.cameras import look_at_view_transform
from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion, ViewFusionConfig, randomize_
from mvdfusion_tpu_torch.ops import _lib
from mvdfusion_tpu_torch.pipeline import eval as peval
from mvdfusion_tpu_torch.pipeline import sampler
from mvdfusion_tpu_torch.utils import trace

N, STEPS, VIEWS = 2, 3, 4
METHOD = "quad"  # uniform timesteps take no S = 3 (make_ddim_timesteps gives four)
MODEL_SPANS = ("model.gridattn", "model.unet")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scenes(device):
    """A tiny model and the N scenes' (images, R, T, f, c) on `device`."""
    model = randomize_(ViewFusion(ViewFusionConfig().tiny(), device=device), seed=0).eval()
    R, T = look_at_view_transform(dist=1.5, elev=30.0, azim=np.linspace(0, 315, VIEWS) + 90)
    g = torch.Generator().manual_seed(1)
    stack = lambda a: torch.stack([torch.as_tensor(a)] * N).to(device)
    args = (torch.rand(N, VIEWS, 64, 64, 3, generator=g).to(device), stack(R), stack(T),
            torch.full((N, VIEWS, 2), 2.1875, device=device), torch.zeros(N, VIEWS, 2, device=device))
    return model, args


def _prepared(model, args):
    device = args[0].device
    idx = torch.tensor([0], device=device), torch.arange(1, VIEWS, device=device)
    prepared = [model.prepare_batch(*(a[n] for a in args), *idx) for n in range(N)]
    _, cams, in_lat, in_cams, clip_v = zip(*prepared)
    return cams, in_lat, in_cams, torch.stack(clip_v)


@pytest.fixture(scope="module")
def scenes():
    with torch.no_grad():
        model, args = _scenes("cpu")
        return model, _prepared(model, args)


def _one_pass(scenes, seed=0):
    model, (cams, in_lat, in_cams, clip_v) = scenes
    gens = [torch.Generator().manual_seed(seed + n) for n in range(N)]
    trace.clear()
    sampler.ddim_sample_scenes(model, cams, in_lat, in_cams, clip_v, 2.5, num_steps=STEPS, generators=gens,
                               method=METHOD)
    return trace.records()


def test_a_pass_records_its_spans(scenes, monkeypatch):
    """One pass at N = 2, S = 3: one sample.pass, 3 sample.step, 6
    model.gridattn and 3 model.unet, nested pass > step > {gridattn, unet}
    under one pass id, every span closed, no profiler; each step's launch
    count is LAUNCHES' own increase over it (a stand-in ddim_step launches
    i + 1 "kernels" at step i, since the CPU launches none)."""
    seen = []
    step = sampler.ddim_step

    def counting_step(ddim, x, eps, index, noise):
        i = STEPS - 1 - index
        before = sum(_lib.LAUNCHES.values())
        _lib.LAUNCHES["trace_test"] += i + 1
        seen.append(sum(_lib.LAUNCHES.values()) - before)
        return step(ddim, x, eps, index, noise)

    monkeypatch.setattr(sampler, "ddim_step", counting_step)
    total = sum(_lib.LAUNCHES.values())
    try:
        recs = _one_pass(scenes)
        total = sum(_lib.LAUNCHES.values()) - total
    finally:
        _lib.LAUNCHES.pop("trace_test", None)
    names = collections.Counter(r.name for r in recs)
    assert names == {"sample.pass": 1, "sample.step": STEPS, "model.gridattn": N * STEPS, "model.unet": STEPS}
    by_id = {r.id: r for r in recs}
    (pas,) = [r for r in recs if r.name == "sample.pass"]
    steps = [r for r in recs if r.name == "sample.step"]
    assert pas.parent is None and pas.step is None and pas.launches is None
    assert {r.pass_id for r in recs} == {pas.pass_id} and pas.pass_id is not None
    assert [s.step for s in steps] == list(range(STEPS))
    for r in recs:
        assert r.end_ns is not None and r.start_ns <= r.end_ns and r.host_ms >= 0 and not r.profiled
        if r.name == "sample.step":
            assert r.parent == pas.id
        elif r.name in MODEL_SPANS:
            parent = by_id[r.parent]
            assert parent.name == "sample.step" and r.step == parent.step
            assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
    for s in steps:
        kids = [r.name for r in recs if r.parent == s.id]
        assert kids == ["model.gridattn"] * N + ["model.unet"], kids
        assert pas.start_ns <= s.start_ns <= s.end_ns <= pas.end_ns
        assert s.start_event is None and s.device_ms() is None  # no CUDA device
    assert [s.launches for s in steps] == seen == [i + 1 for i in range(STEPS)]
    assert sum(seen) == total


def test_passes_take_new_ids_and_training_spans_have_none(scenes):
    a, b = _one_pass(scenes), _one_pass(scenes, seed=5)
    assert a[0].pass_id < b[0].pass_id
    model, (cams, in_lat, in_cams, clip_v) = scenes
    trace.clear()
    with torch.no_grad():
        draws = model.loss_draws(VIEWS - 1, "cpu", torch.Generator().manual_seed(0))
        x = torch.randn(VIEWS - 1, 16, 16, 5)
        model.apply_model(x, cams[0], in_lat[0], in_cams[0], clip_v[0], draws["t"], draws["jitter_noise"])
    recs = trace.records()
    assert [r.name for r in recs] == list(MODEL_SPANS)
    assert all(r.pass_id is None and r.step is None and r.parent is None for r in recs)


def test_profiler_annotations_nest(scenes, tmp_path):
    """Under torch.profiler (CPU activity) every span is an mvdf.* annotation
    in the exported chrome trace, nested pass > step > {gridattn, unet} in
    time, and its record says the profiler ran."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        recs = _one_pass(scenes)
    assert all(r.profiled for r in recs)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("name", "").startswith(trace.PREFIX)]
    spans = collections.defaultdict(list)
    for e in events:
        spans[e["name"][len(trace.PREFIX):]].append((e["ts"], e["ts"] + e["dur"]))
    assert {k: len(v) for k, v in spans.items()} == {"sample.pass": 1, "sample.step": STEPS,
                                                    "model.gridattn": N * STEPS, "model.unet": STEPS}
    inside = lambda iv, outer: any(a <= iv[0] and iv[1] <= b for a, b in outer)
    assert all(inside(iv, spans["sample.pass"]) for iv in spans["sample.step"])
    for name in MODEL_SPANS:
        assert all(inside(iv, spans["sample.step"]) for iv in spans[name])
    per_step = collections.Counter(next(i for i, (a, b) in enumerate(sorted(spans["sample.step"]))
                                        if a <= iv[0] <= b) for iv in spans["model.gridattn"])
    assert sorted(per_step.values()) == [N] * STEPS


def test_no_profiler_makes_no_record_function(scenes, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function made with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert len(_one_pass(scenes)) == 1 + STEPS * (N + 2)


class _StandInEvent:
    """A CUDA event's interface on the CPU: elapsed_time is the gap in
    record order, in ms."""

    made = []

    def __init__(self):
        self.at = len(_StandInEvent.made)
        self.synced = False
        _StandInEvent.made.append(self)

    def synchronize(self):
        self.synced = True

    def elapsed_time(self, end):
        assert end.synced
        return float(end.at - self.at)


def test_step_boundaries_share_one_event(monkeypatch):
    """On a CUDA device a pass of S steps records S + 1 events, a step's end
    the next step's start; a new pass starts on an event of its own; a
    plain span records none."""
    _StandInEvent.made = []
    monkeypatch.setattr(trace, "_event", lambda device: _StandInEvent())
    trace.clear()
    for _ in range(2):
        with trace.span("sample.pass", opens_pass=True):
            for i in range(STEPS):
                with trace.span("sample.step", step=i, device=torch.device("cuda")):
                    with trace.span("model.unet"):
                        pass
    assert len(_StandInEvent.made) == 2 * (STEPS + 1)
    steps = [r for r in trace.records() if r.name == "sample.step"]
    for a, b in zip(steps, steps[1:]):
        assert (b.start_event is a.end_event) == (a.pass_id == b.pass_id)
    assert [s.device_ms() for s in steps] == [1.0] * (2 * STEPS)
    assert all(r.start_event is None and r.end_event is None for r in trace.records() if r.name != "sample.step")


def test_ring_is_bounded():
    trace.clear()
    first = None
    for k in range(trace.RING + 10):
        with trace.span("x") as r:
            first = first or r.id
    recs = trace.records()
    assert len(recs) == trace.RING == 65536
    assert recs[0].id == first + 10 and recs[-1].id == first + trace.RING + 9
    trace.clear()


def test_a_span_closes_on_an_exception():
    trace.clear()
    with pytest.raises(ValueError):
        with trace.span("outer"):
            with trace.span("inner"):
                raise ValueError
    with trace.span("after") as r:
        pass
    assert r.parent is None and all(x.end_ns is not None for x in trace.records())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step events are CUDA events")
    return torch.device("cuda")


@pytest.mark.gpu
def test_step_events_on_the_card(cuda):
    """A pass on the card: S + 1 events on the stream, each step's device
    ms positive, their sum within the pass's synchronised wall; the port's
    kernels counted a step."""
    with torch.no_grad():
        model, args = _scenes(cuda)
        cams, in_lat, in_cams, clip_v = _prepared(model, args)
        run = lambda: sampler.ddim_sample_scenes(model, cams, in_lat, in_cams, clip_v, 2.5, num_steps=STEPS,
                                                 method=METHOD)
        run()
        torch.cuda.synchronize()
        trace.clear()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
    steps = [r for r in trace.records() if r.name == "sample.step"]
    assert len({id(s.start_event) for s in steps} | {id(s.end_event) for s in steps}) == STEPS + 1
    ms = [s.device_ms() for s in steps]
    assert all(m > 0 for m in ms) and sum(ms) <= start.elapsed_time(end)
    assert all(s.launches > 0 for s in steps) == _lib.launches(clip_v)


@pytest.mark.gpu
def test_eval_scenes_synchronises_only_for_timings(cuda, monkeypatch):
    calls = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: (calls.append(1), real(*a))[1])
    with torch.no_grad():
        model, args = _scenes(cuda)
        idx = torch.tensor([0], device=cuda), torch.arange(1, VIEWS, device=cuda)
        peval.eval_scenes(model, *args, *idx, 2.5, num_steps=2)  # uniform timesteps take no S = 3
        assert calls == []
        timings = []
        peval.eval_scenes(model, *args, *idx, 2.5, num_steps=2, timings=timings)
        assert len(calls) == 4 and set(timings[0]) == {"prepare", "sample", "decode"}

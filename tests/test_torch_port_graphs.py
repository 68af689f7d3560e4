"""GridAttn's CUDA graph path on the CPU (nn/viewattn.py, utils/graphs.py,
geometry/rays.py): the pixel grid made once on its device and bit-equal to
ndc_pixel_grid, the key a graph is cached under, the eager body taken on
the CPU and under autograd, the cache's plumbing through a stand-in for
the graph, and the benchmark's reader of the graph spans
(portbench/metrics/gridattn_graph_share.py) on a stand-in ring. The card's
cases are in tests/test_torch_port_gpu.py. This file imports no JAX."""

import sys
import types

import numpy as np
import pytest
import torch

from mvdfusion_tpu_torch.core.schedule import make_ddpm_schedule
from mvdfusion_tpu_torch.geometry import rays
from mvdfusion_tpu_torch.geometry.cameras import look_at_view_transform, make_cameras, unproject_points
from mvdfusion_tpu_torch.nn import viewattn
from mvdfusion_tpu_torch.nn.viewattn import GridAttn
from mvdfusion_tpu_torch.ops import _lib
from mvdfusion_tpu_torch.utils import trace
from portbench import program_spans
from portbench.metrics import gridattn_graph_share

GRAPH_SPANS = ("gridattn.capture", "gridattn.replay")


def _old_pixel_rays(cams, height, width):
    """pixel_rays as it was: the grid copied from the host on every call."""
    B = len(cams)
    xy = torch.as_tensor(rays.ndc_pixel_grid(height, width), device=cams.R.device)
    xy = xy.reshape(1, height * width, 2).expand(B, -1, -1)
    one = torch.ones_like(xy[..., :1])
    p1 = unproject_points(cams, torch.cat([xy, one], dim=-1))
    p2 = unproject_points(cams, torch.cat([xy, 2.0 * one], dim=-1))
    d = p2 - p1
    return (p1 - d).reshape(B, height, width, 3), d.reshape(B, height, width, 3), xy[0].reshape(height, width, 2)


def _cameras(n, seed, offset=0.0):
    R, T = look_at_view_transform(dist=1.5, elev=20.0 + seed, azim=np.linspace(0, 315, n) + 90 + offset)
    g = torch.Generator().manual_seed(seed)
    return make_cameras(R, T, 2.1875 + 0.1 * torch.rand(n, 2, generator=g), 0.01 * torch.randn(n, 2, generator=g))


@pytest.mark.parametrize("H,W", [(16, 16), (32, 32), (8, 12)])
def test_pixel_grid_made_once_and_rays_unchanged(H, W, monkeypatch):
    made = []
    grid = rays.ndc_pixel_grid
    monkeypatch.setattr(rays, "ndc_pixel_grid", lambda h, w: (made.append((h, w)), grid(h, w))[1])
    rays.pixel_grid.cache_clear()
    try:
        cams = _cameras(3, 0)
        got = [rays.pixel_rays(cams, H, W) for _ in range(3)]
        assert made == [(H, W)]
        assert rays.pixel_grid(H, W, torch.device("cpu")) is rays.pixel_grid(H, W, torch.device("cpu"))
        assert torch.equal(rays.pixel_grid(H, W, torch.device("cpu")), torch.as_tensor(grid(H, W)))
        want = _old_pixel_rays(cams, H, W)
        for r in got:
            assert all(torch.equal(a, b) for a, b in zip((r.origins, r.directions, r.xys), want))
    finally:
        rays.pixel_grid.cache_clear()


# ---------------------------------------------------------------- GridAttn
V, LS, HID = 3, 8, 32


@pytest.fixture(scope="module")
def attn():
    torch.manual_seed(0)
    m = GridAttn(hidden_size=HID, output_dim=16, num_heads=4, num_layers=2)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape) * (p.shape[-1] ** -0.5 if p.ndim == 2 else 0.02))
    return m


SCHED = make_ddpm_schedule(1000, 0.00085, 0.0120)


def _args(seed, n=V, ls=LS, overwrite=False, fuse_mode="auto", views=None):
    """forward's arguments for n target views of ls^2 latents, from `seed`."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    t = torch.full((n,), 100 + seed, dtype=torch.long)
    return (r(n, ls, ls, 5), _cameras(n, seed), torch.ones(n), r(n, HID), t, SCHED, r(1, ls, ls, 5),
            _cameras(1, seed + 1, offset=30.0), r(n, ls, ls, 1), r(n, ls, ls, 1) if overwrite else None,
            fuse_mode, views)


KEY_CASES = {
    "values": (lambda: _args(7), False),  # other latents, cameras, t, t_embed, jitter: the same key
    "views": (lambda: _args(0, views=slice(0, 2)), True),
    "shape V": (lambda: _args(0, n=V + 1), True),
    "shape H, W": (lambda: _args(0, ls=2 * LS), True),
    "fuse_mode": (lambda: _args(0, fuse_mode="never"), True),
    "overwrite": (lambda: _args(0, overwrite=True), True),
}


@pytest.mark.parametrize("case", list(KEY_CASES))
def test_graph_key_changes_with_what_the_body_fixes(attn, case):
    make, differs = KEY_CASES[case]
    base = attn.graph_key(*_args(0))
    assert attn.graph_key(*_args(0)) == base
    assert (attn.graph_key(*make()) != base) == differs


def test_graph_key_changes_with_the_kernel_off_switch(attn):
    base = attn.graph_key(*_args(0))
    with _lib.plain_versions():
        assert attn.graph_key(*_args(0)) != base
    assert attn.graph_key(*_args(0)) == base


@pytest.mark.parametrize("how", ["copy_ same values", "copy_ new values", "new tensor"])
def test_graph_key_changes_with_a_weight_reload(how):
    m = GridAttn(hidden_size=HID, output_dim=16, num_heads=4, num_layers=2)
    before = m.graph_key(*_args(0))
    p = m.aggregation_transformer.layer_list[1].mlp.fc2.weight
    with torch.no_grad():
        if how == "new tensor":
            p.data = p.data.clone()
        else:
            p.copy_(p if how == "copy_ same values" else p + 1)
    after = m.graph_key(*_args(0))
    assert after != before and after[:-1] == before[:-1]


@pytest.mark.parametrize("grad", [False, True])
def test_cpu_and_autograd_take_the_eager_body(attn, grad, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA graph made on the CPU")

    monkeypatch.setattr(viewattn, "Graphed", refuse)
    args = _args(3, overwrite=True)
    assert not viewattn.graphable(args[0])
    trace.clear()
    with torch.set_grad_enabled(grad):
        got = attn(*args)
        want = attn.eager_forward(*args)
    assert got.requires_grad == grad and torch.equal(got, want)
    assert not [r for r in trace.records() if r.name in GRAPH_SPANS]


class _StandInGraph:
    """Graphed's interface on the CPU: static copies of the inputs, fn run
    again on them at each call (a replay), the output copied out."""

    made = 0

    def __init__(self, fn, inputs):
        _StandInGraph.made += 1
        self.fn, self.keep = fn, ()
        self.inputs = [None if x is None else x.clone() for x in inputs]

    def __call__(self, inputs):
        for s, x in zip(self.inputs, inputs):
            if s is not None:
                s.copy_(x)
        return self.fn(*self.inputs).clone()


def test_graph_cache_through_a_stand_in(monkeypatch):
    """With graphable forced on the CPU and the stand-in for the graph: the
    first call of a key captures and later calls replay, each equal to the
    eager body on its own inputs (cameras, t, row 0 of t_embed, jitter and
    the overwrite reach the body in order); the oldest key goes past
    MAX_GRAPHS; a weight reload drops the old weights' graphs."""
    m = GridAttn(hidden_size=HID, output_dim=16, num_heads=4, num_layers=2)
    monkeypatch.setattr(viewattn, "graphable", lambda x: True)
    monkeypatch.setattr(viewattn, "Graphed", _StandInGraph)
    _StandInGraph.made = 0
    trace.clear()
    with torch.no_grad():
        for seed in range(3):
            for overwrite in (False, True):
                args = _args(seed, overwrite=overwrite)
                assert torch.equal(m(*args), m.eager_forward(*args))
        names = [r.name for r in trace.records()]
        assert names == ["gridattn.capture"] * 2 + ["gridattn.replay"] * 4
        assert _StandInGraph.made == 2 and len(m._graphs) == 2
        assert viewattn.MAX_GRAPHS == 4
        for n in range(1, 6):  # 1 and 2 new, 3 replays the V = 3 key, 4 and 5 evict the oldest uses
            m(*_args(0, n=n))
        assert [k[0][0][0][0] for k in m._graphs] == [2, 3, 4, 5]
        assert [k[0][-1] for k in m._graphs] == [None] * 4  # the V = 3 graph with the overwrite went first
        kept = list(m._graphs.values())
        m.final_layer_b.bias.add_(1.0)
        args = _args(9)
        assert torch.equal(m(*args), m.eager_forward(*args))
        assert len(m._graphs) == 1 and all(g not in m._graphs.values() for g in kept)
        assert m(*args).shape == (V, LS, LS, 1, 16)


# ------------------------------------------------------- the benchmark's reader
def _record(name, pass_id, step=None, profiled=False):
    return types.SimpleNamespace(name=name, pass_id=pass_id, step=step, end_ns=1, profiled=profiled)


def _ring(calls_per_step, replays, graphs=True):
    """A warm-up pass that captured, then two window passes of two steps
    with `calls_per_step` GridAttn calls each, `replays` of all of them
    replayed; `graphs=False`: a program without the graph spans."""
    recs = [_record("sample.pass", 1), _record("sample.step", 1, 0), _record("model.gridattn", 1, 0)]
    if graphs:
        recs.append(_record("gridattn.capture", 1, 0))
    left = replays
    for pid in (2, 3):
        recs.append(_record("sample.pass", pid))
        for s in range(2):
            recs.append(_record("sample.step", pid, s))
            for _ in range(calls_per_step):
                recs.append(_record("model.gridattn", pid, s))
                if left > 0:
                    recs.append(_record("gridattn.replay", pid, s))
                    left -= 1
            recs.append(_record("model.unet", pid, s))
    return types.SimpleNamespace(records=lambda: recs)


@pytest.mark.parametrize("calls,replays", [(2, 8), (4, 12), (2, 0)])
def test_gridattn_graph_share_reads_replays_over_calls(calls, replays, monkeypatch):
    monkeypatch.setitem(sys.modules, program_spans.MODULE, _ring(calls, replays))
    run = types.SimpleNamespace(passes=[None, None])
    assert gridattn_graph_share.read(run) == 100.0 * replays / (4 * calls)


def test_gridattn_graph_share_without_a_ring_or_graph_spans(monkeypatch):
    run = types.SimpleNamespace(passes=[None, None])
    monkeypatch.delitem(sys.modules, program_spans.MODULE, raising=False)
    assert gridattn_graph_share.read(run) is None
    monkeypatch.setitem(sys.modules, program_spans.MODULE, _ring(2, 0, graphs=False))
    assert gridattn_graph_share.read(run) is None
    monkeypatch.setitem(sys.modules, program_spans.MODULE, _ring(2, 8))
    assert gridattn_graph_share.read(types.SimpleNamespace(passes=[None] * 4)) is None  # the ring lacks the window


def test_counted_adds_the_replays():
    _lib.reset_launches()
    try:
        _lib.LAUNCHES["crossview"] += 1
        with _lib.uncounted() as got:
            _lib.LAUNCHES["crossview"] += 1
            _lib.GEMM_SHAPES[("sm90", 1, 2, 3)] += 10
        assert _lib.LAUNCHES == {"crossview": 1} and not _lib.GEMM_SHAPES
        assert got["LAUNCHES"] == {"crossview": 1} and got["GEMM_SHAPES"] == {("sm90", 1, 2, 3): 10}
        _lib.count_replay(got)
        _lib.count_replay(got)
        assert _lib.LAUNCHES == {"crossview": 1}
        assert _lib.counted() == {"crossview": 3} and _lib.counted("GEMM_SHAPES") == {("sm90", 1, 2, 3): 20}
    finally:
        _lib.reset_launches()
    assert not _lib.counted() and not _lib.REPLAYED["GEMM_SHAPES"]

"""The port's named ranges and counters, on the CPU: every range a serving
batch and a train step open has a name of utils/profiling.SPANS and of
the benchmark's trace readers (bench_port/harness/trace.py lists the five
stages, which the accepted harness reads; bench_port/harness/spans.py the
detail spans too), with the detail spans closed unless switched on; the
children nest inside their stage; the source opens ranges only through
profiling.span; ICP's per-stage counts are exact with one host read a
block; and HOST_READS counts the reads a CPU train step makes."""
import ast
import contextlib
import pathlib
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_parity import CAPS, SMALL_CFG, WEIGHTS, t
from umeregrobust_tpu_torch.data.suite import small_pair
from umeregrobust_tpu_torch.models.resunet import ARCHS
from umeregrobust_tpu_torch.models.weights import load_model
from umeregrobust_tpu_torch.ops.densegrid import build_dense_grid
from umeregrobust_tpu_torch.pipeline import icp
from umeregrobust_tpu_torch.pipeline.e2e import register_pairs_batched
from umeregrobust_tpu_torch.pipeline.registration import (
    RegistrationConfig, refine_with_icp)
from umeregrobust_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "umeregrobust_tpu_torch"


def _tuple_of(path: pathlib.Path, name: str) -> tuple:
    """A module-level tuple of strings, read from the source (the
    benchmark's modules are not imported here); `trace.SPANS + (...)` is
    followed into harness/trace.py."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and node.targets[0].id == name:
            v = node.value
            if isinstance(v, ast.BinOp):  # trace.SPANS + (...)
                return (_tuple_of(path.parent / "trace.py", name)
                        + ast.literal_eval(v.right))
            return ast.literal_eval(v)
    raise KeyError(name)


ACCEPTED = _tuple_of(ROOT / "bench_port" / "harness" / "trace.py", "SPANS")
EXTENDED = _tuple_of(ROOT / "bench_port" / "harness" / "spans.py", "SPANS")


@contextlib.contextmanager
def detail(on):
    prev = profiling.detail_spans(on)
    try:
        yield
    finally:
        profiling.detail_spans(prev)


def _annotations(prof):
    """Names of the user annotations (record_function ranges) opened."""
    kineto = prof.profiler.kineto_results.events()
    return {e.name() for e in kineto if e.is_user_annotation()}


@pytest.fixture(scope="module")
def serving():
    """A traced two-pair batch with the detail spans closed, then open
    (the raw stage on the correlator clouds, a multires stage)."""
    cfg = RegistrationConfig(**dict(SMALL_CFG, consensus_gate_inliers=0.3,
                                    icp_multires=256))
    pairs = [small_pair(s) for s in (42, 7)]
    keys = (("src", "coords"), ("src", "grid"), ("src", "mask"),
            ("tgt", "coords"), ("tgt", "grid"), ("tgt", "mask"),
            ("src", "corr_pts"), ("src", "corr_mask"),
            ("tgt", "corr_pts"), ("tgt", "corr_mask"))
    arrays = [np.stack([p[a][b] for p in pairs]) for a, b in keys]
    model = load_model(WEIGHTS, ARCHS["ResUNetSmall2"], device="cpu")
    out = {}
    for on in (False, True):
        with detail(on), profile(activities=[ProfilerActivity.CPU]) as p:
            out[on] = register_pairs_batched(
                model, CAPS, cfg, *arrays, *arrays[6:10],
                compute_dtype=torch.float32,
                generators=[torch.Generator().manual_seed(i)
                            for i in range(2)], device="cpu")
        out[on, "names"] = _annotations(p)
        out[on, "ranges"] = [(e.name, e.thread, e.time_range.start,
                              e.time_range.end) for e in p.events()
                             if e.name in out[on, "names"]]
    return out


def test_closed_detail_spans_leave_the_accepted_five(serving):
    """With the detail spans closed (the default) a batch opens the five
    stages alone: names the accepted trace reader knows, so none of their
    device-row copies is read as a kernel."""
    assert not profiling.detail_spans(False)  # closed by default
    assert serving[False, "names"] == set(profiling.STAGE_SPANS)
    assert serving[False, "names"] <= set(ACCEPTED)


def test_open_detail_spans_are_listed_by_both_tuples(serving):
    names = serving[True, "names"]
    assert names <= set(profiling.SPANS) and names <= set(EXTENDED)
    assert set(profiling.SPANS) <= set(EXTENDED)
    assert set(profiling.STAGE_SPANS) <= set(ACCEPTED)
    assert {"inputs", "hypotheses.keypoints", "hypotheses.ume",
            "hypotheses.match", "hypotheses.score", "hypotheses.consensus",
            "icp.grids", "icp.multires", "icp.exact", "icp.raw"} <= names
    # the spans change no result
    for a, b in zip(serving[False][:2], serving[True][:2]):
        assert torch.equal(a, b)


def test_children_nest_inside_their_stage(serving):
    ranges = serving[True, "ranges"]
    for name, thread, a, b in ranges:
        if "." not in name:
            continue
        parent = name.split(".")[0]
        assert any(p == parent and th == thread and pa <= a and b <= pb
                   for p, th, pa, pb in ranges), name
    # the stages follow one another in the path's order
    first = {}
    for name, _, a, _ in ranges:
        first.setdefault(name, a)
    order = ["inputs", "geometry", "forward", "feat_to_raw", "hypotheses",
             "icp"]
    assert [first[n] for n in order] == sorted(first[n] for n in order)
    stages = ["icp.grids", "icp.multires", "icp.exact", "icp.raw"]
    assert [first[n] for n in stages] == sorted(first[n] for n in stages)


def test_the_source_opens_ranges_through_span_alone():
    """Only utils/profiling.py calls record_function; every span(...)
    names a listed span: a literal, or "icp." and one of ICP's stages."""
    prefixed = 0
    for path in PKG.rglob("*.py"):
        text = path.read_text()
        if path.name != "profiling.py":
            assert "record_function" not in text, path
        for node in ast.walk(ast.parse(text)):
            if not (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == "span"):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                assert arg.value in profiling.SPANS, (path, arg.value)
            else:  # refine_with_icp's "icp." + stage
                assert ast.literal_eval(arg.left) == "icp.", path
                prefixed += 1
    assert prefixed == 1
    assert {"icp." + s for s in icp.STAGES if s != "other"} <= set(
        profiling.SPANS)


def test_span_refuses_an_unlisted_name():
    with pytest.raises(ValueError):
        profiling.span("icp.block")
    with detail(True):
        assert isinstance(profiling.span("icp.exact"),
                          torch.profiler.record_function)
    assert not isinstance(profiling.span("icp.exact"),
                          torch.profiler.record_function)
    assert isinstance(profiling.span("icp"), torch.profiler.record_function)


def _rot_z(a, tr):
    T = np.eye(4, dtype=np.float32)
    T[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    T[:3, 3] = tr
    return T


def _surface_pair(seed, S=600, T=700):
    """A wavy surface and its moved noisy copy (tests/test_torch_batched.py
    and tests/test_torch_icp.py use the same model)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-10, 10, (T, 2))
    z = 0.6 * np.sin(xy[:, 0] * 0.7) + 0.4 * np.cos(xy[:, 1] * 0.9)
    tgt = np.concatenate([xy, z[:, None]], 1).astype(np.float32)
    gt = _rot_z(0.3, [0.8, -0.5, 0.05])
    inv = np.linalg.inv(gt)
    src = (tgt[:S] @ inv[:3, :3].T + inv[:3, 3]
           + rng.normal(scale=0.01, size=(S, 3))).astype(np.float32)
    return src, rng.random(S) > 0.05, tgt, rng.random(T) > 0.05, gt


class _Reads(TorchDispatchMode):
    """Counts the host reads of tensor values (aten::_local_scalar_dense,
    what bool() / int() / float() of a tensor call)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten._local_scalar_dense.default
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def two_pairs():
    """Two pairs whose own ICP runs stop after different block counts."""
    (s0, sm0, t0, tm0, gt0), (s1, sm1, t1, tm1, gt1) = (_surface_pair(5),
                                                         _surface_pair(6))
    inits = [gt0 @ _rot_z(0.004, [0.02, 0.0, 0.0]),
             gt1 @ _rot_z(0.05, [0.3, -0.2, 0.0])]
    grid = build_dense_grid(t(np.stack([t0, t1])), t(np.stack([tm0, tm1])),
                            0.4, (64, 64, 16))
    return (t(np.stack([s0, s1])), t(np.stack([sm0, sm1])), grid,
            t(np.stack(inits)))


@pytest.mark.parametrize("stage", ["exact", "raw"])
def test_icp_counts_are_exact_with_one_read_a_block(two_pairs, stage):
    """B = 2, one pair converging a block before the other: blocks =
    the later pair's, pair-blocks = 2 x blocks, live pair-blocks = the
    blocks each pair ran unconverged (its sub-iterations / inner), each
    counted under its stage alone, with one host read a block."""
    src, smask, grid, init = two_pairs
    before = dict(icp.COUNTS)
    with _Reads() as reads:
        _, _, _, iters = icp.icp_loop(src, smask, grid, init, 0.4, 60, 16,
                                      inner=4, disp_exit=1e-4, stage=stage)
    delta = {k: icp.COUNTS[k] - before[k] for k in icp.COUNTS}
    own = [int(i) // 4 for i in iters]
    assert own[0] != own[1]  # one pair stops a block before the other
    assert delta[f"blocks.{stage}"] == max(own) == reads.n
    assert delta[f"pair_blocks.{stage}"] == 2 * max(own)
    assert delta[f"live_pair_blocks.{stage}"] == sum(own)
    assert sum(delta.values()) == delta[f"blocks.{stage}"] + delta[
        f"pair_blocks.{stage}"] + delta[f"live_pair_blocks.{stage}"]


def test_refine_counts_each_stage_of_the_schedule():
    """refine_with_icp's multires, exact and raw stages, each counted
    under its own name; no coarse stage (cfg.icp_coarse_corr is None)."""
    before = dict(icp.COUNTS)
    cfg = RegistrationConfig(**dict(SMALL_CFG, icp_multires=256))
    pairs = [small_pair(s) for s in (42, 7)]
    pts = t(np.stack([p["src"]["corr_pts"] for p in pairs]))
    msk = t(np.stack([p["src"]["corr_mask"] for p in pairs]))
    tp = t(np.stack([p["tgt"]["corr_pts"] for p in pairs]))
    tm = t(np.stack([p["tgt"]["corr_mask"] for p in pairs]))
    T0 = t(np.stack([p["gt"] for p in pairs]).astype(np.float32))
    _, _, _, iters = refine_with_icp(cfg, T0, pts, msk, tp, tm, pts, msk,
                                     tp, tm, return_iters=True)
    delta = {k: icp.COUNTS[k] - before[k] for k in icp.COUNTS}
    for stage, it in zip(("multires", "exact", "raw"), iters):
        own = [int(i) // cfg.icp_inner for i in it]
        assert delta[f"blocks.{stage}"] == max(own)
        assert delta[f"live_pair_blocks.{stage}"] == sum(own)
    assert delta["blocks.coarse"] == delta["blocks.other"] == 0


class _StepReads(TorchDispatchMode):
    """The reads a step makes, by the port's sites: host reads of tensor
    values and boolean-mask selections (aten::index / index_put_ with a
    bool index), outside the CPU stand-ins of the card's kernels (the
    *_plain functions, whose selections the card's kernels do not make)."""

    def __init__(self):
        super().__init__()
        self.reads = self.selections = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        aten = torch.ops.aten
        if func is aten._local_scalar_dense.default:
            self.reads += 1
        elif func in (aten.index.Tensor, aten.index_put_.default,
                      aten.index_put.default) and any(
                i is not None and i.dtype == torch.bool for i in args[1]):
            f = sys._getframe(1)
            while f is not None and "umeregrobust_tpu_torch" not in \
                    f.f_code.co_filename:
                f = f.f_back
            self.selections += not (f is not None
                                    and f.f_code.co_name.endswith("_plain"))
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def tiny_step():
    """The train step of a tiny B = 2 fp32 configuration on the CPU, its
    batch and its model, after one step (the optimizer's state made)."""
    from umeregrobust_tpu_torch.data.synthetic import (
        SceneConfig, make_collated_batch)
    from umeregrobust_tpu_torch.models.resunet import init_resunet
    from umeregrobust_tpu_torch.train.trainer import (
        TrainConfig, batch_to_device, make_optimizer, make_train_step)

    cfg = TrainConfig(batch_size=2, max_pc_size=1024, num_pw_samples=64,
                      ume_n_samples=16, ume_max_nn=64, ume_min_nn=8,
                      ume_r_nn=4.0, compute_dtype="float32",
                      level_capacity_ratios=(1.0, 1.0, 0.8, 0.5, 0.25))
    batch = make_collated_batch(
        SceneConfig(extent=10.0, ground_points=1500, structure_points=2500,
                    n_boxes=6, n_walls=2, n_poles=3, dropout=0.2),
        n_pairs=2, max_pc_size=cfg.max_pc_size,
        num_matches=cfg.num_pw_samples, seed=0)
    model = init_resunet(ARCHS[cfg.arch], 1, 32,
                         generator=torch.Generator().manual_seed(0),
                         device="cpu")
    step, _ = make_train_step(cfg, model,
                              make_optimizer(cfg, model.parameters()))
    step(batch_to_device(batch, "cpu"))
    return lambda: step(batch_to_device(batch, "cpu")), model


def test_a_train_step_opens_its_listed_spans(tiny_step):
    """Closed, a step opens no range of the port (PyTorch opens its
    optimizer's two); open, it opens the step's parts, each listed by both
    tuples, with its backward launched inside "step.backward"."""
    run, _ = tiny_step
    torch_own = {"Optimizer.step#OptaxAdam.step",  # PyTorch's, not the port's
                 "Optimizer.zero_grad#OptaxAdam.zero_grad"}
    assert torch_own <= set(EXTENDED)
    with profile(activities=[ProfilerActivity.CPU]) as p:
        run()
    assert _annotations(p) == torch_own
    with detail(True), profile(activities=[ProfilerActivity.CPU]) as p:
        run()
    names = _annotations(p) - torch_own
    assert names == {"step.inputs", "step.geometry", "step.forward",
                     "step.keypoints", "step.umes", "step.losses",
                     "step.backward", "step.grad_check", "step.metrics"}
    assert names <= set(profiling.SPANS) and names <= set(EXTENDED)
    # the autograd engine's work begins inside step.backward
    ranges = [(e.name, e.time_range.start, e.time_range.end)
              for e in p.events()]
    bwd = [(a, b) for n, a, b in ranges if n == "step.backward"]
    engine = [a for n, a, _ in ranges if n.startswith("autograd::engine")]
    assert engine and all(any(lo <= a <= hi for lo, hi in bwd)
                          for a in engine)


def test_host_reads_count_the_reads_a_cpu_train_step_makes(tiny_step):
    """A CPU train step's HOST_READS: one read a metric, the finite check,
    the geometry's boolean-mask selections; Adam's step counter lives on
    the host (no device read) and the copies to the card and the card's
    SVD waits count only on the card."""
    from umeregrobust_tpu_torch.train.trainer import HOST_READS

    run, model = tiny_step
    before = dict(HOST_READS)
    with _StepReads() as seen:
        metrics = run()
    delta = {k: v - before.get(k, 0) for k, v in HOST_READS.items()
             if v != before.get(k, 0)}
    n_params = sum(p.grad is not None for p in model.parameters())
    assert metrics["nonfinite_grad"] == 0.0
    assert delta["trainer.metrics"] == len(metrics) - 1
    assert delta["trainer.grad_check"] == 1
    assert sum(delta.values()) == seen.reads - n_params + seen.selections
    assert set(delta) == {"trainer.metrics", "trainer.grad_check",
                          "resunet.geometry", "sparse.downsample_coords"}

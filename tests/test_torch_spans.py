"""The port's spans (``utils/profiling.py::span``) and the benchmark's
readers of them (``portbench/metrics/_spans.py``).

A profiled ``folder_inference`` of a tiny model (a 2-block, 32-wide ViT at
56 px, the synthetic body model) shows the seven spans once per batch in the
order the pipelined loop runs them, flat but for ``fk`` inside ``body``, none
a user annotation, each holding the operators its stage runs; the outputs
are bitwise those of an unprofiled run, and ``torch.export`` records no
profiler node. The seven readers run
on a hand-built trace whose readings are worked out below, and the share of
``fk`` spans that replay a CUDA graph on hand-built host events.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from multihmr_tpu_torch.bodymodel.assets import synthetic_body_model
from multihmr_tpu_torch.bodymodel.core import BodyModel
from multihmr_tpu_torch.config import ModelConfig, ViTConfig
from multihmr_tpu_torch.io.export import export_program
from multihmr_tpu_torch.models.multihmr import MultiHMR, MultiHMRNet
from multihmr_tpu_torch.parallel.infer import folder_inference
from multihmr_tpu_torch.utils import profiling
from portbench import harness
from portbench.trace import Trace
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)

S = 56
ORDER = ["stack", "upload", "vit", "head", "body", "fk", "readback"]
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


@pytest.fixture(scope="module")
def tiny():
    cfg = ModelConfig(img_size=S, max_people=4, compute_dtype="float32",
                      vit_override=ViTConfig(embed_dim=32, depth=2, num_heads=2))
    net = MultiHMRNet(cfg).init_weights(torch.Generator().manual_seed(0)).eval()
    model = MultiHMR(cfg, BodyModel.from_arrays(synthetic_body_model(), "cpu"), net=net)
    rng = np.random.default_rng(0)
    images = [rng.normal(size=(S, S, 3)).astype(np.float32) for _ in range(4)]
    K = np.array([[100.0, 0, 28], [0, 100, 28], [0, 0, 1]], np.float32)
    run = lambda: folder_inference(model, images, K, det_thresh=0.0, batch_size=2)  # noqa: E731
    plain = run()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = run()
    return SimpleNamespace(model=model, plain=plain, traced=traced, events=prof.events())


def _ours(events):
    return sorted((e for e in events if e.name.startswith(profiling.SPAN_PREFIX)),
                  key=lambda e: e.time_range.start)


def test_spans_once_per_batch_in_order(tiny):
    """``folder_inference`` enqueues batch 1 (its stack, upload and forward)
    before it reads batch 0 back, then reads both back in order."""
    names = [e.name for e in _ours(tiny.events)]
    enqueue = ["multihmr." + n for n in ORDER[:-1]]
    assert names == enqueue * 2 + ["multihmr.readback"] * 2


def test_spans_flat_and_not_user_annotations(tiny):
    """No span is inside another but ``fk``, the body model's forward
    kinematics, inside ``body``."""
    for e in _ours(tiny.events):
        assert not e.is_user_annotation, e.name
        outer, parent = [], e.cpu_parent
        while parent is not None:
            if parent.name.startswith(profiling.SPAN_PREFIX):
                outer.append(parent.name)
            parent = parent.cpu_parent
        assert outer == (["multihmr.body"] if e.name == "multihmr.fk" else []), e.name


def _descendants(e) -> list:
    out = []
    for c in e.cpu_children:
        out += [c] + _descendants(c)
    return out


@pytest.mark.parametrize("name", ORDER)
def test_span_holds_its_stage_ops(tiny, name):
    """Every operator that runs inside a span, on its thread, is one of the
    span's descendants in the profiler's tree; the ViT's kernels' operators
    (2 blocks: 2 attention, 4 LayerNorm) are under ``multihmr.vit`` and no
    other span; each stage but the stack runs operators."""
    for s in (e for e in _ours(tiny.events) if e.name == "multihmr." + name):
        inside = [e for e in tiny.events
                  if e is not s and e.thread == s.thread and not e.is_async
                  and s.time_range.start <= e.time_range.start
                  and e.time_range.end <= s.time_range.end]
        under = _descendants(s)
        assert {id(e) for e in inside} <= {id(e) for e in under}, name
        assert bool(under) == (name != "stack"), name
        ops = [e.name for e in under]
        vit = name == "vit"
        assert ops.count("mhmr::flash_fwd_t") == (2 if vit else 0), name
        assert ops.count("mhmr::layernorm_cm") == (4 if vit else 0), name


def test_outputs_bitwise_with_profiler_on_and_off(tiny):
    assert len(tiny.plain) == len(tiny.traced) == 4
    assert sum(len(p) for p in tiny.plain) > 0
    for a_img, b_img in zip(tiny.plain, tiny.traced):
        assert len(a_img) == len(b_img)
        for a, b in zip(a_img, b_img):
            assert a.keys() == b.keys()
            for k in a:
                assert np.array_equal(a[k], b[k]), k


def test_export_graph_has_no_profiler_node(tiny):
    program, _ = export_program(tiny.model, batch_size=1, det_thresh=0.0)
    targets = [str(n.target) for n in program.graph.nodes]
    assert not [t for t in targets if "profiler" in t or "record_function" in t]
    assert any("aten" in t for t in targets)


# -- the readers on a hand-built trace ---------------------------------------
#
# Two batches, times in us. Host spans: stack [0,100] [600,700], upload
# [100,150] [700,750], vit [150,300] [750,900], head [300,350] [900,950],
# body [350,380] [950,980], readback [380,600] [980,1200], and an operator
# [1190,1250] after them: the window is [0, 1250]. Device work: copies
# [120,140] [720,740], kernels [160,400] + [390,520] and [760,1100]: busy
# 740, idle 510 in [0,120] [140,160] [520,720] [740,760] [1100,1250].
# Excluded: a "multihmr.vit" device copy [160,1100], a user annotation's
# device copy [0,1250] and a "portbench." one. Per batch (ms): stack
# (100 + 100) / 2, upload (20 + 10 + 20 + 10) / 2, readback (80 + 100) / 2,
# other (10 + 10 + 50) / 2.

def _ev(name, start, end, device=False, dtt=0.0, user=False, id=0, kernels=(), thread=1):
    return SimpleNamespace(name=name, device_type=CUDA if device else CPU,
                           time_range=SimpleNamespace(start=float(start), end=float(end)),
                           device_time_total=float(dtt), is_user_annotation=user,
                           is_async=False, id=id, thread=thread,
                           kernels=[SimpleNamespace(name=n, duration=float(d))
                                    for n, d in kernels])


def _synthetic(with_device=True):
    host = []
    for off, vit_dt, head_dt, body_dt in ((0, 300, 10, 5), (600, 340, 30, 7)):
        for name, s, e, dtt in (("stack", 0, 100, 0), ("upload", 100, 150, 20),
                                ("vit", 150, 300, vit_dt), ("head", 300, 350, head_dt),
                                ("body", 350, 380, body_dt), ("readback", 380, 600, 0)):
            host.append(_ev("multihmr." + name, off + s, off + e, dtt=dtt))
    host.append(_ev("aten::add", 1190, 1250))
    device = [_ev("Memcpy HtoD (Pageable -> Device)", 120, 140, True),
              _ev("Memcpy HtoD (Pageable -> Device)", 720, 740, True),
              _ev("gemm", 160, 400, True), _ev("flash", 390, 520, True),
              _ev("gemm", 760, 1100, True),
              _ev("multihmr.vit", 160, 1100, True),
              _ev("someone.else", 0, 1250, True, user=True),
              _ev("portbench.folder.folder_inference", 0, 1250, True, user=True)]
    return Trace(host + (device if with_device else []), window_s=1250e-6)


EXPECTED = {"vit_ms.infer": 0.320, "head_ms.infer": 0.020, "body_ms.infer": 0.006,
            "stack_idle_ms.infer": 0.100, "upload_idle_ms.infer": 0.030,
            "readback_idle_ms.infer": 0.090, "other_idle_ms.infer": 0.035}
IDLE = [m for m in EXPECTED if "idle" in m]


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_on_synthetic_trace(metric):
    got = harness.read_metric(metric, {"trace": _synthetic()})
    assert got == pytest.approx(EXPECTED[metric], abs=1e-12)


def test_idle_readers_add_up_to_window_less_busy():
    ctx = {"trace": _synthetic()}
    per_batch = sum(harness.read_metric(m, ctx) for m in IDLE)
    assert per_batch * 2 == pytest.approx((1250 - 740) / 1e3, abs=1e-12)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_none_without_device_events(metric):
    assert harness.read_metric(metric, {"trace": _synthetic(with_device=False)}) is None
    assert harness.read_metric(metric, {"trace": None}) is None


def test_readers_in_benchmark():
    entries = {m["name"]: m for m in harness.load_json(
        harness.ROOT.parent / "BENCHMARK.json")["per_layer"]}
    for name in EXPECTED:
        m = entries[name]
        assert (m["unit"], m["better"], m["source"], m["moves"], m["workloads"]) == (
            "ms", "lower", "device_trace", "images_per_s",
            ["folder_896L_b8", "folder_672L_anny_b8", "folder_896G_b8"])


# -- the SwiGLU FFN's spans and K2's roofline ---------------------------------
#
# The hand-built trace above with three ``multihmr.ffn`` spans inside each
# ``vit`` span. In each, an operator whose kernels take 20, 30 and 40 us in
# the first batch and 50, 60 and 70 in the second, and a child of it that
# shares its correlation id and so lists the same kernels again; the spans'
# own device_time_total reads twice that. Left out: the spans' device copy
# in the first span's kernels, an operator of the same time on another
# thread, and one inside ``vit`` but in no ``ffn`` span. So (90 + 180) / 2 =
# 135 us a batch. K2: four
# kernels of 100, 120, 140 and 160 us (the narrow and the wide one's names),
# two other kernels: a mean of 130 us a call against the bound at the
# cell's width, batch and true tokens.

def _with_ffn():
    tr = _synthetic()
    for off, times in ((0, (20, 30, 40)), (600, (50, 60, 70))):
        for i, t in enumerate(times):
            s, op = off + 160 + 40 * i, 100 + off + i
            gemm = [("gemm", t)]
            tr.host += [_ev("multihmr.ffn", s, s + 30, dtt=2 * t,
                            kernels=[("multihmr.ffn", 30)] if op == 100 else ()),
                        _ev("aten::addmm", s + 5, s + 25, id=op, kernels=gemm),
                        _ev("Command Buffer Full", s + 10, s + 20, id=op, kernels=gemm),
                        _ev("aten::mul", s + 5, s + 25, id=op + 50, kernels=gemm, thread=2)]
        tr.host.append(_ev("aten::addmm", off + 275, off + 290, id=off + 90,
                           kernels=[("gemm", 1000)]))
    return tr


def test_ffn_reader():
    assert harness.read_metric("ffn_ms.infer", {"trace": _with_ffn()}) == pytest.approx(
        0.135, abs=1e-12)
    assert harness.read_metric("ffn_ms.infer", {"trace": _synthetic()}) is None
    assert harness.read_metric("ffn_ms.infer", {"trace": None}) is None


@pytest.mark.parametrize("config", ["multiHMR_896_L", "multiHMR_896_G"])
def test_k2_roofline_reader(config):
    from portbench import roofline

    k2 = ["void mhmr::(anonymous namespace)::layernorm_cm_kernel<mhmr::BF16, mhmr::BF16>",
          "void mhmr::(anonymous namespace)::layernorm_cm_wide_kernel<mhmr::BF16, mhmr::BF16>"]
    kernels = [_ev(k2[i % 2], 0, t, True) for i, t in enumerate((100, 120, 140, 160))]
    kernels += [_ev("gemm", 0, 1000, True), _ev("flash", 0, 10, True)]
    tr = Trace(kernels, window_s=1e-3)
    cfg = harness.load_json(harness.ROOT / "configs" / f"{config}.json")
    cell = SimpleNamespace(config=cfg, traffic={"batch": 8})
    D = cfg["embed_dim"]
    n = roofline.tokens(cfg)
    bound = (2 * 8 * D * n * 2 + 2 * D * 4) / roofline.PEAK_BYTES
    got = harness.read_metric("k2_roofline.infer", {"trace": tr, "cell": cell})
    assert got == pytest.approx(100 * bound / 130e-6, rel=1e-12)
    assert harness.read_metric("k2_roofline.infer", {"trace": Trace(kernels[4:], 1e-3),
                                                     "cell": cell}) is None


def test_new_readers_in_benchmark():
    entries = {m["name"]: m for m in harness.load_json(
        harness.ROOT.parent / "BENCHMARK.json")["per_layer"]}
    assert [entries["ffn_ms.infer"][k] for k in ("unit", "better", "source", "layer", "moves",
                                                 "workloads")] == [
        "ms", "lower", "device_trace", "backbone", "images_per_s", ["folder_896G_b8"]]
    assert [entries["k2_roofline.infer"][k] for k in ("unit", "better", "source", "layer",
                                                      "moves", "workloads")] == [
        "%", "higher", "device_trace", "kernels", "images_per_s",
        ["folder_896L_b8", "folder_672L_anny_b8", "folder_896G_b8"]]


# -- the share of forward-kinematics spans that replay a CUDA graph -----------
#
# Four ``multihmr.fk`` spans, [0,100] [200,300] [400,500] [600,700] (us); a
# ``cudaGraphLaunch`` inside the first and the third, one at 150 between
# spans, a ``cudaGraphLaunch_ptsz`` inside the fourth, and a kernel launch
# inside the second: three of four spans replay a graph.

def _fk_trace(launches, spans=4, with_device=True):
    host = [_ev("multihmr.fk", 200 * i, 200 * i + 100) for i in range(spans)]
    host += [_ev(name, t, t + 5) for name, t in launches]
    host.append(_ev("multihmr.body", 0, 700))
    device = [_ev("gemm", 10, 90, True)] if with_device else []
    return Trace(host + device, window_s=700e-6)


FK_GRAPH_CASES = {
    "mixed": ([("cudaGraphLaunch", 50), ("cudaGraphLaunch", 150), ("cudaLaunchKernel", 250),
               ("cudaGraphLaunch", 450), ("cudaGraphLaunch_ptsz", 650)], 75.0),
    "every call": ([("cudaGraphLaunch", 200 * i + 60) for i in range(4)], 100.0),
    "one by one": ([("cudaLaunchKernel", 200 * i + 60) for i in range(4)], 0.0),
}


@pytest.mark.parametrize("case", sorted(FK_GRAPH_CASES))
def test_fk_graph_reader(case):
    launches, pct = FK_GRAPH_CASES[case]
    assert harness.read_metric("fk_graph_pct.infer", {"trace": _fk_trace(launches)}) == pct


@pytest.mark.parametrize("trace", ["no fk span", "no device work", "none"])
def test_fk_graph_reader_none(trace):
    launches = FK_GRAPH_CASES["every call"][0]
    tr = {"no fk span": _fk_trace(launches, spans=0),
          "no device work": _fk_trace(launches, with_device=False), "none": None}[trace]
    assert harness.read_metric("fk_graph_pct.infer", {"trace": tr}) is None


def test_fk_graph_reader_in_benchmark():
    m = next(m for m in harness.load_json(harness.ROOT.parent / "BENCHMARK.json")["per_layer"]
             if m["name"] == "fk_graph_pct.infer")
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"], m["workloads"]) == (
        "%", "higher", "device_trace", "body model", "images_per_s",
        ["folder_896L_b8", "folder_672L_anny_b8", "folder_896G_b8"])

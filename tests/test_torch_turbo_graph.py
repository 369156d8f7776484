"""The supervised program's stack replayed as CUDA graphs
(``pipeline.turbo._StackGraphs``) and the stencils' reflect index cached
on the device (``ops.stencil.pad_index``).

On the CPU: the cached index against ``np.pad``, the stencils bit-equal to
the index copied in on every call as before, ``lut_hist``'s destination
tensors, a CPU call that builds no graph, and the benchmark's reader of
the ``stack_graph`` count. On a card (marker ``card``; each test skips
without CUDA): the graphed maps bit-equal to the eager route for B = 1, 3
and 8 with a bundled-scale forest and a forest past ``GEMM_MAX_LEAVES``,
each batch's own maps when two batches alternate, a returned map
unchanged after the next batch is launched, one capture per key, and the
count ``stack_graph`` with the graphs' kernels in a device trace."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rs_image_segmentation_tpu_torch.core.config import (CalibrationConfig,
                                                         FeatureStageConfig,
                                                         GLCMConfig)
from rs_image_segmentation_tpu_torch.models import forest as tforest
from rs_image_segmentation_tpu_torch.ops import kernels, stencil
from rs_image_segmentation_tpu_torch.pipeline import turbo
from rs_image_segmentation_tpu_torch.pipeline.preprocess import (
    build_stretch_lut)
from rs_image_segmentation_tpu_torch.tools.fixtures import (
    deep_forest_fields, rule_forest, stretch_stats_batch, synthetic_scenes)
from rs_image_segmentation_tpu_torch.utils import timing
from rs_image_segmentation_tpu_torch.utils.timing import SpanRecord, span

CPU = "cpu"
SMALL = FeatureStageConfig(glcm=GLCMConfig(window_size=8, step_size=8,
                                           levels=8))
CAL = CalibrationConfig()
GAINS, BIASES = np.asarray(CAL.gains), np.asarray(CAL.biases)
READER = (pathlib.Path(__file__).resolve().parent.parent / "perfbench"
          / "metrics" / "stack_graph_share.batch.py")


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """Small tensors gain nothing from many intra-op threads; other test
    workers on the host keep the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _profiled(fn, activities=(ProfilerActivity.CPU,)):
    """``fn()`` under a new ``torch.profiler`` session: ``(result, spans,
    profiler)``."""
    with span("unrecorded"):
        pass
    with profile(activities=list(activities)) as prof:
        out = fn()
        if ProfilerActivity.CUDA in activities:
            torch.cuda.synchronize()
    return out, timing.spans(), prof


def _batch_spans(recs):
    return [r for r in recs if r.name == "turbo.batch"]


# --------------------------------------------- the stencils' cached index

def _per_call_pad_axis(x, pads, dim, mode):
    """``ops.stencil._pad_axis`` as it was: the index made with np.pad and
    copied to the tensor's device on every call."""
    if pads == (0, 0):
        return x
    idx = np.pad(np.arange(x.shape[dim]), pads, mode=mode)
    return x.index_select(dim, torch.from_numpy(idx).to(x.device))


@pytest.mark.parametrize("mode", ["reflect", "symmetric"])
@pytest.mark.parametrize("n, pads", [(1, (1, 1)), (2, (2, 2)), (5, (2, 2)),
                                     (5, (5, 5)), (7, (3, 1)), (3, (0, 3)),
                                     (600, (3, 3)), (600, (600, 600))])
def test_pad_index_equals_np_pad(mode, n, pads):
    idx = stencil.pad_index(n, pads, mode, torch.device(CPU))
    assert idx.dtype == torch.int64 and idx.device.type == CPU
    np.testing.assert_array_equal(idx.numpy(),
                                  np.pad(np.arange(n), pads, mode=mode))
    # made once per key: a second call hands back the same tensor
    assert stencil.pad_index(n, pads, mode, torch.device(CPU)) is idx


STENCILS = {
    "box 3 reflect101": lambda x: stencil.box_filter(x, 3),
    "box 5 reflect101": lambda x: stencil.box_filter(x, 5),
    "box 7 reflect": lambda x: stencil.box_filter(x, 7, border="reflect"),
    "sobel reflect101": stencil.sobel_magnitude,
    "sobel reflect": lambda x: stencil.sobel_magnitude(x, border="reflect"),
    "gaussian 5": lambda x: stencil.gaussian_blur(x, 5),
}


@pytest.mark.parametrize("name", list(STENCILS))
@pytest.mark.parametrize("shape", [(2, 3, 37, 41), (5, 4)])
def test_stencils_bit_equal_to_the_per_call_index(monkeypatch, name, shape):
    x = torch.from_numpy(np.random.default_rng(3).random(shape)
                         .astype(np.float32))
    got = STENCILS[name](x)
    monkeypatch.setattr(stencil, "_pad_axis", _per_call_pad_axis)
    assert torch.equal(got, STENCILS[name](x))


# ------------------------------------------------ lut_hist's destinations

@pytest.mark.parametrize("kw", [{}, {"skip_hist": True}, {"out_u8": True}],
                         ids=["hist", "skip_hist", "out_u8"])
def test_lut_hist_writes_into_given_tensors(kw):
    rng = np.random.default_rng(4)
    scene = torch.from_numpy(rng.integers(0, 256, (2, 7, 9, 11),
                                          dtype=np.uint8))
    lut = torch.from_numpy(rng.integers(0, 256, (2, 7, 256),
                                        dtype=np.uint8))
    want = kernels.lut_hist(scene, lut, **kw)
    want = want if isinstance(want, tuple) else (want,)
    dest = [torch.full_like(w, 7) for w in want]
    got = kernels.lut_hist(scene, lut, out=dest[0],
                           hist_out=None if kw.get("skip_hist") else dest[1],
                           **kw)
    got = got if isinstance(got, tuple) else (got,)
    for g, d, w in zip(got, dest, want):
        assert g is d and torch.equal(g, w)
    with pytest.raises(ValueError):
        kernels.lut_hist(scene, lut, out=dest[0][:1], **kw)


# ------------------------------------------------------- the CPU route

@pytest.fixture(scope="module")
def cpu_batch():
    """Two raw 7 x 64 x 64 scenes, their LUTs and a five-tree forest
    fitted on rule labels of 80 pixels of scene 0's stack."""
    from rs_image_segmentation_tpu_torch.tools.fixtures import rule_labels
    scenes = synthetic_scenes(2, 64, 64, seed=9)
    luts = np.stack([build_stretch_lut(s, GAINS, BIASES)
                     for s in scenes]).astype(np.uint8)
    stack = turbo.hierarchical_stack_turbo_cm(scenes[0], luts[0], SMALL,
                                              device=CPU).numpy()
    flat = stack.reshape(19, -1)
    pick = np.random.default_rng(1).choice(flat.shape[1], 80, replace=False)
    forest, _ = tforest.fit_random_forest(flat[:, pick].T,
                                          rule_labels(stack, pick),
                                          n_estimators=5, seed=0)
    return scenes, luts, tforest._gemm_for(forest, 19)


def test_a_cpu_call_builds_no_graph(cpu_batch):
    scenes, luts, gf = cpu_batch
    before = (dict(turbo._STACK_GRAPHS), turbo._StackGraphs.captures)
    maps, recs, _ = _profiled(lambda: turbo.classify_scenes_turbo(
        scenes, luts, gf, SMALL, device=CPU))
    assert (dict(turbo._STACK_GRAPHS), turbo._StackGraphs.captures) == \
        before
    assert not any(k[0].type == CPU for k in turbo._STACK_GRAPHS)
    root, = _batch_spans(recs)
    assert root.counts == {"stack_graph": 0}
    assert not [r for r in recs if r.name == "turbo.capture"]
    eager = turbo._labels_eager(torch.from_numpy(scenes),
                                torch.from_numpy(luts), None, gf, SMALL)
    assert maps.dtype == torch.uint8
    assert torch.equal(maps, eager.reshape(maps.shape).to(torch.uint8))


# ------------------------------------------------- the benchmark's reader

def _reader():
    spec = importlib.util.spec_from_file_location("stack_graph_share",
                                                  READER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _batches(*counts):
    return [SpanRecord("turbo.batch", k + 1, None, k + 1, 0,
                       {} if c is None else {"stack_graph": c},
                       float(k), k + 0.5) for k, c in enumerate(counts)]


@pytest.mark.parametrize("counts, share", [
    ((1, 1, 1), 100.0), ((0, 1, 1, 1), 75.0), ((0,), 0.0),
    ((None, None), None), ((), None)])
def test_stack_graph_share_reader(monkeypatch, counts, share):
    recs = _batches(*counts) + [SpanRecord("turbo.inputs", 99, 1, 1, 0, {},
                                           0.0, 0.1)]
    monkeypatch.setattr(timing, "spans", lambda: list(recs))
    got = _reader().read({})
    assert got == share if share is None else got == pytest.approx(share)


def test_stack_graph_share_reader_without_spans(monkeypatch):
    monkeypatch.setattr(timing, "spans", lambda: [])
    assert _reader().read({}) is None
    monkeypatch.delattr(timing, "spans")        # an older checkout
    assert _reader().read({}) is None


# -------------------------------------------------------------- the card

H = W = 600


@pytest.fixture
def card():
    """The CUDA card, with no graphs held: each test starts within the
    budget of ``STACK_GRAPH_PIXELS``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    turbo._STACK_GRAPHS.clear()
    torch.cuda.empty_cache()
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(scope="module")
def tiles():
    """Sixteen raw 7 x 600 x 600 tiles with their LUTs and histograms
    (host numpy)."""
    scenes = synthetic_scenes(16, H, W, seed=21)
    luts, _, hists = stretch_stats_batch(scenes)
    return scenes, luts.astype(np.uint8), hists


@pytest.fixture(scope="module")
def forests(tiles):
    """The bundled-scale forest (:func:`rule_forest` on tile 0's stack)
    and five complete depth-12 trees, 20 480 leaves past
    ``GEMM_MAX_LEAVES``, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    scenes, luts = tiles[:2]
    stack0 = turbo.hierarchical_stack_turbo_cm(scenes[0], luts[0]
                                               ).cpu().numpy()
    bundled = rule_forest(stack0)[0]
    deep = tforest._gemm_for(tforest.flat_forest_from_numpy(
        deep_forest_fields(stack0)), 19)
    assert deep.path.shape[1] > tforest.GEMM_MAX_LEAVES
    return {name: tforest.GemmForest(*(t.cuda() for t in gf))
            for name, gf in (("bundled", bundled), ("deep", deep))}


def _eager(card, gf, scenes, luts):
    """The batch's maps with every operation launched from Python."""
    labels = turbo._labels_eager(torch.from_numpy(scenes).to(card),
                                 torch.from_numpy(luts).to(card), None, gf,
                                 FeatureStageConfig())
    return labels.reshape(len(scenes), H, W).to(torch.uint8)


def _graphed(card, gf, scenes, luts, hists=None):
    return turbo.classify_scenes_turbo(scenes, luts, gf, stretch_hists=hists,
                                       device=card)


@pytest.mark.card
@pytest.mark.parametrize("forest", ["bundled", "deep"])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_graphed_maps_bit_equal_to_the_eager_route(card, tiles, forests,
                                                   forest, b):
    scenes, luts, hists = (a[:b] for a in tiles)
    gf = forests[forest]
    want = _eager(card, gf, scenes, luts)
    # the first call of a shape captures; the next ones replay, with the
    # host histograms (the serving engine's call) and without
    for kw in ({}, {"hists": hists}, {}):
        got = _graphed(card, gf, scenes, luts, **kw)
        assert got.shape == (b, H, W) and got.dtype == torch.uint8
        assert torch.equal(got, want)
    assert (card, b, 7, H, W, FeatureStageConfig()) in turbo._STACK_GRAPHS


@pytest.mark.card
def test_alternating_batches_read_their_own_inputs(card, tiles, forests):
    scenes, luts = tiles[:2]
    gf = forests["bundled"]
    halves = [(scenes[:8], luts[:8]), (scenes[8:], luts[8:])]
    want = [_eager(card, gf, *h) for h in halves]
    assert not torch.equal(want[0], want[1])
    # queued back to back, no wait between the batches
    got = [_graphed(card, gf, *halves[k % 2]) for k in range(6)]
    for k, g in enumerate(got):
        assert torch.equal(g, want[k % 2]), k


@pytest.mark.card
def test_a_returned_map_survives_the_next_launch(card, tiles, forests):
    scenes, luts = tiles[:2]
    gf = forests["deep"]
    want = _eager(card, gf, scenes[:8], luts[:8])
    _graphed(card, gf, scenes[8:], luts[8:])        # the shape is captured
    first = _graphed(card, gf, scenes[:8], luts[:8])
    second = _graphed(card, gf, scenes[8:], luts[8:])
    assert first.data_ptr() != second.data_ptr()
    assert torch.equal(first, want)


@pytest.mark.card
def test_one_capture_per_key(card, tiles, forests):
    scenes, luts = tiles[:2]
    gf = forests["bundled"]
    before = turbo._StackGraphs.captures
    for _ in range(3):
        _graphed(card, gf, scenes[:5], luts[:5])
    assert turbo._StackGraphs.captures == before + 1
    for _ in range(2):
        _graphed(card, gf, scenes[:6], luts[:6])
    assert turbo._StackGraphs.captures == before + 2


@pytest.mark.card
def test_stack_graph_count_and_the_graphs_kernels_in_a_trace(card, tiles,
                                                            forests):
    scenes, luts = tiles[:2]
    gf = forests["bundled"]
    acts = (ProfilerActivity.CPU, ProfilerActivity.CUDA)
    _, recs, _ = _profiled(lambda: _graphed(card, gf, scenes[:2], luts[:2]),
                           acts)
    root, = _batch_spans(recs)
    assert root.counts["stack_graph"] == 0
    assert [r.parent for r in recs if r.name == "turbo.capture"] == [root.id]
    before = (kernels.lut_hist.launches, kernels.forest_labels.launches)
    _, recs, prof = _profiled(
        lambda: _graphed(card, gf, scenes[:2], luts[:2]), acts)
    root, = _batch_spans(recs)
    assert root.counts["stack_graph"] == 1
    assert (kernels.lut_hist.launches, kernels.forest_labels.launches) == (
        before[0] + 1, before[1] + 1)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    # the stack's some 700 kernels come from the replays
    assert sum("elementwise" in n for n in names) > 100, len(names)
    assert any("forest_labels" in n for n in names)
    assert any("lut_hist" in n for n in names)


@pytest.mark.card
def test_a_batch_past_the_budget_runs_eagerly(card, tiles, forests,
                                              monkeypatch):
    scenes, luts = tiles[:2]
    gf = forests["bundled"]
    _graphed(card, gf, scenes[:2], luts[:2])
    monkeypatch.setattr(turbo, "STACK_GRAPH_PIXELS", 3 * H * W)
    before = turbo._StackGraphs.captures
    want = _eager(card, gf, scenes[:3], luts[:3])
    for _ in range(2):
        _, recs, _ = _profiled(lambda: _graphed(card, gf, scenes[:3],
                                                luts[:3]))
        root, = _batch_spans(recs)
        assert root.counts["stack_graph"] == 0
        assert torch.equal(_graphed(card, gf, scenes[:3], luts[:3]), want)
    assert turbo._StackGraphs.captures == before
    assert (card, 3, 7, H, W, FeatureStageConfig()) not in \
        turbo._STACK_GRAPHS
    # a shape within what is left still captures
    _graphed(card, gf, scenes[:1], luts[:1])
    assert turbo._StackGraphs.captures == before + 1

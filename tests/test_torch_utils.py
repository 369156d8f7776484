"""PyTorch port of ``utils`` (``guards``, ``timing``, ``traceview``,
``plotting``) against the JAX package's, on the CPU: the guards raise or
pass exactly where checkify's do on the same functions, the timer's
report has the JAX format, a CPU ``device_trace`` is readable by
``device_exec_intervals``, the overlap arithmetic equals JAX's on seeded
random intervals, and ``set_chinese_font`` returns and sets what JAX's
does."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_image_segmentation_tpu.ops import indices as jind
from rs_image_segmentation_tpu.utils import guards as jguards
from rs_image_segmentation_tpu.utils import plotting as jplotting
from rs_image_segmentation_tpu.utils import timing as jtiming
from rs_image_segmentation_tpu.utils import traceview as jtraceview
from rs_image_segmentation_tpu_torch.ops import indices as tind
from rs_image_segmentation_tpu_torch.utils import guards as tguards
from rs_image_segmentation_tpu_torch.utils import plotting as tplotting
from rs_image_segmentation_tpu_torch.utils import timing as ttiming
from rs_image_segmentation_tpu_torch.utils import traceview as ttraceview


def _bands(lo, seed=0):
    """Seeded (7, 24, 32) f32 bands uniform in [lo, 1)."""
    rng = np.random.default_rng(seed)
    return (lo + (1 - lo) * rng.random((7, 24, 32))).astype(np.float32)


# name -> (JAX function, port function, input): the set both guards see
GUARD_CASES = {
    "log(-1)": (lambda x: jnp.log(-x), lambda x: torch.log(-x),
                np.array([1.0, 2.0], np.float32)),
    "nan_to_num(log(-1))": (lambda x: jnp.nan_to_num(jnp.log(-x)),
                            lambda x: torch.nan_to_num(torch.log(-x)),
                            np.array([1.0, 2.0], np.float32)),
    "1/0": (lambda x: 1.0 / (x - x), lambda x: 1.0 / (x - x),
            np.array([1.0, 2.0], np.float32)),
    "x/0.0": (lambda x: x / 0.0, lambda x: x / 0.0,
              np.array([1.0, 2.0], np.float32)),
    "//0": (lambda x: x // 0, lambda x: x // 0, np.array([3, 4], np.int32)),
    "x*2": (lambda x: x * 2, lambda x: x * 2,
            np.array([1.0, 2.0], np.float32)),
    # a stage function: the seven guarded-ratio indices; on bands in
    # [0, 1) every ratio and MSAVI's square root are defined, on bands
    # reaching -1 MSAVI takes the square root of a negative
    "spectral_indices, bands in [0, 1)": (jind.spectral_indices,
                                          tind.spectral_indices, _bands(0.0)),
    "spectral_indices, bands in [-1, 1)": (jind.spectral_indices,
                                           tind.spectral_indices,
                                           _bands(-1.0, 1)),
    "assert_finite, finite": (lambda x: jguards.assert_finite(x, "x"),
                              lambda x: tguards.assert_finite(x, "x"),
                              np.array([1.0, 2.0], np.float32)),
    "assert_finite, inf": (lambda x: jguards.assert_finite(x * jnp.inf, "x"),
                           lambda x: tguards.assert_finite(x * torch.inf,
                                                           "x"),
                           np.array([1.0, 2.0], np.float32)),
}


def _outcome(fn):
    try:
        return "pass", fn()
    except Exception as e:  # checkify's JaxRuntimeError, the port's
        return "raise", e   # CheckError


@pytest.mark.parametrize("case", list(GUARD_CASES))
def test_checked_raises_exactly_where_jax_does(case):
    """``checked`` raises or passes on each case as checkify does; where
    both pass the outputs agree (EVI within 1e-3: its cancelling
    denominator, ``tests/test_torch_ops.py``; all else within 1e-6)."""
    jfn, tfn, x = GUARD_CASES[case]
    jres, jout = _outcome(lambda: jguards.checked(jfn)(jnp.asarray(x)))
    tres, tout = _outcome(lambda: tguards.checked(tfn)(torch.from_numpy(x)))
    assert tres == jres, (case, jres, tres, tout)
    if tres == "raise":
        assert isinstance(tout, tguards.CheckError)
        # the same cause in both messages
        jkind = "division" if "division" in str(jout) else (
            "nan" if "nan" in str(jout).lower() else "check")
        assert jkind in str(tout).lower() or (
            jkind == "check" and "NaN/Inf" in str(tout)), (jout, tout)
        return
    jd = jout if isinstance(jout, dict) else {"out": jout}
    td = tout if isinstance(tout, dict) else {"out": tout}
    assert sorted(td) == sorted(jd)   # checkify returns the dict sorted
    for k in jd:
        bound = 1e-3 if k == "evi" else 1e-6
        assert np.abs(td[k].numpy() - np.asarray(jd[k])).max() <= bound, k


def test_checked_names_the_op():
    with pytest.raises(tguards.CheckError, match=r"NaN generated by aten\.log"):
        tguards.checked(lambda x: torch.nan_to_num(torch.log(x)))(
            torch.tensor([-1.0]))
    with pytest.raises(tguards.CheckError,
                       match=r"division by zero in aten\.reciprocal"):
        tguards.checked(lambda x: 1.0 / x)(torch.tensor([0.0, 1.0]))
    for op in (torch.remainder, torch.fmod, torch.floor_divide):
        with pytest.raises(tguards.CheckError, match="division by zero"):
            tguards.checked(lambda x: op(x, torch.zeros_like(x)))(
                torch.tensor([3.0]))
    # a NaN an input already carried is not flagged again; a fresh one is
    carried = tguards.checked(lambda x: x + 1)(torch.tensor([np.nan, 1.0]))
    assert torch.isnan(carried[0]) and carried[1] == 2.0


def test_sanitize_and_assert_finite_match_jax():
    x = np.array([np.nan, np.inf, -np.inf, 1.5, -0.0], np.float32)
    for v in (0.0, -7.0):
        assert np.array_equal(
            tguards.sanitize(torch.from_numpy(x), v).numpy(),
            np.asarray(jguards.sanitize(jnp.asarray(x), v)))
    for arr in (x, x[3:]):
        jres, _ = _outcome(lambda: jguards.assert_finite(jnp.asarray(arr)))
        tres, _ = _outcome(lambda: tguards.assert_finite(
            torch.from_numpy(arr)))
        assert tres == jres
    ok = torch.tensor([1.0])
    assert tguards.assert_finite(ok) is ok


# --- timing ---------------------------------------------------------------

def test_stage_timer_report_has_the_jax_format():
    timings = {"preprocess": 0.0123456, "a much longer stage name here": 1.5,
               "forest": 2e-4}
    t, j = ttiming.StageTimer(), jtiming.StageTimer()
    t.timings, j.timings = dict(timings), dict(timings)
    assert t.report() == j.report()
    assert t.report().splitlines()[-1].startswith("total")


def test_stage_timer_and_trace():
    t = ttiming.StageTimer()
    x = torch.ones((4, 4))
    with t.stage("op", sync={"a": [x, 3], "b": (x,)}):
        y = x * 2
    with t.stage("op", sync=y):
        pass
    with t.stage("none"):
        pass
    rep = t.report()
    assert "op" in rep and "total" in rep and "none" in rep
    assert set(t.timings) == {"op", "none"}
    assert re.fullmatch(r"op +\d+\.\d ms", rep.splitlines()[0])
    with ttiming.device_trace(None):
        pass  # no-op path


def test_cpu_device_trace_is_readable(tmp_path):
    """A CPU trace: operator events on the thread's lane, the op names
    kept, and the intervals well formed."""
    x = torch.ones((64, 64))
    with ttiming.device_trace(str(tmp_path)):
        (x @ x).sum()
    path = ttraceview.latest_trace_file(str(tmp_path))
    assert path.endswith(".pt.trace.json.gz")
    events = ttraceview.device_exec_events(str(tmp_path))
    lanes = ttraceview.device_exec_intervals(str(tmp_path))
    assert lanes and all(k.startswith("cpu-exec:") for k in lanes)
    names = {n for evs in events.values() for _, _, n in evs}
    assert {"aten::mm", "aten::sum"} <= names or {"aten::matmul",
                                                  "aten::sum"} <= names
    for ivs in lanes.values():
        assert all(b >= a for a, b in ivs)
    assert ttraceview.count_cross_lane_overlaps(lanes) >= 0
    with pytest.raises(FileNotFoundError):
        ttraceview.latest_trace_file(str(tmp_path / "empty"))


def _random_lanes(seed):
    rng = np.random.default_rng(seed)
    lanes = {}
    for k in range(rng.integers(1, 5)):
        starts = np.sort(rng.uniform(0, 1000, rng.integers(0, 12)))
        lanes[f"lane{k}"] = [(float(a), float(a + d)) for a, d in
                             zip(starts, rng.uniform(0, 80, starts.size))]
    return lanes


@pytest.mark.parametrize("seed", range(6))
def test_overlap_functions_equal_jax(seed):
    lanes = _random_lanes(seed)
    assert (ttraceview.count_cross_lane_overlaps(lanes)
            == jtraceview.count_cross_lane_overlaps(lanes))
    assert (ttraceview.total_cross_lane_overlap_us(lanes)
            == jtraceview.total_cross_lane_overlap_us(lanes))
    for ivs in lanes.values():
        assert ttraceview._merge(ivs) == jtraceview._merge(ivs)


# --- plotting -------------------------------------------------------------

@pytest.mark.parametrize("font_path", [None, "/nonexistent/font.ttc"])
def test_set_chinese_font_matches_jax(font_path):
    import matplotlib
    keys = ("font.family", "axes.unicode_minus")
    before = {k: matplotlib.rcParams[k] for k in keys}
    try:
        got = tplotting.set_chinese_font(font_path)
        after_t = {k: matplotlib.rcParams[k] for k in keys}
        matplotlib.rcParams.update(before)
        want = jplotting.set_chinese_font(font_path)
        after_j = {k: matplotlib.rcParams[k] for k in keys}
    finally:
        matplotlib.rcParams.update(before)
    assert got == want and after_t == after_j

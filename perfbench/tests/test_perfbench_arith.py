"""The arithmetic the metrics rest on, on made-up numbers: the window's
rate and tail, the no-JAX check, the trace reduction and the counts."""

import math

import pytest

from perfbench.harness import manifest, nojax, roofline, trace, window


def test_rate_is_all_work_over_all_time():
    # 3 batches of 2.88 MP done at 0.5, 1.0 and 4.0 s of a window from 0
    assert window.rate([2.88, 2.88, 2.88], 0.0, 4.0) == pytest.approx(2.16)
    with pytest.raises(ValueError):
        window.rate([1.0], 1.0, 1.0)


def test_tail_is_over_all_requests_with_failures_as_misses():
    lat = [0.01 * k for k in range(1, 101)]          # 10 ms .. 1000 ms
    assert window.percentile(lat, 95.0) == pytest.approx(0.95)
    assert window.percentile(lat, 50.0) == pytest.approx(0.50)
    # six failures among 100: the p95 lands on a miss
    missed = lat[:94] + [math.inf] * 6
    assert window.percentile(missed, 95.0) == math.inf
    assert window.percentile(missed, 50.0) == pytest.approx(0.50)


def test_no_jax_compares_top_level_names_whole():
    names = ["numpy", "rs_image_segmentation_tpu_torch",
             "rs_image_segmentation_tpu_torch.ops.kernels", "jaxtyping",
             "rs_image_segmentation_tpu.core", "jax", "jax.numpy", "flax",
             "jaxlib.xla_client"]
    assert nojax.forbidden_loaded(names) == sorted(
        ["rs_image_segmentation_tpu.core", "jax", "jax.numpy", "flax",
         "jaxlib.xla_client"])
    assert nojax.forbidden_loaded(["rs_image_segmentation_tpu_torch"]) == []


def _ev(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": args}


def test_idle_share_takes_the_union_of_two_overlapping_streams():
    ev = [
        _ev(trace.TRACED, "user_annotation", 1000.0, 1000.0),
        _ev("perfbench.host_prep", "user_annotation", 1000.0, 300.0),
        _ev("perfbench.launch", "user_annotation", 1300.0, 700.0),
        # stream 7: 1100-1400; stream 13: 1300-1500 (overlap 100 us)
        _ev("void (anonymous namespace)::lut_hist_kernel<4, true>(int*)",
            "kernel", 1100.0, 300.0, stream=7),
        _ev("forest_labels_kernel<4>(float const*)", "kernel", 1300.0,
            200.0, stream=13),
        _ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 1800.0, 100.0,
            stream=7),
        # outside the traced span: ignored
        _ev("forest_labels_kernel<4>(float const*)", "kernel", 2500.0, 50.0),
    ]
    r = trace.reduce_trace(ev)
    assert r["window_s"] == pytest.approx(1e-3)
    assert r["busy_s"] == pytest.approx(500e-6)      # 1100-1500, 1800-1900
    assert r["kernels"]["lut_hist_kernel"]["count"] == 1
    assert r["kernels"]["forest_labels_kernel"]["total_s"] == \
        pytest.approx(200e-6)
    assert "Memcpy HtoD" not in r["kernels"]
    rec = {"trace": r}
    assert roofline.device_idle_share(rec) == pytest.approx(50.0)
    gaps = dict(r["breakdown"]["idle_gaps"])
    assert gaps["perfbench.host_prep"] == pytest.approx(100e-6)
    assert gaps["perfbench.launch"] == pytest.approx(400e-6)
    ops = dict(r["breakdown"]["device_ops"])
    assert ops["Memcpy HtoD"] == pytest.approx(100e-6)


def test_counts_against_hand_worked_numbers():
    lut = manifest.counts("lut_hist").count
    # 8 scenes x 7 bands of 600 x 600, f32 out, with the histogram:
    # 56 * (360000 * 5 + 256 + 1024) bytes
    assert lut({"planes": 56, "pixels": 360000, "out_bytes": 4,
                "hist": True}) == (56 * (1_800_000 + 1280), 56 * 360000)
    forest = manifest.counts("forest_labels").count
    b, o = forest({"pixels": 100, "features": 19, "trees": 100,
                   "classes": 4, "comparisons": 600})
    assert b == 100 * 19 * 4 + 100 * 4 and o == 600 + 100 * (400 + 4)
    cc = manifest.counts("ccmin_prop").count
    assert cc({"masks": 24, "pixels": 360000}) == (24 * 360000 * 9,
                                                   24 * 360000)
    step = manifest.counts("step").count
    assert step({"raw_bytes": 10, "map_bytes": 2, "table_bytes": 3,
                 "ops": 7}) == (15, 7)
    # PERF.md's bound of the batch's forest call: 230.4 MB at 3.35 TB/s
    t = roofline.least_time_s(8 * 360000 * 80, 0)
    assert t == pytest.approx(0.0688e-3, rel=1e-3)


def test_kernel_share_and_step_share_from_a_record():
    rec = {"trace": {"window_s": 1.0, "busy_s": 0.5, "kernels": {
        "lut_hist_kernel": {"count": 4, "total_s": 4 * 60e-6}}},
        "work": {"calls": {"lut_hist": [{"planes": 56, "pixels": 360000,
                                          "out_bytes": 4, "hist": False}]},
                 "step": {"raw_bytes": 3.35e12, "map_bytes": 0,
                          "table_bytes": 0, "ops": 0}},
        "units": 10, "window_s": 20.0}
    bound = 56 * (360000 * 5 + 256) / roofline.HBM_BYTES_PER_S
    assert roofline.kernel_share(rec, "lut_hist") == pytest.approx(
        100 * bound / 60e-6)
    assert roofline.kernel_share(rec, "forest_labels") is None
    # 1 s of least time a unit against 2 s measured a unit
    assert roofline.step_share(rec) == pytest.approx(50.0)

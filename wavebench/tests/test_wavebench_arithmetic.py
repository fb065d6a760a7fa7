"""The metric arithmetic: the rate, p90 over jobs, the spread, the union of
device ops, the idle share and gaps from a synthetic trace."""

import math

import pytest

from wavebench import stats
from wavebench import trace as T
from wavebench.harness import Run, load_module, HERE


def metric(name):
    return load_module(HERE / "metrics" / f"{name}.py", f"m_{name}")


def test_rate_and_p90_over_jobs():
    jobs = [(10.0 + i, 10.5 + i) for i in range(20)]
    jobs[7] = (17.0, 17.9)
    jobs[3] = (13.0, 13.8)
    run = Run(cell="c", config={"grid": {"kind": "box"}}, traffic={
        "forcing": {"kind": "constant"}}, nodes=100, steps=10, DT=600.0,
        jobs=jobs)
    assert metric("pushes_per_s").read(run) == pytest.approx(
        100 * 10 * 20 / (29.5 - 10.0))
    # nearest rank: the 18th of 20 sorted durations
    assert metric("day_s_p90").read(run) == pytest.approx(0.5)
    jobs[1] = (11.0, 11.7)
    assert metric("day_s_p90").read(run) == pytest.approx(0.7)
    assert stats.percentile([3.0, 1.0, 2.0], 90) == 3.0
    with pytest.raises(ValueError):
        stats.rate(1.0, 2.0, 2.0)


def test_spread_is_the_quartile_distance_over_the_median():
    v = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    q1, q3 = 1.75, 5.25     # statistics.quantiles(v, n=4), "exclusive"
    assert stats.spread(v) == pytest.approx((q3 - q1) / 3.5)


def test_union_gaps_and_summary_of_a_synthetic_trace():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert stats.union_length(spans) == pytest.approx(3.0)
    assert stats.gaps(spans, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0),
                                            (4.0, 5.0)]
    dev = [T.Op("void advance_kernel<float, 3>(...)", 0.00, 0.40),
           T.Op("void pic_gather_remesh_tiled_kernel<4>(...)", 0.45, 0.60),
           T.Op("elementwise_kernel", 0.60, 0.80),
           T.Op("void advance_kernel<float, 3>(...)", 1.00, 1.40),
           T.Op("void pic_gather_remesh_tiled_kernel<4>(...)", 1.45, 1.60),
           T.Op("elementwise_kernel", 1.60, 1.80),
           T.Op("void f64::advance_kernel<double, 3>(...)", 1.8, 1.9)]
    host = [T.Op("wavebench.job", 0.0, 2.0),
            T.Op("cudaGraphLaunch", 0.85, 0.95)]
    s = T.summarize(dev, host, [host[0]], steps=2)
    assert s.window_s == pytest.approx(2.0)
    assert s.busy_s == pytest.approx(0.4 + 0.35 + 0.4 + 0.35 + 0.1)
    assert s.ops == 7
    assert s.kernel_s["K1"] == pytest.approx(0.8)
    assert s.kernel_s["K6"] == pytest.approx(0.3)
    assert s.glue_s == pytest.approx(0.4)
    assert s.idle_gaps[0] == ("cudaGraphLaunch", pytest.approx(0.2))
    assert s.job_idle_s == [pytest.approx(0.4)]
    run = Run(cell="c", config={"grid": {"kind": "box"}}, traffic={
        "forcing": {"kind": "constant"}}, nodes=100, steps=2, DT=600.0,
        trace=s)
    assert metric("device.idle_share").read(run) == pytest.approx(
        100 * (1 - 1.6 / 2.0))
    assert metric("step.device_ops").read(run) == pytest.approx(3.5)
    assert metric("step.glue_ms").read(run) == pytest.approx(200.0)
    assert metric("run.job_host_ms").read(run) == pytest.approx(400.0)


def test_readers_return_nothing_where_nothing_was_read():
    run = Run(cell="c", config={"grid": {"kind": "box"}}, traffic={
        "forcing": {"kind": "constant"}}, nodes=100, steps=2, DT=600.0)
    for name in ("step.glue_ms", "step.device_ops", "K1_roofline",
                 "K6_roofline", "device.idle_share", "mfu.step",
                 "drivers.enqueue_ms",
                 "run.job_host_ms", "peak_mib"):
        assert metric(name).read(run) is None, name
    assert not math.isnan(metric("setup.capture_s").read(run))

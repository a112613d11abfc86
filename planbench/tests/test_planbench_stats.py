"""The harness's arithmetic on synthetic inputs: percentiles, spreads,
busy time and idle gaps of kernel intervals."""
import math
import statistics

import numpy as np
import pytest

import _planbench_util  # noqa: F401  (import paths)
from pbench import stats
from pbench.devtrace import DeviceTrace


@pytest.mark.parametrize("p", [0, 5, 50, 95, 99, 100])
def test_percentile_is_numpys_linear(p):
    xs = np.random.default_rng(3).lognormal(size=137)
    assert stats.percentile(xs, p) == pytest.approx(np.percentile(xs, p),
                                                    rel=1e-12)


def test_percentile_counts_failures_as_infinite():
    xs = [1.0] * 90 + [math.inf] * 10
    assert stats.percentile(xs, 50) == 1.0
    assert stats.percentile(xs, 95) == math.inf
    assert stats.percentile([], 50) is None


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [10.0, 11.0, 9.0, 10.5, 9.5, 12.0]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == (q3 - q1) / med


def test_union_and_gaps_of_intervals():
    iv = [(0.1, 0.3), (0.2, 0.4), (0.5, 0.6), (0.55, 0.58), (0.9, 1.2)]
    assert stats.union_length(iv) == pytest.approx(0.3 + 0.1 + 0.3)
    assert stats.gaps(iv, 0.0, 1.0) == pytest.approx(
        [(0.0, 0.1), (0.4, 0.5), (0.6, 0.9)])
    assert stats.union_length([]) == 0.0
    assert stats.gaps([], 0.0, 2.0) == [(0.0, 2.0)]


def test_device_trace_readings():
    """Busy time is the union of device operations, kernel time their
    sum, idle gaps are named by the host call that ended them."""
    dt = DeviceTrace()
    dt.t0_ns, dt.t1_ns = 0, 1_000_000_000
    dt.ops = [(0.10, 0.20, "k_a", True), (0.15, 0.25, "k_b", True),
              (0.50, 0.60, "Memcpy DtoH", False), (0.70, 0.75, "k_a", True)]
    dt.host_calls = [(0.05, 0.10, "cudaLaunchKernel"),
                     (0.45, 0.51, "cudaMemcpyAsync"),
                     (0.69, 0.70, "cudaLaunchKernel")]
    assert dt.window_s == 1.0
    assert dt.busy_s == pytest.approx(0.15 + 0.10 + 0.05)
    assert dt.kernel_s == pytest.approx(0.10 + 0.10 + 0.05)
    assert dt.launches == 3
    assert dict((n, s) for n, s in dt.device_ops()) == pytest.approx(
        {"k_a": 0.15, "k_b": 0.10, "Memcpy DtoH": 0.10})
    gaps = dt.idle_gaps()
    assert gaps[0][1] == pytest.approx(0.25)
    assert ["host until cudaMemcpyAsync", pytest.approx(0.25)] in gaps
    assert ["window end", pytest.approx(0.25)] in gaps
    assert ["host until cudaLaunchKernel", pytest.approx(0.10)] in gaps
    assert sum(s for _, s in gaps) == pytest.approx(1.0 - dt.busy_s)

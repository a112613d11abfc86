"""The frozen work model stays as it was when the benchmark was made."""
import pytest

import _planbench_util  # noqa: F401  (import paths)
from pbench import work

# (n, B, C, cost, tier, G, rounds, extract) -> (operations, bytes)
PINNED = {
    (15, 16, 32768, "max", "cuda", 1, 13, True):
        (3098873088.0, 6857691136.0),
    (15, 1, 32768, "max_seeded", "cuda", 1, 1, True):
        (47669000.0, 92668160.0),
    (13, 8, 8192, "cap", "f64", 1, 11, True):
        (246902784.0, 1000343360.0),
    (13, 4, 0, "out", "f64", 1, 0, True):
        (25685152.0, 1082176.0),
    (19, 1, 524288, "max", "f64", 1, 14, True):
        (5663375384.0, 23739760960.0),
}


@pytest.mark.parametrize("case", sorted(PINNED))
def test_program_work_is_pinned(case):
    assert work.program_work(*case) == PINNED[case]


@pytest.mark.parametrize("case", sorted(PINNED))
def test_least_time_takes_the_larger_bound(case):
    """Bytes bound the feasibility passes (under one operation a byte);
    operations bound the (min,+) sweep of ``out``."""
    ops, nbytes = PINNED[case]
    t, bound = work.least_time(*case)
    assert bound == ("ops" if case[3] == "out" else "bytes")
    assert t == max(ops / (work.INT32_OPS_PER_S if case[4] == "cuda"
                           else work.F64_OPS_PER_S),
                    nbytes / work.HBM_BYTES_PER_S)

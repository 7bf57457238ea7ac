"""The profiler's device-busy time (``erl_gaussian_process_tpu_torch.profiling``):
kernels that overlap, as the blocked Cholesky's update on its second stream
does, count once."""

import pytest

from erl_gaussian_process_tpu_torch.profiling import busy_ms


@pytest.mark.parametrize("spans,want", [
    ([], 0.0),
    ([(0, 10)], 0.01),
    ([(0, 10), (5, 20), (30, 40), (35, 36)], 0.03),    # overlap, nesting
    ([(30, 40), (0, 10), (10, 15)], 0.025),            # unsorted, touching
])
def test_busy_counts_overlapping_kernels_once(spans, want):
    assert busy_ms(spans) == pytest.approx(want)

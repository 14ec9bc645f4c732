"""The window and percentile arithmetic."""

import numpy as np
import pytest

from portbench.harness import stats


@pytest.mark.parametrize("n", [1, 2, 7, 100, 333])
@pytest.mark.parametrize("q", [0, 50, 95, 99, 100])
def test_percentile_is_numpys_linear(n, q):
    xs = np.random.default_rng(n).exponential(size=n).tolist()
    assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)


def test_percentile_of_nothing_raises():
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_per_item_ms():
    assert stats.per_item_ms(25.0, 400) == pytest.approx(62.5)
    with pytest.raises(ValueError):
        stats.per_item_ms(1.0, 0)

"""The two longest cases of ``test_rows_model_equals_plain``
(``tests/test_torch_lz77_plan.py``): ``rows_model``, the rows' kernel of
``chain_candidates`` walked in Python, on runs of 1 to 299 bytes of values
0-3 at k = 16 and 33, against ``chain_candidates_plain``. They live in a file
of their own so that the test run's whole-file scheduling gives them a
worker of their own."""

import pytest

from tests.test_torch_lz77_plan import SLOW_ROWS_CASES, rows_model_equals_plain


@pytest.mark.parametrize("name, k", SLOW_ROWS_CASES, ids=[f"{name}-{k}" for name, k in SLOW_ROWS_CASES])
def test_rows_model_equals_plain(name, k):
    rows_model_equals_plain(name, k)

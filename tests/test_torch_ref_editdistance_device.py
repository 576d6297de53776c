"""The reference suite's edit-distance tests (tests/test_editdistance_device.py)
on the port: the single-token ``batched_levenshtein``/``batched_damerau``
(infidex_tpu_torch/ops/editdistance.py) and the multi-query banded forms
(ops/editdistance_multi.py), plain PyTorch on the CPU, against the scalar
host oracles of ``utils.metrics``.

The tests are imported, not copied, and run with their module's reference
names bound to the port's objects (the rebinding of
tests/test_torch_entry_points.py).
"""

from tests import test_editdistance_device as suite
from tests.test_torch_entry_points import reference_suites_on_port

# importing test_torch_entry_points put the port on the CPU with one
# intra-op thread
_bound, test_reference_names_are_bound_to_the_port = reference_suites_on_port(
    suite)


test_levenshtein_matches_oracle = suite.test_levenshtein_matches_oracle
test_damerau_matches_oracle = suite.test_damerau_matches_oracle
test_lev_multi_matches_oracle = suite.test_lev_multi_matches_oracle
test_damerau_multi_matches_oracle = suite.test_damerau_multi_matches_oracle

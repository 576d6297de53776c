"""The reference suite's native tier-selection tests
(tests/test_tier_select_native.py) on the port (infidex_tpu_torch, plain
PyTorch on the CPU).

The tests are imported, not copied, and run with their module's reference
names bound to the port's objects (the rebinding of
tests/test_torch_entry_points.py); imports inside a test body resolve to
the port's modules too.
"""

from tests import test_tier_select_native as suite
from tests.test_torch_entry_points import reference_suites_on_port

# importing test_torch_entry_points put the port on the CPU with one
# intra-op thread
_bound, test_reference_names_are_bound_to_the_port = reference_suites_on_port(
    suite, sys_modules=("index.candidates", "native"))


test_top_weight_idx_rule = suite.test_top_weight_idx_rule
test_native_select_matches_numpy = suite.test_native_select_matches_numpy
test_champion_memo_generation_invalidation = \
    suite.test_champion_memo_generation_invalidation
test_tier_batch_matches_per_query_numpy = \
    suite.test_tier_batch_matches_per_query_numpy

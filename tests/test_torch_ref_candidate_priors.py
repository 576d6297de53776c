"""The reference suite's candidate-prior tests
(tests/test_candidate_priors.py) on the port (infidex_tpu_torch, plain
PyTorch on the CPU).

The tests are imported, not copied, and run with their module's reference
names bound to the port's objects (the rebinding of
tests/test_torch_entry_points.py); imports inside a test body resolve to
the port's modules too.
"""

from tests import test_candidate_priors as suite
from tests.test_torch_entry_points import reference_suites_on_port

# importing test_torch_entry_points put the port on the CPU with one
# intra-op thread
_bound, test_reference_names_are_bound_to_the_port = reference_suites_on_port(
    suite, sys_modules=("index.first_token",))


TestFirstTokenIndex = suite.TestFirstTokenIndex
big_engine = suite.big_engine
test_first_token_class_reachable_at_depth = \
    suite.test_first_token_class_reachable_at_depth
test_deep_oracle_nests_production = suite.test_deep_oracle_nests_production
test_class_prior_clip_matches_unclipped = \
    suite.test_class_prior_clip_matches_unclipped

"""The reference suite's vectorised short-query tests
(tests/test_short_query_vec.py) on the port (infidex_tpu_torch, plain
PyTorch on the CPU).

The tests are imported, not copied, and run with their module's reference
names (``SearchEngine``, ``Document``, ``Query``, ...) bound to the port's
objects (the rebinding of tests/test_torch_entry_points.py); imports
inside a test body resolve to the port's modules too.
"""

from tests import test_short_query_vec as short_query
from tests.test_torch_entry_points import reference_suites_on_port

# importing test_torch_entry_points put the port on the CPU with one
# intra-op thread
_bound, test_reference_names_are_bound_to_the_port = reference_suites_on_port(
    short_query, sys_modules=())


engine = short_query.engine
test_vec_matches_scalar = short_query.test_vec_matches_scalar
test_vec_used_in_pipeline = short_query.test_vec_used_in_pipeline
test_small_match_falls_back = short_query.test_small_match_falls_back

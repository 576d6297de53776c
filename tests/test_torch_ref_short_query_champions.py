"""The reference suite's short-query champion tests
(tests/test_short_query_champions.py) on the port (infidex_tpu_torch,
plain PyTorch on the CPU).

The tests are imported, not copied, and run with their module's reference
names bound to the port's objects (the rebinding of
tests/test_torch_entry_points.py); imports inside a test body resolve to
the port's modules too.
"""

from tests import test_short_query_champions as suite
from tests.test_torch_entry_points import reference_suites_on_port

# importing test_torch_entry_points put the port on the CPU with one
# intra-op thread
_bound, test_reference_names_are_bound_to_the_port = reference_suites_on_port(
    suite, sys_modules=())


test_eager_matches_lazy_champions = suite.test_eager_matches_lazy_champions
test_eager_build_idempotent_and_lazy_after = \
    suite.test_eager_build_idempotent_and_lazy_after
test_engine_finalize_builds_champions = \
    suite.test_engine_finalize_builds_champions

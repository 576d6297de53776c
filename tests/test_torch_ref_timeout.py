"""The reference suite's query-timeout tests (tests/test_timeout.py) on the
port (infidex_tpu_torch, plain PyTorch on the CPU).

The tests are imported, not copied, and run with their module's reference
names (``SearchEngine``, ``Document``, ``Query``, ...) bound to the port's
objects (the rebinding of tests/test_torch_entry_points.py); imports
inside a test body resolve to the port's modules too.
"""

from tests import test_timeout as timeout
from tests.test_torch_entry_points import reference_suites_on_port

# importing test_torch_entry_points put the port on the CPU with one
# intra-op thread
_bound, test_reference_names_are_bound_to_the_port = reference_suites_on_port(
    timeout, sys_modules=())


engine = timeout.engine
test_default_timeout_not_enforced = timeout.test_default_timeout_not_enforced
test_explicit_1ms_timeout_returns_partial_flagged = \
    timeout.test_explicit_1ms_timeout_returns_partial_flagged
test_explicit_1ms_timeout_batch = timeout.test_explicit_1ms_timeout_batch
test_generous_timeout_not_flagged = timeout.test_generous_timeout_not_flagged
test_timeout_clamped_to_10s = timeout.test_timeout_clamped_to_10s
test_copy_preserves_explicitness = timeout.test_copy_preserves_explicitness

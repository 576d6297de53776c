"""The reference suite's bulk-build parity tests
(tests/test_bulk_build_parity.py) on the port (infidex_tpu_torch, plain
PyTorch on the CPU).

The tests are imported, not copied, and run with their module's reference
names bound to the port's objects (the rebinding of
tests/test_torch_entry_points.py); imports inside a test body resolve to
the port's modules too.
"""

from tests import test_bulk_build_parity as suite
from tests.test_torch_entry_points import reference_suites_on_port

# importing test_torch_entry_points put the port on the CPU with one
# intra-op thread
_bound, test_reference_names_are_bound_to_the_port = reference_suites_on_port(
    suite, sys_modules=())


test_index_structures_identical = suite.test_index_structures_identical
test_search_results_identical = suite.test_search_results_identical
test_incremental_after_bulk = suite.test_incremental_after_bulk
test_save_load_after_bulk = suite.test_save_load_after_bulk

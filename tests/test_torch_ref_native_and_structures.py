"""The reference suite's native-library and data-structure tests
(tests/test_native_and_structures.py) on the port (infidex_tpu_torch,
plain PyTorch on the CPU).

The tests are imported, not copied, and run with their module's reference
names bound to the port's objects (the rebinding of
tests/test_torch_entry_points.py); imports inside a test body resolve to
the port's modules too.
"""

from tests import test_native_and_structures as suite
from tests.test_torch_entry_points import reference_suites_on_port

# importing test_torch_entry_points put the port on the CPU with one
# intra-op thread
_bound, test_reference_names_are_bound_to_the_port = reference_suites_on_port(
    suite, sys_modules=("index.vector_model", "utils", "utils.metrics"))


TestNativeMetrics = suite.TestNativeMetrics
TestRoaring = suite.TestRoaring
TestTrie = suite.TestTrie
TestPostingsEnums = suite.TestPostingsEnums
TestTieredCandidates = suite.TestTieredCandidates
TestMiscStructures = suite.TestMiscStructures

"""The reference suite's basic engine tests (exact, fuzzy, prefix, scores,
diacritics) (tests/test_engine_basic.py) on the port (infidex_tpu_torch,
plain PyTorch on the CPU).

The tests are imported, not copied, and run with their module's reference
names bound to the port's objects (the rebinding of
tests/test_torch_entry_points.py); imports inside a test body resolve to
the port's modules too.
"""

from tests import test_engine_basic as suite
from tests.test_torch_entry_points import reference_suites_on_port

# importing test_torch_entry_points put the port on the CPU with one
# intra-op thread
_bound, test_reference_names_are_bound_to_the_port = reference_suites_on_port(
    suite, sys_modules=())


engine = suite.engine
TestExactSearch = suite.TestExactSearch
TestFuzzySearch = suite.TestFuzzySearch
TestPrefixSearch = suite.TestPrefixSearch
TestScoresAndMetadata = suite.TestScoresAndMetadata
TestDiacritics = suite.TestDiacritics

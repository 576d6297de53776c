"""The reference suite's tokenizer tests (tests/test_tokenizer.py) on the
port (infidex_tpu_torch, plain PyTorch on the CPU).

The tests are imported, not copied, and run with their module's reference
names bound to the port's objects (the rebinding of
tests/test_torch_entry_points.py); imports inside a test body resolve to
the port's modules too.
"""

from tests import test_tokenizer as suite
from tests.test_torch_entry_points import reference_suites_on_port

# importing test_torch_entry_points put the port on the CPU with one
# intra-op thread
_bound, test_reference_names_are_bound_to_the_port = reference_suites_on_port(
    suite, sys_modules=("tokenization.normalizer", "tokenization.tokenizer"))


TestNormalizer = suite.TestNormalizer
TestIndexingTokenization = suite.TestIndexingTokenization
TestSearchTokenization = suite.TestSearchTokenization
TestCoverageWordTokens = suite.TestCoverageWordTokens
test_search_token_cache_opt_in = suite.test_search_token_cache_opt_in

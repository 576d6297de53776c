"""The reference suite's conjunctive-pool tests (tests/test_conjunctive.py)
on the port (infidex_tpu_torch, plain PyTorch on the CPU).

The tests are imported, not copied, and run with their module's reference
names bound to the port's objects (the rebinding of
tests/test_torch_entry_points.py); imports inside a test body resolve to
the port's modules too.
"""

from tests import test_conjunctive as suite
from tests.test_torch_entry_points import reference_suites_on_port

# importing test_torch_entry_points put the port on the CPU with one
# intra-op thread
_bound, test_reference_names_are_bound_to_the_port = reference_suites_on_port(
    suite, sys_modules=("index.conjunctive",))


engine = suite.engine
test_pool_contains_all_token_doc = suite.test_pool_contains_all_token_doc
test_pool_excludes_single_token_docs = \
    suite.test_pool_excludes_single_token_docs
test_single_word_query_disabled = suite.test_single_word_query_disabled
test_search_finds_buried_conjunctive_doc = \
    suite.test_search_finds_buried_conjunctive_doc
test_deep_oracle_nests_production = suite.test_deep_oracle_nests_production
test_pool_deterministic_and_capped = suite.test_pool_deterministic_and_capped
test_batch_and_single_agree = suite.test_batch_and_single_agree
test_native_pool_parity = suite.test_native_pool_parity
test_pool_memo_hits_and_invalidates = suite.test_pool_memo_hits_and_invalidates

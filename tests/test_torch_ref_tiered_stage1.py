"""The reference suite's tiered Stage-1 tests (tests/test_tiered_stage1.py)
on the port (infidex_tpu_torch, plain PyTorch on the CPU).

The tests are imported, not copied, and run with their module's reference
names bound to the port's objects (the rebinding of
tests/test_torch_entry_points.py); imports inside a test body resolve to
the port's modules too.
"""

from tests import test_tiered_stage1 as suite
from tests.test_torch_entry_points import reference_suites_on_port

# importing test_torch_entry_points put the port on the CPU with one
# intra-op thread
_bound, test_reference_names_are_bound_to_the_port = reference_suites_on_port(
    suite, sys_modules=())


engine = suite.engine
test_pool_scores_match_device_kernel = \
    suite.test_pool_scores_match_device_kernel
test_tiered_topk_matches_device_on_conjunctive_corpus = \
    suite.test_tiered_topk_matches_device_on_conjunctive_corpus
test_engine_results_identical_with_tiering_forced = \
    suite.test_engine_results_identical_with_tiering_forced
test_tier_gate_routing = suite.test_tier_gate_routing
test_tiered_respects_deleted_docs = suite.test_tiered_respects_deleted_docs

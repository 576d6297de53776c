"""The reference suite's batched-search tests (tests/test_search_batch.py) on
the port (infidex_tpu_torch, plain PyTorch on the CPU).

The tests are imported, not copied, and run with their module's reference
names bound to the port's objects (the rebinding of
tests/test_torch_entry_points.py); imports inside a test body resolve to
the port's modules too.

Left out: ``test_replay_last_s1``, TPU link tooling (ROADMAP, "Do not
port").
"""

from tests import test_search_batch as suite
from tests.test_torch_entry_points import reference_suites_on_port

# importing test_torch_entry_points put the port on the CPU with one
# intra-op thread
_bound, test_reference_names_are_bound_to_the_port = reference_suites_on_port(
    suite, sys_modules=(
        "api.fields", "core.documents", "index.device",
        "index.vector_model", "tokenization.normalizer",
        "tokenization.tokenizer"))


engine = suite.engine
test_batch_matches_sequential = suite.test_batch_matches_sequential
test_batch_matches_sequential_device_path = \
    suite.test_batch_matches_sequential_device_path
test_batch_mixed_params = suite.test_batch_mixed_params
test_batch_with_facets_and_filter = suite.test_batch_with_facets_and_filter
test_batch_empty_and_single = suite.test_batch_empty_and_single
test_stage1_device_batch_matches_single = \
    suite.test_stage1_device_batch_matches_single
test_split_batch_by_lanes = suite.test_split_batch_by_lanes
test_champion_clipping_bounds_device_lanes = \
    suite.test_champion_clipping_bounds_device_lanes

"""The reference suite's pipelined-batch tests
(tests/test_pipelined_batches.py: ``search_many`` against
``search_batch``) on the port (infidex_tpu_torch, plain PyTorch on the
CPU).

The tests are imported, not copied, and run with their module's reference
names (``SearchEngine``, ``Document``, ``Query``, ...) bound to the port's
objects (the rebinding of tests/test_torch_entry_points.py); imports
inside a test body resolve to the port's modules too.
"""

from tests import test_pipelined_batches as pipelined
from tests.test_torch_entry_points import reference_suites_on_port

# importing test_torch_entry_points put the port on the CPU with one
# intra-op thread
_bound, test_reference_names_are_bound_to_the_port = reference_suites_on_port(
    pipelined, sys_modules=())


engine = pipelined.engine
test_search_many_matches_search_batch = \
    pipelined.test_search_many_matches_search_batch
test_search_many_single_sub_batch = pipelined.test_search_many_single_sub_batch
test_search_many_empty_and_mixed = pipelined.test_search_many_empty_and_mixed
test_search_many_postprocessing_parity = \
    pipelined.test_search_many_postprocessing_parity
test_search_many_mixed_param_groups = \
    pipelined.test_search_many_mixed_param_groups

"""The reference suite's LIM-class tests (tests/test_lim_class.py) on the
port (infidex_tpu_torch, plain PyTorch on the CPU).

The tests are imported, not copied, and run with their module's reference
names bound to the port's objects (the rebinding of
tests/test_torch_entry_points.py); imports inside a test body resolve to
the port's modules too.

Left out:

* ``test_lim_rows_lowest_true_positions``: it feeds ``jnp`` arrays to
  ``_lim_rows``; its counterpart on torch tensors is in
  tests/test_torch_stage1_epilogue.py.
"""

from tests import test_lim_class as suite
from tests.test_torch_entry_points import reference_suites_on_port

# importing test_torch_entry_points put the port on the CPU with one
# intra-op thread
_bound, test_reference_names_are_bound_to_the_port = reference_suites_on_port(
    suite, sys_modules=("index.builder", "index.device"))


test_champions_reserve_lowest_ids = suite.test_champions_reserve_lowest_ids
test_fuzzy_verify_damerau = suite.test_fuzzy_verify_damerau
test_long_word_transposition_end_to_end = \
    suite.test_long_word_transposition_end_to_end
test_transpositions_knob_restores_reference_ld1 = \
    suite.test_transpositions_knob_restores_reference_ld1
test_native_score_pool_parity = suite.test_native_score_pool_parity
test_depth_nested_candidates_on_tie_heavy_corpus = \
    suite.test_depth_nested_candidates_on_tie_heavy_corpus

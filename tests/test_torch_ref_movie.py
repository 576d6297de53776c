"""The reference suite's movie-title parity tests
(tests/test_movie_parity.py) on the port (infidex_tpu_torch, plain PyTorch
on the CPU).

The tests are imported, not copied, and run with their module's reference
names (``SearchEngine``, ``Document``, ``Query``, ...) bound to the port's
objects (the rebinding of tests/test_torch_entry_points.py); imports
inside a test body resolve to the port's modules too.
"""

from tests import test_movie_parity as movie
from tests.test_torch_entry_points import reference_suites_on_port

# importing test_torch_entry_points put the port on the CPU with one
# intra-op thread
_bound, test_reference_names_are_bound_to_the_port = reference_suites_on_port(
    movie, sys_modules=())


engine = movie.engine
test_redemption_sh_prefers_shawshank = \
    movie.test_redemption_sh_prefers_shawshank
test_shawshank_variants = movie.test_shawshank_variants
test_shawsh_prefers_shawshank_over_shaws = \
    movie.test_shawsh_prefers_shawshank_over_shaws
test_matrix_typos = movie.test_matrix_typos
test_the_matrx_prefers_matrix_over_match = \
    movie.test_the_matrx_prefers_matrix_over_match
test_the_matri_finds_matrix_sequels = movie.test_the_matri_finds_matrix_sequels
test_the_hear_prefers_hearse = movie.test_the_hear_prefers_hearse
test_eatrix_prefers_beatrix_farrand = movie.test_eatrix_prefers_beatrix_farrand
test_as_am_prefers_as_i_am = movie.test_as_am_prefers_as_i_am
test_fellowship_of_the_ring = movie.test_fellowship_of_the_ring
test_san_a_precedence = movie.test_san_a_precedence
test_two_f_prefers_strict_prefix = movie.test_two_f_prefers_strict_prefix
test_star_grouping = movie.test_star_grouping
test_sap_prefix_at_title_start = movie.test_sap_prefix_at_title_start
test_single_letter_a = movie.test_single_letter_a
test_single_letter_x_exact = movie.test_single_letter_x_exact
test_two_letters_th = movie.test_two_letters_th
test_io_exact = movie.test_io_exact
test_de_prefix_at_title_start = movie.test_de_prefix_at_title_start
test_two_fo_exact_prefixes_before_partial = \
    movie.test_two_fo_exact_prefixes_before_partial
test_short_query_two_letters_partial_match = \
    movie.test_short_query_two_letters_partial_match
test_short_query_two_letters_multiple_partials = \
    movie.test_short_query_two_letters_multiple_partials
test_short_query_single_letter_returns_all_matches = \
    movie.test_short_query_single_letter_returns_all_matches
test_short_query_no_exact_match_returns_partial = \
    movie.test_short_query_no_exact_match_returns_partial

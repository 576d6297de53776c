"""The plain reference that decides ``correct``.

Written for this benchmark from the upstream engine's rules, in plain
Python and NumPy; it imports nothing of ``infidex_tpu_torch`` (nor
``jax`` or ``infidex_tpu``) and takes nothing the program made but the
candidates and Stage-1 scores named below.

* ``stats.py``: the corpus statistics, from the titles.
* ``score.py``: one candidate's coverage, fusion signals and fused score.
* ``answers.py``: a query's ranked top records from its candidates.

The candidate pool of a query (which documents are scored, each with its
Stage-1 base score) is heuristic: champion-clipped Stage-1 lanes, tiered
selection, WordMatcher heads, conjunctive and prior pools. The reference
follows the program's pool, read from its state on a replay of the same
query, and scores every candidate of it again from the texts.
"""

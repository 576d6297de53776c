"""Query generators, one module a ``generator`` name of the traffic files.

A traffic file names its generator (``"generator": "<name>"``, no
default): ``benchmark/generators/<name>.py``, whose

    queries(made, traffic, n, rng) -> List[Spec]

gives ``n`` queries over what the configuration's deployment made
(``made``, from its ``documents``), in the proportions the traffic file
states, drawn from ``rng``, one of the run's streams (``streams``). Each
query is a ``Spec``: its text and the ``Query`` attributes set beside it
(a filter as Infiscript text, ``enable_facets``, ...), which the entries
pass to ``Query`` (``entries.make_query``).
"""

from __future__ import annotations

import random
from typing import Any, Dict, NamedTuple, Tuple


class Spec(NamedTuple):
    """One query: its text, and ``(attribute, value)`` pairs of ``Query``,
    sorted by attribute, that the entry sets before it serves it."""
    text: str
    options: Tuple[Tuple[str, Any], ...] = ()


def streams(seed: int) -> Dict[str, random.Random]:
    """The run's independent random streams, each from ``seed``: the
    warm-up's queries, the window's, and the check's sample of them."""
    return {name: random.Random(f"{seed}:{name}")
            for name in ("warmup", "timed", "sample")}

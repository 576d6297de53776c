"""The fielded deployment's reference: filters, Stage 1 over the titles a
filter passes, the ranking, and the facets, worked out from the titles
and their attributes.

* Filters: a plain evaluator of the refinement generator's forms, from
  the Infiscript semantics (Infidex ``Api/Infiscript.bnf``;
  ``Filtering/FilterVM.cs``): ``field CONTAINS 'text'`` a
  case-insensitive substring of the field's text, ``field = 'text'`` a
  case-insensitive equality of texts, ``field BETWEEN a AND b`` an
  inclusive numeric range, and ``AND`` of such conditions.
* Stage 1: ``stage1.Stage1Index`` with the titles the filter rejects
  scored 0 (``FilteredStage1``), so that the k best are the k best of
  those it passes; the scores of a title are the filter's to keep, not
  to change.
* The ranking: ``answers.answer`` over the program's candidates (read on
  the replay, as the titles reference reads them); then the post-filter
  (ResultProcessor.cs:35-70) on the result list, then the first ``top``.
* Facets (Core/FacetBuilder.cs:19-56): over the query's whole filtered
  result list, each field's values (as text) counted, by count
  descending, then value ascending, the first 100 a field; a field with
  no value is left out.

Nothing here imports the program.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Callable, Dict, List, Optional

import numpy as np

from .. import check
from . import answers
from .score import f32
from .stage1 import Stage1Index

LIMITS = dict(check.LIMITS, filter_violations=0, facets_mismatched=0)
#: values kept a facet field (FacetBuilder.cs: maxFacetsPerField)
FACETS_PER_FIELD = 100
#: a candidate pool's answer that came from no candidate: ``answers``
#: gives its Stage-1 argument back then
_FROM_STAGE1 = (-1, 0.0)

_COND = re.compile(
    r"\s*(\w+)\s+(?:(CONTAINS|=)\s+'([^']*)'"
    r"|BETWEEN\s+(-?\d+(?:\.\d+)?)\s+AND\s+(-?\d+(?:\.\d+)?))\s*",
    re.IGNORECASE)
_AND = re.compile(r"AND\b", re.IGNORECASE)


def parse(text: str) -> List[tuple]:
    """A filter of the generator's forms as its conditions, all of which
    must hold: ``(field, "contains" | "eq", text)`` or ``(field,
    "between", low, high)``."""
    conds, at = [], 0
    while True:
        m = _COND.match(text, at)
        if m is None:
            raise ValueError(f"not a filter of the refinement forms: "
                             f"{text!r} at {at}")
        field, op, value, low, high = m.groups()
        if op is None:
            conds.append((field, "between", float(low), float(high)))
        else:
            conds.append((field, "eq" if op == "=" else "contains", value))
        at = m.end()
        if at == len(text):
            return conds
        a = _AND.match(text, at)
        if a is None:
            raise ValueError(f"expected AND in {text!r} at {at}")
        at = a.end()


class Reference:
    """The titles' corpus and attributes; masks a filter text each. It
    stands in for its ``Corpus`` where a reader of the titles reference
    is handed it (``benchmark/control.py``)."""

    def __init__(self, corpus, attributes: Dict[str, list]):
        self.corpus = corpus
        self.attributes = attributes
        self.stage1 = FilteredStage1(corpus)
        self._masks: Dict[str, np.ndarray] = {}
        self._columns: Dict[str, tuple] = {}
        #: ``observed(spec, got)``: the facets the program served (set by
        #: the deployment)
        self.observed: Optional[Callable] = None

    def __getattr__(self, name):
        if name == "corpus":       # not set yet
            raise AttributeError(name)
        return getattr(self.corpus, name)

    def _column(self, field: str):
        """(distinct values as text, each title's place among them,
        numeric values or None)."""
        col = self._columns.get(field)
        if col is None:
            raw = self.attributes[field]
            values, codes = np.unique(np.asarray([str(v) for v in raw]),
                                      return_inverse=True)
            nums = None
            if all(isinstance(v, (int, float)) for v in raw[:1000]):
                nums = np.asarray(raw, np.float64)
            col = self._columns[field] = (values, codes, nums)
        return col

    def mask(self, text: Optional[str]) -> Optional[np.ndarray]:
        """Whether each title passes the filter ``text``; None without."""
        if text is None:
            return None
        m = self._masks.get(text)
        if m is None:
            m = np.ones(self.corpus.n, bool)
            for field, op, *args in parse(text):
                values, codes, nums = self._column(field)
                if op == "between":
                    m &= (nums >= args[0]) & (nums <= args[1])
                    continue
                want = args[0].lower()
                per_value = np.asarray(
                    [(want in v.lower()) if op == "contains"
                     else (v.lower() == want) for v in values], bool)
                m &= per_value[codes]
            self._masks[text] = m
        return m

    def facets(self, keys: List[int]) -> Dict[str, list]:
        """The facets of a result list of title keys."""
        out = {}
        for field, raw in self.attributes.items():
            counts = Counter(str(raw[k]) for k in keys)
            counts.pop("", None)
            if counts:
                out[field] = sorted(counts.items(),
                                    key=lambda kv: (-kv[1], kv[0])
                                    )[:FACETS_PER_FIELD]
        return out


class FilteredStage1(Stage1Index):
    """Stage 1 with the titles ``mask`` rejects scored 0 wherever every
    title is scored (the k best), never where given titles are."""

    mask: Optional[np.ndarray] = None

    def _sums(self, q: str, route: str, docs=None) -> np.ndarray:
        s = super()._sums(q, route, docs)
        if docs is None and self.mask is not None:
            s = np.where(self.mask, s, np.float32(0))
        return s


def judge(ref: Reference, specs, got: List[Optional[list]],
          replayed: List[Optional[list]], state: Dict[str, dict], top: int,
          observed: Callable, rounding: Callable[[float], float] = f32,
          log: Callable[[str], None] = None) -> Dict[str, dict]:
    """The compared numbers of one sample: ``check.judge``'s four, with
    each query's filter, and two more, each a count of sampled queries:

    * ``filter_violations``: a record, or an entry of the Stage-1 list,
      that the query's filter rejects;
    * ``facets_mismatched``: facets served with the answer (``observed``)
      that differ from the reference's over its whole filtered result
      list, or none served. Where the records are the whole list (the
      ranked candidates' page), every answer served with them is held to
      it; where the whole list runs on past them (the Stage-1 list's
      tail, which the route of a query's batch chooses), the reference's
      list, worked out from the replay's state, must be one served."""
    index = ref.stage1
    found = {name: [] for name in LIMITS}
    for i, (spec, g, r) in enumerate(zip(specs, got, replayed)):
        mask = ref.mask(dict(spec.options).get("filter"))
        passes = (lambda d: True) if mask is None else \
            (lambda d: bool(mask[d]))
        if r != g:
            found["replay_differs"].append(i)
        st = state.get(answers.query_text(spec.text))
        want = None
        bad_rows = g is not None and any(not passes(d) for d, _ in g)
        if st is not None and "stage1" in st:
            probe = answers.answer(
                ref.corpus, spec.text, st.get("ids", []),
                st.get("bases", []), st.get("wm", False), [_FROM_STAGE1],
                top, rounding)
            from_stage1 = probe == [_FROM_STAGE1]
            whole = [e for e in (st["stage1_all"] if from_stage1 else probe)
                     if passes(e[0])]
            want = whole[:top]
            index.mask = mask
            scores_ok, top_ok = check.stage1_verdict(index, spec.text,
                                                     st["stage1_all"])
            index.mask = None
            bad_rows |= any(not passes(d) for d, _ in st["stage1_all"])
            served = observed(spec, g)
            facets = ref.facets([d for d, _ in whole])
            if facets not in served or (not from_stage1 and any(
                    f != facets for f in served)):
                found["facets_mismatched"].append(i)
        else:
            scores_ok, top_ok = False, False
            found["facets_mismatched"].append(i)
        if not scores_ok:
            found["stage1_scores"].append(i)
        if top_ok is False:
            found["stage1_top"].append(i)
        if bad_rows:
            found["filter_violations"].append(i)
        if g is None or want is None or g != want:
            found["mismatched"].append(i)
            if log is not None and len(found["mismatched"]) <= 4:
                log(f"[check] {spec.text!r} {dict(spec.options)}: program "
                    f"{g}, reference {want}")
    n = len(specs)
    return {name: {"value": len(idx), "limit": LIMITS[name], "of": n}
            for name, idx in found.items()}

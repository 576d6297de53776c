"""One candidate's final score: coverage, fusion signals and fusion.

Plain Python, written for this benchmark from the upstream engine's
scoring rules (Infidex ``Coverage/*Matcher.cs``, ``CoverageScorer.cs``,
``FusionSignalComputer.cs``, ``Scoring/FusionScorer.cs``,
``StringMetrics.cs``, ``LevenshteinDistance.cs``). It shares no code with
the program. One call scores one (query, document) pair from their texts,
the corpus statistics of ``stats.py`` and the candidate's Stage-1 base
score.

Every quantity that is not a whole number is a float32, rounded after
each operation, as the upstream's ``float`` arithmetic has it; the one
place where an order of operations is a choice, the dominant term's test
(is one term's idf times coverage at least the others' sum), takes the
sum of all terms less the term's own. The final score is ``precedence +
semantic``; ``rounding`` replaces its last rounding (the control rounds
it to bfloat16).
"""

from __future__ import annotations

import re
from functools import lru_cache
from typing import Callable, List, NamedTuple

import numpy as np

#: CoverageSetup.create_default()
MIN_WORD = 2
LEV_MAX_WORD = 20
NUM_TYPOS = 2
ONE_TYPO_LEN = 3
TWO_TYPOS_LEN = 7
LCS_Q_LIMIT = 5
LCS_TOLERANCE = 0.2
#: FusionSignalComputer
ANCHOR_STEM = 3
TRAILING_MAX = 2
INTENT_BONUS = 0.15


F = np.float32
ZERO, ONE = F(0), F(1)


def f32(x: float) -> float:
    return float(F(x))


# ----------------------------------------------------------------------
# string metrics

@lru_cache(maxsize=1 << 20)
def lev(a: str, b: str, cap: int) -> int:
    """Levenshtein distance; ``cap + 1`` once every cell of a column
    passes ``cap``."""
    if not a:
        return len(b)
    if not b:
        return len(a)
    if len(a) > len(b):
        a, b = b, a
    row = list(range(len(a) + 1))
    for j, cb in enumerate(b, 1):
        prev_diag, row[0] = row[0], j
        best = j
        for i, ca in enumerate(a, 1):
            cur = prev_diag if ca == cb else 1 + min(prev_diag, row[i],
                                                     row[i - 1])
            prev_diag, row[i] = row[i], cur
            best = min(best, cur)
        if best > cap:
            return cap + 1
    return row[-1]


@lru_cache(maxsize=1 << 20)
def damerau(a: str, b: str, cap: int) -> int:
    """Levenshtein, rescued by one adjacent transposition at the first
    mismatch when that brings it within ``cap``."""
    if abs(len(a) - len(b)) > cap:
        return cap + 1
    d = lev(a, b, cap + 1)
    if d <= cap or d > cap + 1:
        return d
    for i in range(min(len(a) - 1, len(b))):
        if a[i] == b[i]:
            continue
        if i + 1 < len(b) and a[i] == b[i + 1] and a[i + 1] == b[i] \
                and cap >= 1:
            rest = lev(a[i + 2:], b[i + 2:], cap - 1)
            if rest <= cap - 1:
                return 1 + rest
        break
    return d


def lcs_value(q: str, text: str, tol: int) -> int:
    """StringMetrics' "LCS": the query's length when the text holds it,
    else the shared prefix plus the tolerance, capped by both lengths."""
    if not q or not text:
        return 0
    if q in text:
        return len(q)
    n = 0
    for x, y in zip(q, text):
        if x != y:
            break
        n += 1
    return 0 if n == 0 else min(n + tol, len(q), len(text))


def lcs_tolerance(query: str) -> int:
    return int(len(query) * LCS_TOLERANCE) if len(query) >= LCS_Q_LIMIT \
        else 0


# ----------------------------------------------------------------------
# tokens

class Tok(NamedTuple):
    text: str      # lower case
    start: int     # character offset in its string
    end: int


@lru_cache(maxsize=16)
def _word_re(delims: frozenset):
    return re.compile("[^" + re.escape("".join(sorted(delims))) + "]+")


def slices(text: str, min_len: int, delims) -> List[Tok]:
    """The words of ``text`` between delimiters, of ``min_len`` or more
    characters, lower-cased, with their places."""
    return [Tok(m.group().lower(), m.start(), m.end())
            for m in _word_re(frozenset(delims)).finditer(text)
            if m.end() - m.start() >= min_len]


def distinct(toks: List[Tok]) -> List[Tok]:
    seen, out = set(), []
    for t in toks:
        if t.text not in seen:
            seen.add(t.text)
            out.append(t)
    return out


# ----------------------------------------------------------------------
# coverage: four matchers in turn, each token used once

class Terms:
    """Per query term: matched characters and how it was matched."""

    def __init__(self, q: List[Tok], d: List[Tok]):
        self.q, self.d = q, d
        self.q_free = [True] * len(q)
        self.d_free = [True] * len(d)
        self.chars = [ZERO] * len(q)
        self.whole = [False] * len(q)
        self.joined = [False] * len(q)
        self.prefix = [False] * len(q)
        self.first = [-1] * len(q)
        self.hits = 0

    def take(self, i: int, j: int, chars, pos: int) -> None:
        self.chars[i] = F(self.chars[i] + F(chars))
        if self.first[i] < 0 or pos < self.first[i]:
            self.first[i] = pos
        self.q_free[i] = False
        if j >= 0:
            self.d_free[j] = False


def _first_free(free: List[bool], lo: int) -> int:
    for k in range(lo, len(free)):
        if free[k]:
            return k
    return -1


def match_whole(m: Terms) -> None:
    for i, qt in enumerate(m.q):
        j = next((j for j, dt in enumerate(m.d)
                  if m.d_free[j] and dt.text == qt.text), -1)
        if j < 0:
            continue
        m.hits += 1
        m.whole[i] = m.prefix[i] = True
        m.take(i, j, len(qt.text), m.d[j].start)


def match_joined(m: Terms) -> None:
    q, d = m.q, m.d
    for i in range(len(q) - 1):
        if not (m.q_free[i] and m.q_free[i + 1]):
            continue
        k = _first_free(m.q_free, i + 1)
        if k < 0:
            break
        a, b = q[i].text, q[k].text
        j = next((j for j, dt in enumerate(d)
                  if m.d_free[j] and len(dt.text) == len(a) + len(b)
                  and dt.text.startswith(a) and dt.text.endswith(b)), -1)
        if j < 0:
            continue
        m.hits += 2
        m.joined[i] = m.prefix[i] = True
        m.joined[k] = True
        m.take(i, -1, len(a), d[j].start)
        m.take(k, j, len(b), d[j].start)
    for j in range(len(d) - 1):
        if not m.d_free[j]:
            continue
        k = _first_free(m.d_free, j + 1)
        if k < 0:
            break
        a, b = d[j].text, d[k].text
        i = next((i for i, qt in enumerate(q)
                  if m.q_free[i] and len(qt.text) == len(a) + len(b)
                  and qt.text.startswith(a) and qt.text.endswith(b)), -1)
        if i < 0:
            continue
        m.hits += 1
        m.joined[i] = m.prefix[i] = True
        m.take(i, j, len(a) + len(b), d[j].start)
        m.d_free[k] = False


def _longest_first(toks: List[Tok], free: List[bool]) -> List[int]:
    return sorted((i for i in range(len(toks)) if free[i]),
                  key=lambda i: -len(toks[i].text))


def match_affix(m: Terms) -> None:
    qs = _longest_first(m.q, m.q_free)
    ds = _longest_first(m.d, m.d_free)
    # exact: the query term a prefix, suffix or (4+) part of a doc word,
    # or a doc word a suffix of the query term
    for i in qs:
        if not m.q_free[i]:
            continue
        a = m.q[i].text
        for j in ds:
            if not m.d_free[j]:
                continue
            b = m.d[j].text
            pts, pre = None, False
            if len(a) < len(b):
                if b.startswith(a):
                    pts, pre = F(len(a)), True
                elif b.endswith(a):
                    pts = F(max(1, len(a) // 2))
                elif len(a) >= 4 and a in b:
                    pts = F(len(a)) * F(0.6)
            elif len(a) > len(b) and a.endswith(b):
                pts = F(len(b))
            if pts is None:
                continue
            m.hits += 1
            if pre:
                m.prefix[i] = True
            m.take(i, j, pts, m.d[j].start)
            break
    # fuzzy prefix: within one edit of a doc word's first |a|, |a|+1 or
    # |a|-1 characters
    last = len(m.q) - 1
    for i in qs:
        if not m.q_free[i]:
            continue
        a = m.q[i].text
        n = len(a)
        if n < 4 and not (i == last and n >= 2):
            continue
        for j in ds:
            if not m.d_free[j]:
                continue
            b = m.d[j].text
            if n >= len(b):
                continue
            pts = None
            e = damerau(a, b[:n], 1)
            if e <= 1:
                pts = max(F(n - e), F(0.1))
            else:
                e = damerau(a, b[:n + 1], 1)
                if e <= 1:
                    pts = max(F(n - e), F(0.1))
                elif n > 1:
                    e = damerau(a, b[:n - 1], 1)
                    if e <= 1:
                        pts = max(F(n - 1 - e), F(0.1))
            if pts is None:
                continue
            m.hits += 1
            m.take(i, j, pts, m.d[j].start)
            break


def _typo_budget(n: int):
    """(edits allowed, whether the two-letter rule applies)."""
    k = 2 if n >= TWO_TYPOS_LEN else 1 if n >= ONE_TYPO_LEN else 0
    short = n == 2 and k == 0 and NUM_TYPOS >= 1
    if short:
        k = 1
    return min(k, NUM_TYPOS), short


def match_fuzzy(m: Terms) -> None:
    longest = max((len(t.text) for i, t in enumerate(m.q) if m.q_free[i]),
                  default=0)
    if longest == 0:
        return
    top, _ = _typo_budget(longest)
    for e in range(1, top + 1):
        if not any(m.q_free):
            break
        for i, qt in enumerate(m.q):
            if not m.q_free[i]:
                continue
            a = qt.text
            n = len(a)
            if n < MIN_WORD:
                continue
            k, short = _typo_budget(n)
            if e > k or (short and e != 1):
                continue
            lo, hi = max(MIN_WORD, n - e), min(LEV_MAX_WORD, n + e, 63)
            for j, dt in enumerate(m.d):
                b = dt.text
                if not m.d_free[j] or not lo <= len(b) <= hi:
                    continue
                if short and (not b or b[0] != a[0]):
                    continue
                dist = damerau(a, b, e)
                if dist <= e:
                    m.hits += 1
                    m.take(i, j, n - dist, dt.start)
                    break


class Features(NamedTuple):
    terms: int
    any_match: int
    strict: int
    prefixed: int
    first_pos: int
    sum_ci: float
    hits: int
    doc_tokens: int
    prefix_run: int
    suffix_run: int
    preceding_strict: int
    last_prefixed: bool
    last_type_ahead: bool
    idf_coverage: float
    total_idf: float
    missing_idf: float
    word_idf: List[float]
    ci: List[float]


def features(q: List[Tok], d: List[Tok], doc_tokens: int,
             term_idf: List[float], word_idf: List[float], qlen: int,
             lcs: int) -> Features:
    m = Terms(q, d)
    match_whole(m)
    if q:
        match_joined(m)
        match_affix(m)
        if any(m.chars[i] < len(t.text) for i, t in enumerate(q)):
            match_fuzzy(m)
    n = len(q)
    ci = [ZERO] * n
    sum_ci = total_idf = idf_sum = missing = ZERO
    any_match = strict = prefixed = 0
    first = -1
    last_idf = ZERO
    for i, t in enumerate(q):
        width = F(len(t.text))
        idf_i = F(term_idf[i])
        c = min(F(m.chars[i] / width), ONE)
        ci[i] = c
        sum_ci = F(sum_ci + c)
        any_match += bool(c > 0)
        total_idf = F(total_idf + idf_i)
        idf_sum = F(idf_sum + F(c * idf_i))
        if c < ONE:
            missing = F(missing + F(F(ONE - c) * idf_i))
        if i == n - 1:
            last_idf = idf_i
        full = bool(m.chars[i] >= F(width - F(0.01)))
        strict += (m.whole[i] or m.joined[i]) and full
        prefixed += m.prefix[i]
        if m.first[i] >= 0 and (first < 0 or m.first[i] < first):
            first = m.first[i]
    type_ahead = n > 0 and total_idf > 0 and \
        F(last_idf / total_idf) <= F(ONE / F(n + 1))
    if n == 1 and qlen > 0 and lcs > 0:
        sum_ci = max(sum_ci, min(F(F(lcs) / F(qlen)), ONE))
    lit = [m.prefix[i] and m.chars[i] > 0 for i in range(n)]
    run = best = 0
    for x in lit:
        run = run + 1 if x else 0
        best = max(best, run)
    tail = 0
    for x in reversed(lit):
        if not x:
            break
        tail += 1
    pre_strict = sum(
        1 for i in range(n - 1)
        if (m.whole[i] or m.joined[i])
        and m.chars[i] >= F(F(len(q[i].text)) - F(0.01))) if n >= 2 else 0
    return Features(
        terms=n, any_match=any_match, strict=strict, prefixed=prefixed,
        first_pos=first, sum_ci=sum_ci, hits=m.hits, doc_tokens=doc_tokens,
        prefix_run=best, suffix_run=tail, preceding_strict=pre_strict,
        last_prefixed=n > 0 and m.prefix[-1] and bool(m.chars[-1] > 0),
        last_type_ahead=bool(type_ahead),
        idf_coverage=F(idf_sum / total_idf) if total_idf > 0 else ZERO,
        total_idf=total_idf, missing_idf=missing,
        word_idf=[F(x) for x in word_idf], ci=ci)


# ----------------------------------------------------------------------
# fusion signals, over every token (no minimum length)

class Signals(NamedTuple):
    n_query: int
    prefix_last: bool
    perfect_doc: bool
    stem_evidence: bool
    anchor: bool
    trailing: int        # 0..255
    single_sim: int      # 0..255
    char_boost: int


def _byte(x) -> int:
    return int(min(max(F(x * F(255)), ZERO), F(255)))


def _single_sim(q: str, words: List[str]):
    n = len(q)
    if n < 3:
        return ZERO
    fn = F(n)
    best = ZERO
    for w in words:
        if len(w) < 2:
            continue
        at = q.find(w)
        if at >= 0:
            best = max(best, F(F(F(len(w)) / fn) * F(ONE - F(F(at) / fn))))
            continue
        k = next((k for k in range(min(n, len(w)), 1, -1)
                  if q[n - k:] == w[:k]), 0)
        score = F(F(k) / fn)
        if len(w) <= 32:
            e = damerau(q, w, 2)
            if e <= 2:
                score = max(score, F(F(n - e) / fn))
        best = max(best, score)
    if n >= 6:
        seg = min(6, n // 2)
        head, tail = q[:seg], q[n - seg:]
        hi = ti = -1
        for i, w in enumerate(words):
            if len(w) < 3:
                continue
            if hi < 0 and (w.startswith(head) or head.startswith(w)):
                hi = i
            if ti < 0 and (w.endswith(tail) or tail.endswith(w)):
                ti = i
            if hi >= 0 and ti >= 0:
                break
        if hi >= 0 and ti >= 0 and hi != ti:
            best = max(best, min(F(F(2 * seg) / fn), ONE))
    return best


def _char_boost(doc: str, qw: List[str], d: List[Tok]) -> int:
    last = qw[-1]
    if len(last) != 1 or not last.isalpha():
        return 0
    at, first = 0, -1
    for w in qw[:-1]:
        while at < len(d) and w not in d[at].text:
            at += 1
        if at == len(d):
            return 0
        if first < 0:
            first = at
    if at + 1 < len(d) and d[at + 1].text[:1] == last \
            and all(c.isspace() for c in doc[d[at].end:d[at + 1].start]):
        return 8 + max(0, 16 - first) + (4 if len(d[at + 1].text) == 1
                                         else 0)
    return 0


def signals(query: str, doc: str, q: List[Tok], d: List[Tok],
            first_word: str, n_words: int) -> Signals:
    qw, dw = [t.text for t in q], [t.text for t in d]
    if not qw or not dw:
        return Signals(len(qw), False, False, False, False, 0, 0, 0)
    if len(qw) == 1:
        prefix_last = any(w.startswith(qw[0]) for w in dw)
    else:
        prefix_last = all(w in dw for w in qw[:-1] if w) and \
            (not qw[-1] or any(w.startswith(qw[-1]) for w in dw))
    perfect = all(any(w.startswith(x) or x.startswith(w) for x in qw)
                  for w in dw)
    stem = False
    if len(qw) >= 2:
        missing = found = 0
        for x in qw:
            if len(x) < MIN_WORD or any(w and w.startswith(x) for w in dw):
                continue
            missing += 1
            for w in dw:
                if len(w) < MIN_WORD:
                    continue
                if x.startswith(w):
                    found += 1
                    break
                if min(len(x), len(w)) >= MIN_WORD:
                    p = 0
                    while p < min(len(x), len(w)) and x[p] == w[p]:
                        p += 1
                    if p >= MIN_WORD:
                        found += 1
                        break
        stem = missing > 0 and found == missing
    anchor = False
    if len(qw[0]) >= ANCHOR_STEM:
        s = qw[0][:ANCHOR_STEM]
        if n_words > 0 and len(first_word) >= len(s):
            anchor = first_word.startswith(s) or any(
                len(w) >= len(s) and w.startswith(s) for w in dw[1:])
        elif n_words == 0:
            anchor = any(len(w) >= len(s) and w.startswith(s) for w in dw)
    trailing = 0
    if len(qw) >= 2 and 1 <= len(qw[-1]) <= TRAILING_MAX:
        t = qw[-1]
        k = sum(1 for w in dw if w.startswith(t) or (len(w) > len(t)
                                                      and t in w))
        if k:
            trailing = _byte(F(F(k) / F(len(dw))))
    sim = _byte(_single_sim(qw[0], dw)) if len(qw) == 1 else 0
    boost = _char_boost(doc, qw, d) if len(qw) >= 2 else 0
    return Signals(len(qw), prefix_last, perfect, stem, anchor, trailing,
                   sim, boost)


# ----------------------------------------------------------------------
# fusion: precedence bits + a semantic fraction

def fuse(query: str, doc: str, f: Features, s: Signals, base,
         rounding: Callable[[float], float] = f32):
    """(score, tiebreaker) of one candidate."""
    n = s.n_query if s.n_query > 0 else f.terms
    single = n <= 1
    t = f.terms
    ft = F(max(t, 1))
    complete = t > 0 and f.any_match == t
    clean = t > 0 and f.prefixed == t
    exact = t > 0 and f.strict == t
    at_start = f.first_pos == 0
    prefix_last_strong = s.prefix_last and t >= 1 and \
        f.preceding_strict == t - 1 and f.last_prefixed
    ratio = F(F(f.any_match) / ft) if t > 0 else ZERO
    partial = ZERO < ratio < ONE
    unmatched = t - f.any_match
    last_ok = f.last_prefixed or complete
    idf_usable = (last_ok or not f.last_type_ahead) and f.total_idf > 0

    p = 0
    if not single and t > 0:
        tier = 3 if f.any_match >= t else 2 if f.any_match == t - 1 else \
            1 if f.any_match * 2 >= t else 0
        p |= tier << 16
    if not single and clean and at_start and s.prefix_last and complete:
        p |= 1 << 15
    if not single and f.doc_tokens > 0 and f.hits == f.doc_tokens:
        p |= 1 << 14
    if not single and t >= 2:
        avg = F(f.total_idf / ft) if f.total_idf > 0 else ZERO
        power = [F(f.word_idf[i] * f.ci[i]) for i in range(t)]
        total = ZERO
        for x in power:
            total = F(total + x)
        dominant = any(
            f.ci[c] > F(0.1) and f.word_idf[c] > 0 and f.word_idf[c] >= avg
            and power[c] >= F(total - power[c]) for c in range(t))
        if dominant or (s.anchor and f.word_idf[0] >= avg):
            p |= 1 << 13
        if dominant and unmatched == 1:
            p |= 8
    if single:
        p |= (1 << 17 if complete else 0) | (1 << 16 if clean else 0)
        if complete:
            tier = (4 if exact else 3 if clean else 0) if at_start else \
                (2 if exact else 1 if clean else 0)
            p |= tier << 3
    else:
        multi = 3 if prefix_last_strong else 2 if s.prefix_last else \
            1 if (s.perfect_doc or (s.anchor and f.prefix_run >= 2)) else 0
        if s.n_query > t:
            multi += s.char_boost
        p |= multi
    gap = F(ONE - ratio)
    if partial and n >= 2:
        if s.stem_evidence:
            p |= 8
        elif unmatched == 1 and idf_usable and \
                F(f.missing_idf / max(f.total_idf, F(1e-30))) < gap:
            p |= 8

    avg_ci = F(f.sum_ci / ft) if t > 0 else ZERO
    if single:
        sem = F(F(avg_ci + F(F(s.single_sim) / F(255))) / F(2))
    elif f.doc_tokens == 0:
        sem = avg_ci
    else:
        use_idf = partial and unmatched == 1 and idf_usable and \
            f.idf_coverage > ratio
        sem = F((f.idf_coverage if use_idf else avg_ci)
                * F(F(f.hits) / F(f.doc_tokens)))
        if t >= 3:
            k = (1 if s.anchor else 0) + (1 if f.suffix_run >= 2 else 0)
            if k:
                sem = min(F(sem + F(F(INTENT_BONUS) * F(k))), ONE)
        trailing = F(F(s.trailing) / F(255))
        if t >= 2 and trailing > 0:
            sem = F(sem + F(F(ONE - sem) * trailing))
    base = F(base)
    if partial and base >= gap:
        sem = F(F(ratio * sem) + F(gap * base))
    sem = min(max(sem, ZERO), F(0.999))
    tie = 0
    if n >= 2 and doc:
        focus = min(F(F(len(query)) / F(len(doc))), ONE)
        tie = int(F(focus * F(255)))
    return rounding(float(F(F(p) + sem))), tie


def term_idf_fallback(word: str) -> float:
    return float(np.log2(len(word) + 1))


def score(query: str, doc: str, q_cov: List[Tok], q_all: List[Tok],
          term_idf: List[float], word_idf: List[float], first_word: str,
          n_words: int, base: float, delims,
          rounding: Callable[[float], float] = f32):
    """(score, tiebreaker, word hits, lcs) of one candidate. ``q_cov``:
    the query's distinct terms of at least two characters; ``q_all``: all
    its words."""
    d_any = slices(doc, 0, delims)
    d_all = [t for t in d_any if len(t.text) >= MIN_WORD]
    lcs = min(lcs_value(query.lower(), doc.lower(), lcs_tolerance(query)),
              255)
    f = features(q_cov, distinct(d_all), len(d_all), term_idf, word_idf,
                 len(query), lcs)
    s = signals(query, doc, q_all, d_any, first_word, n_words)
    sc, tie = fuse(query, doc, f, s, base, rounding)
    return sc, tie, f.hits, lcs


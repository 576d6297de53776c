"""Stage 1's BM25+ scores, worked out from the titles.

The upstream's relevancy stage (Infidex ``Tokenization/Tokenizer.cs``,
``Indexing/VectorModel.cs``, ``Bm25Scorer.cs``) as
``SearchEngine.create_default()`` sets it up:

* a title's terms are its character 3-grams over the title behind two
  padding characters, and its words of 3 or more characters; a term's
  weight in a title is how often it occurs there; a title's length is
  the sum of its weights, and avgdl their mean in float32;
* a query's terms are its words of 3 or more characters, then its
  padded 3-grams, each once, in that order (where the query mixes words
  shorter than 3 characters with longer ones, only the longer words are
  scored); a word of 4 or more characters that no title holds becomes a
  fuzzy group: every term within one edit (Levenshtein, or one adjacent
  transposition) of it, their titles taken together;
* a title's score sums, term by term in the query's order and then
  group by group, ``idf * ((tf * (k1 + 1)) / (tf + k1 * (1 - b + b *
  dl / avgdl)) + delta)`` in float32 (k1 1.2, b 0.75, delta 1; a fuzzy
  group counts tf 1 and takes its idf from the titles it holds).

The card scores a term that more than 2,048 titles hold over its
champions only: its 256 lowest title ids and, of the rest, the titles
where it weighs most (ties to the lower id). The host routes score every
posting. ``scores`` gives both sums for each title asked about.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from .stats import GRAM, PAD, Corpus, Posting, compute_idf, words

F = np.float32
K1, B, DELTA = F(1.2), F(0.75), F(1.0)
CAP, LOW = 2048, 256
STOP_LIMIT = 1_250_000
TIER_LANES = 32_768
ROUTES = ("card", "host")


def ld1(a: str, b: str) -> bool:
    """Within one edit: Levenshtein 1, or one adjacent transposition."""
    if a == b:
        return True
    la, lb = len(a), len(b)
    if abs(la - lb) > 1:
        return False
    i = 0
    while i < min(la, lb) and a[i] == b[i]:
        i += 1
    if la == lb:
        return a[i + 1:] == b[i + 1:] or (
            i + 1 < la and a[i] == b[i + 1] and a[i + 1] == b[i]
            and a[i + 2:] == b[i + 2:])
    return a[i + 1:] == b[i:] if la > lb else a[i:] == b[i + 1:]


class Term(NamedTuple):
    idf: F
    full: Posting
    champions: Posting


class Stage1Index:
    def __init__(self, corpus: Corpus):
        self.c = corpus
        dl = np.asarray([len(t) for t in corpus.texts], np.int64)
        self.dl = dl + corpus.long_words
        # the mean in float32, summed as NumPy sums a float32 array
        self.avgdl = float(self.dl.astype(F).mean()) if corpus.n else 0.0
        self._memo: Dict[str, Posting] = {}
        self._grams = None
        self._by_len: Dict[int, List[str]] = {}
        for w in corpus.word_ids:
            self._by_len.setdefault(len(w), []).append(w)

    def posting(self, term: str) -> Posting:
        """A term's titles and weights: a 3-letter term is a 3-gram (and
        a word of the same letters); a longer one a word."""
        p = self._memo.get(term)
        if p is None:
            parts = [self.c.gram_posting(term)] if len(term) == GRAM else []
            w = self.c.word_posting(term) if PAD not in term else None
            if w is not None:
                parts.append(w)
            if not parts:
                p = Posting(np.zeros(0, np.int64), np.zeros(0, np.int64))
            elif len(parts) == 1:
                p = parts[0]
            else:
                u, inv = np.unique(np.concatenate([x.docs for x in parts]),
                                   return_inverse=True)
                tf = np.bincount(inv, weights=np.concatenate(
                    [x.tf for x in parts]))
                p = Posting(u, tf.astype(np.int64))
            self._memo[term] = p
        return p

    @staticmethod
    def champions(p: Posting) -> Posting:
        if p.docs.size <= CAP:
            return p
        rest = LOW + np.argsort(-p.tf[LOW:], kind="stable")[:CAP - LOW]
        keep = np.sort(np.concatenate([np.arange(LOW), rest]))
        return Posting(p.docs[keep], p.tf[keep])

    def fuzzy(self, token: str) -> List[str]:
        """The terms within one edit of an unknown word."""
        out = [w for n in (len(token) - 1, len(token), len(token) + 1)
               if n >= GRAM for w in self._by_len.get(n, ())
               if ld1(token, w)]
        if len(token) == GRAM + 1:
            if self._grams is None:
                self._grams = self.c.grams()
            out += sorted({token[:i] + token[i + 1:]
                           for i in range(len(token))}
                          & self._grams - set(out))
        return out

    # -- a query -------------------------------------------------------------
    def query_terms(self, q: str):
        """(terms, fuzzy groups): ``Term``s in the query's order and, for
        each fuzzy group, its full and champion unions."""
        ws = words(q)
        long = [w for w in ws if len(w) >= GRAM]
        if long and len(long) < len(ws):
            q = " ".join(long)
        toks = [w for w in words(q) if len(w) >= GRAM]
        padded = PAD * 2 + q
        toks += [padded[i:i + GRAM] for i in range(len(padded) - GRAM + 1)]
        terms, groups, seen = [], [], set()
        for tok in toks:
            if tok in seen:
                continue
            seen.add(tok)
            p = self.posting(tok)
            df = p.docs.size
            if df == 0:
                if len(tok) >= GRAM + 1 and PAD not in tok:
                    match = self.fuzzy(tok)
                    if match:
                        groups.append(self._group(match))
                continue
            if df > STOP_LIMIT:
                continue
            terms.append(Term(compute_idf(self.c.n, df), p,
                              self.champions(p)))
        return terms, groups

    def _group(self, match: List[str]):
        """A fuzzy group's titles and idf on each route."""
        host = np.unique(np.concatenate([self.posting(t).docs
                                         for t in match]))
        card = np.unique(np.concatenate([self.champions(self.posting(t)).docs
                                         for t in match]))
        return {"host": (compute_idf(self.c.n, host.size), host),
                "card": (card_fuzzy_idf(self.c.n, card.size), card)}

    def factor(self, tf: np.ndarray, docs: np.ndarray) -> np.ndarray:
        """BM25+'s document factor of a term ``tf`` times in each title."""
        tf = tf.astype(F)
        return (tf * (K1 + F(1))) / (tf + self._norm(docs)) + DELTA

    def fuzzy_factor(self, docs: np.ndarray) -> np.ndarray:
        return (K1 + F(1)) / (F(1) + self._norm(docs)) + DELTA

    def _norm(self, docs: np.ndarray) -> np.ndarray:
        dl = self.dl[docs].astype(F)
        dl = np.where(dl <= 0, F(1), dl)
        return K1 * ((F(1) - B) + B * (dl / max(F(self.avgdl), F(1e-9))))

    def _sums(self, q: str, route: str, docs=None) -> np.ndarray:
        """float32 scores on ``route`` of ``docs``, or of every title."""
        terms, groups = self.query_terms(q)
        every = docs is None
        n = self.c.n if every else docs.size
        s = np.zeros(n, F)
        fz = np.zeros(n, F) if route == "card" else s
        for t in terms:
            p = t.champions if route == "card" else t.full
            if not p.docs.size:
                continue
            if every:
                s[p.docs] = s[p.docs] + t.idf * self.factor(p.tf, p.docs)
                continue
            i = np.minimum(np.searchsorted(p.docs, docs), p.docs.size - 1)
            hit = p.docs[i] == docs
            s[hit] = s[hit] + t.idf * self.factor(p.tf[i[hit]], docs[hit])
        for g in groups:
            idf, members = g[route]
            at = members if every else np.flatnonzero(np.isin(docs, members))
            d = at if every else docs[at]
            fz[at] = fz[at] + idf * self.fuzzy_factor(d)
        return s + fz if route == "card" else s

    def scores(self, q: str, docs) -> Dict[str, np.ndarray]:
        """Each route's float32 scores of ``docs``: ``card``, the batched
        device route (champions; the fuzzy groups summed apart, then
        added); ``host``, the host and tiered routes (every posting; the
        fuzzy groups added one by one)."""
        docs = np.asarray(docs, np.int64)
        return {r: self._sums(q, r, docs) for r in ROUTES}

    def best(self, q: str, route: str, k: int):
        """(the titles scoring at least the ``k``-th best score on
        ``route``, by score then id; how many score above 0)."""
        s = self._sums(q, route)
        live = np.flatnonzero(s > 0)
        if live.size > k:
            kth = np.partition(s[live], live.size - k)[live.size - k]
            top = live[s[live] >= kth]
        else:
            top = live
        order = np.lexsort((top, -s[top]))
        return [(int(top[i]), float(s[top[i]])) for i in order], live.size

    def tiered(self, q: str) -> bool:
        """Whether the query may take the tiered route (two or more
        terms, no fuzzy group, more than 32,768 postings), whose
        candidates are a pool of its own."""
        terms, groups = self.query_terms(q)
        return not groups and len(terms) >= 2 and \
            sum(t.full.docs.size for t in terms) > TIER_LANES


def is_top(got: List[Tuple[int, float]], best: List[Tuple[int, float]],
           n_live: int, k: int) -> bool:
    """Whether ``got`` (by score, then id) holds the ``k`` best titles:
    ``best`` (``Stage1Index.best``) in the same places above its lowest
    score, and at that score titles that score it, as many as fit (which
    titles of a tie the cut keeps is the route's own choice)."""
    if len(got) != min(k, n_live):
        return False
    if not got:
        return True
    low = got[-1][1]
    above = [e for e in got if e[1] > low]
    if above != best[:len(above)]:
        return False
    tie = {d for d, v in best if v == low}
    rest = got[len(above):]
    return all(v == low and d in tie for d, v in rest) and \
        [d for d, _ in rest] == sorted(d for d, _ in rest)


def card_fuzzy_idf(n_docs: int, df: int) -> F:
    """A fuzzy group's idf on the card: the ratio in float32, its log1p
    taken in float64 and rounded once."""
    if df <= 0 or df > STOP_LIMIT:
        return F(0)
    ratio = (F(n_docs) - F(df) + F(0.5)) / (F(df) + F(0.5))
    return F(np.log1p(np.float64(ratio))) if ratio > 0 else F(0)

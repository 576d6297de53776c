"""String metrics: Levenshtein, restricted Damerau rescue, prefix distance, LCS.

Behavioral reference: Infidex ``Metrics/LevenshteinDistance.cs`` and
``Metrics/StringMetrics.cs``. Two functions are behavioral contracts the
ranking depends on and are replicated exactly:

* ``calculate_damerau`` (LevenshteinDistance.cs:281-341) is NOT full
  Damerau-Levenshtein: it computes plain Levenshtein with budget max+1 and,
  if the result is exactly max+1, scans for the FIRST mismatch, checks
  whether an adjacent transposition fixes it, and if so returns
  1 + levenshtein(rest). Replicate bug-for-bug.
* ``lcs`` (StringMetrics.cs:12-36) is containment-or-common-prefix plus
  tolerance, not a real LCS.

Host implementations here are the scalar oracles; the batched device
versions live in ops/editdistance.py and are property-tested against these.
"""

from __future__ import annotations

from typing import Optional

try:  # C++ fast paths (native/_lib.cpp); bit-identical to the code below.
    from .. import native as _native
    if not _native.available:
        _native = None
except Exception:  # pragma: no cover - fallback when toolchain missing
    _native = None


def levenshtein(pattern: str, text: str, max_errors: int = 2**31 - 1,
                ignore_case: bool = False) -> int:
    """Plain Levenshtein with early exit (LevenshteinDistance.Calculate).

    Returns max_errors + 1 when the distance exceeds max_errors.
    """
    if not pattern:
        return len(text)
    if not text:
        return len(pattern)
    if ignore_case:
        pattern = pattern.lower()
        text = text.lower()
    if len(pattern) > len(text):
        pattern, text = text, pattern

    m = len(pattern)
    costs = list(range(m + 1))
    for j, t in enumerate(text):
        diagonal = costs[0]
        costs[0] = j + 1
        min_cost = costs[0]
        for i in range(m):
            left = costs[i + 1]
            up = costs[i]
            if t == pattern[i]:
                cost = diagonal
            else:
                cost = min(up + 1, left + 1, diagonal + 1)
            diagonal = left
            costs[i + 1] = cost
            if cost < min_cost:
                min_cost = cost
        if min_cost > max_errors:
            return max_errors + 1
    return costs[m]


def calculate_damerau(source: str, target: str, max_distance: int,
                      ignore_case: bool = False) -> int:
    """Levenshtein + single-transposition rescue (LevenshteinDistance.cs:281-341)."""
    if _native is not None:
        if ignore_case:
            source = source.lower()
            target = target.lower()
        return _native.damerau(source, target, max_distance)
    if abs(len(source) - len(target)) > max_distance:
        return max_distance + 1

    dist = levenshtein(source, target, max_distance + 1, ignore_case)
    if dist <= max_distance:
        return dist

    if dist <= max_distance + 1:
        s = source.lower() if ignore_case else source
        t = target.lower() if ignore_case else target
        for i in range(len(s) - 1):
            if i >= len(t):
                break
            if s[i] != t[i]:
                if i + 1 >= len(t):
                    break
                if s[i] == t[i + 1] and s[i + 1] == t[i]:
                    remaining = max_distance - 1
                    if remaining < 0:
                        return max_distance + 1
                    s_rest = s[i + 2 :]
                    t_rest = t[i + 2 :]
                    rest = levenshtein(s_rest, t_rest, remaining, False)
                    if rest <= remaining:
                        return 1 + rest
                break  # only the first mismatch is examined
    return dist


def get_dynamic_threshold(query_length: int) -> int:
    """delta(len) = 1/2/3 (LevenshteinDistance.cs:31-37)."""
    if query_length <= 5:
        return 1
    if query_length <= 10:
        return 2
    return 3


def calculate_prefix_distance(prefix: str, word: str,
                              max_errors: Optional[int] = None,
                              ignore_case: bool = True) -> int:
    """PLD(p, w) = min WLD between p and any prefix of w (Bast & Celikik).

    Banded DP, O(delta * |w|) (LevenshteinDistance.cs:55-175).
    """
    if not prefix:
        return 0
    if not word:
        return len(prefix)
    if ignore_case:
        prefix = prefix.lower()
        word = word.lower()
    m, n = len(prefix), len(word)
    if max_errors is None:
        max_errors = get_dynamic_threshold(m)
    if _native is not None:
        return _native.prefix_distance(prefix, word, max_errors)
    if m - n > max_errors:
        return max_errors + 1

    # Full DP restricted to the band; simple + exact for host oracle use.
    best = m
    prev = list(range(m + 1))
    for j in range(1, n + 1):
        cur = [j] + [0] * m
        for i in range(1, m + 1):
            c = 0 if prefix[i - 1] == word[j - 1] else 1
            cur[i] = min(prev[i - 1] + c, prev[i] + 1, cur[i - 1] + 1)
        if cur[m] < best:
            best = cur[m]
        prev = cur
    return min(best, max_errors + 1)


def lcs(q: str, r: str, error_tolerance: int) -> int:
    """Containment-or-common-prefix + tolerance (StringMetrics.cs:12-36)."""
    if _native is not None:
        return _native.lcs(q, r, error_tolerance)
    if not q or not r:
        return 0
    if q == r:
        return len(q)
    if q in r:
        return len(q)
    prefix_len = 0
    for a, b in zip(q, r):
        if a != b:
            break
        prefix_len += 1
    if prefix_len == 0:
        return 0
    return min(prefix_len + error_tolerance, min(len(q), len(r)))


def longest_common_subsequence(s1: str, s2: str) -> int:
    """True LCS DP (StringMetrics.cs:41-69)."""
    if not s1 or not s2:
        return 0
    n = len(s2)
    prev = [0] * (n + 1)
    for a in s1:
        cur = [0] * (n + 1)
        for j in range(1, n + 1):
            if a == s2[j - 1]:
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = max(prev[j], cur[j - 1])
        prev = cur
    return prev[n]


def jaro_similarity(s1: str, s2: str) -> float:
    """Jaro similarity (StringMetrics.cs:74-135)."""
    if not s1 and not s2:
        return 1.0
    if not s1 or not s2:
        return 0.0
    len1, len2 = len(s1), len(s2)
    window = max(max(len1, len2) // 2 - 1, 1)
    m1 = [False] * len1
    m2 = [False] * len2
    matches = 0
    for i in range(len1):
        start = max(0, i - window)
        end = min(i + window + 1, len2)
        for j in range(start, end):
            if m2[j] or s1[i] != s2[j]:
                continue
            m1[i] = m2[j] = True
            matches += 1
            break
    if matches == 0:
        return 0.0
    transpositions = 0
    k = 0
    for i in range(len1):
        if not m1[i]:
            continue
        while not m2[k]:
            k += 1
        if s1[i] != s2[k]:
            transpositions += 1
        k += 1
    return (
        matches / len1 + matches / len2 + (matches - transpositions / 2.0) / matches
    ) / 3.0


def jaro_winkler_similarity(s1: str, s2: str, prefix_scale: float = 0.1) -> float:
    jaro = jaro_similarity(s1, s2)
    prefix_len = 0
    for a, b in zip(s1[:4], s2[:4]):
        if a != b:
            break
        prefix_len += 1
    return jaro + prefix_len * prefix_scale * (1.0 - jaro)


def binomial_edit_threshold(length: int, p: float = 0.04, alpha: float = 0.01,
                            max_d: int = 8) -> int:
    """Smallest d with Pr[Binom(L, p) <= d] >= 1 - alpha
    (Metrics/EditDistanceModel.cs:48-88)."""
    if length <= 0:
        return 0
    from math import comb

    target = 1.0 - alpha
    cum = 0.0
    for d in range(max_d + 1):
        cum += comb(length, d) * (p ** d) * ((1 - p) ** (length - d))
        if cum >= target:
            return d
    return max_d

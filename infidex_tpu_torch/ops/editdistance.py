"""Batched edit distance of ONE query token: Levenshtein + the Damerau
rescue (plain PyTorch).

Port of ``infidex_tpu/ops/editdistance.py``. Behavioral reference:
Infidex ``Metrics/LevenshteinDistance.cs``. For one query token against a
[C, D] tensor of candidate doc tokens, each function computes what the
scalar oracle computes pairwise:

* ``batched_levenshtein``: the plain DP clamped at budget + 1 (callers only
  compare <= budget, so clamping preserves behavior).
* ``batched_damerau``: Levenshtein with budget max + 1, then, where the
  result is exactly max + 1, the first-mismatch adjacent-transposition
  rescue worth 1 + lev(rest) (LevenshteinDistance.cs:281-341, replicated
  quirk for quirk: only the FIRST mismatch is examined, and the swap
  partner bounds-checks against the target).

Char tensors are int32 code units, zero-padded; lengths are explicit.
Inputs may be numpy arrays or tensors; the results are int32 tensors on
the device of ``d_chars`` and equal the reference's integers, including
its gathers' edges: an index past the end of a row reads the int32
minimum, as ``jnp.take_along_axis`` fills it.

No serving route reaches this module: the engine's distances run in the
multi-query form (``ops/editdistance_multi.py`` on the CPU, the pair
kernel ``csrc/coverage_pairs.cu`` on a card).
"""

from __future__ import annotations

import torch

from .editdistance_multi import _as, _cummin_plus_axis0, first_true

_I32 = torch.int32
_FILL = torch.iinfo(torch.int32).min


def _take_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take_along_axis(x, idx, axis=-1)`` in its default mode: a
    negative index counts from the end, an index outside the row reads
    the int32 minimum."""
    n = x.shape[-1]
    idx = torch.where(idx < 0, idx + n, idx)
    inside = (idx >= 0) & (idx < n)
    got = torch.gather(x, -1, torch.clamp(idx, 0, n - 1).long())
    return torch.where(inside, got, _FILL)


def _propagate_insertions(row: torch.Tensor) -> torch.Tensor:
    """row[i] = min_{j<=i}(row[j] + i - j) along the last axis: the DP
    row's left-to-right insertion propagation (the reference's
    i + cummin(row - i))."""
    return _cummin_plus_axis0(row.movedim(-1, 0)).movedim(0, -1)


def _sweep(row: torch.Tensor, q_chars: torch.Tensor, d_chars: torch.Tensor,
           d_lens: torch.Tensor, steps: int) -> torch.Tensor:
    """The Levenshtein DP over the first ``steps`` doc chars: ``row``
    [C, D, Lq + 1], ``q_chars`` [Lq] or [C, D, Lq], ``d_chars`` [C, D, L];
    a pair's row stops changing past its doc length."""
    C, D, _ = row.shape
    for k in range(steps):
        d_char = d_chars[:, :, k]
        sub = (q_chars != d_char[..., None]).to(_I32)
        diag = row[..., :-1] + sub
        up = row[..., 1:] + 1
        first = torch.full((C, D, 1), k + 1, dtype=_I32, device=row.device)
        new_row = _propagate_insertions(
            torch.cat([first, torch.minimum(diag, up)], dim=-1))
        row = torch.where((k < d_lens)[..., None], new_row, row)
    return row


def batched_levenshtein(q_chars, q_len, d_chars, d_lens, *, budget: int,
                        l_max: int) -> torch.Tensor:
    """min(lev(q, d), budget + 1) for every (c, d) pair, int32 [C, D].
    ``q_chars`` int32 [Lq], ``q_len`` a scalar, ``d_chars`` int32
    [C, D, L], ``d_lens`` int32 [C, D]."""
    d_chars = torch.as_tensor(d_chars).to(_I32)
    q_chars, q_len, d_lens = (_as(x, d_chars, _I32)
                              for x in (q_chars, q_len, d_lens))
    C, D, L = d_chars.shape
    lq = q_chars.shape[0]
    dev = d_chars.device
    row = torch.arange(lq + 1, dtype=_I32, device=dev).expand(C, D, lq + 1)
    row = _sweep(row, q_chars, d_chars, d_lens, min(L, l_max))
    q_len_cd = q_len.expand(C, D)
    dist = _take_last(row, q_len_cd[..., None])[..., 0]
    # empty-side semantics: lev("", d) = len(d); lev(q, "") = len(q)
    dist = torch.where(q_len == 0, d_lens, dist)
    dist = torch.where(d_lens == 0, q_len_cd, dist)
    return torch.clamp_max(dist, budget + 1)


def batched_damerau(q_chars, q_len, d_chars, d_lens, *, max_distance: int,
                    l_max: int) -> torch.Tensor:
    """The reference's CalculateDamerau, batched, int32 [C, D]. Results
    above ``max_distance`` mean "no match" (callers compare <=)."""
    d_chars = torch.as_tensor(d_chars).to(_I32)
    q_chars, q_len, d_lens = (_as(x, d_chars, _I32)
                              for x in (q_chars, q_len, d_lens))
    C, D, L = d_chars.shape
    lq = q_chars.shape[0]
    dev = d_chars.device
    no = max_distance + 1

    len_diff_ok = (d_lens - q_len).abs() <= max_distance
    dist = batched_levenshtein(q_chars, q_len, d_chars, d_lens,
                               budget=max_distance + 1, l_max=l_max)

    # Transposition rescue where dist == max_distance + 1
    # (LevenshteinDistance.cs:295-338). First mismatch p: the smallest k
    # with q[k] != d[k], k < len(q) - 1 (the loop bound) and k < len(d).
    k_idx = torch.arange(lq, dtype=_I32, device=dev)
    if L >= lq:
        d_b = d_chars[..., :lq]
    else:
        d_b = torch.cat([d_chars, torch.zeros((C, D, lq - L), dtype=_I32,
                                              device=dev)], dim=-1)
    in_scan = (k_idx < q_len - 1) & (k_idx < d_lens[..., None])
    mismatch = (q_chars != d_b) & in_scan
    has_mismatch = mismatch.any(dim=-1)
    p = first_true(mismatch, -1)

    # the swap: p + 1 < len(d), q[p] == d[p + 1] and q[p + 1] == d[p]
    p1_ok = (p + 1) < d_lens
    q_p = q_chars[torch.clamp_max(p, lq - 1).long()]
    q_p1 = q_chars[torch.clamp_max(p + 1, lq - 1).long()]
    d_p = _take_last(d_chars, p[..., None])[..., 0]
    d_p1 = _take_last(d_chars, torch.clamp_max(p + 1, L - 1)[..., None])[..., 0]
    swap_fixes = p1_ok & (q_p == d_p1) & (q_p1 == d_p)

    remaining = max_distance - 1
    if remaining >= 0:
        # lev(q[p+2:], d[p+2:]) with budget `remaining`
        shift = p + 2
        idx = shift[..., None] + k_idx                   # [C, D, Lq]
        q_rest = torch.where(idx < q_len,
                             q_chars[torch.clamp_max(idx, lq - 1).long()], 0)
        q_rest_len = torch.clamp_min(q_len - shift, 0)
        d_rest = _take_last(d_chars, torch.clamp_max(idx, L - 1))
        d_rest = torch.where(idx < d_lens[..., None], d_rest, 0)
        d_rest_len = torch.clamp_min(d_lens - shift, 0)
        rest_dist = _batched_lev_pairwise(
            q_rest, q_rest_len, d_rest, d_rest_len,
            budget=remaining if remaining > 0 else 0, l_max=lq)
        rescue_ok = swap_fixes & (rest_dist <= remaining)
        rescued = 1 + rest_dist
    else:
        rescue_ok = torch.zeros((C, D), dtype=torch.bool, device=dev)
        rescued = torch.full((C, D), no, dtype=_I32, device=dev)

    use_rescue = ((dist > max_distance) & (dist <= max_distance + 1)
                  & has_mismatch & rescue_ok)
    result = torch.where(use_rescue, rescued, dist)
    return torch.where(len_diff_ok, result, no).to(_I32)


def _batched_lev_pairwise(q_chars, q_lens, d_chars, d_lens, *, budget: int,
                          l_max: int) -> torch.Tensor:
    """Levenshtein where BOTH sides vary per (c, d) pair: ``q_chars``
    [C, D, Lq], ``q_lens`` [C, D], ``d_chars`` [C, D, L], ``d_lens``
    [C, D]; min(dist, budget + 1). Used by the Damerau rescue on per-pair
    suffixes."""
    d_chars = torch.as_tensor(d_chars).to(_I32)
    q_chars, q_lens, d_lens = (_as(x, d_chars, _I32)
                               for x in (q_chars, q_lens, d_lens))
    dev = d_chars.device
    C, D, LQ = q_chars.shape
    L = d_chars.shape[-1]
    row = torch.arange(LQ + 1, dtype=_I32, device=dev).expand(C, D, LQ + 1)
    row = _sweep(row, q_chars, d_chars, d_lens, min(L, l_max))
    dist = _take_last(row, q_lens[..., None])[..., 0]
    dist = torch.where(q_lens == 0, d_lens, dist)
    dist = torch.where(d_lens == 0, q_lens, dist)
    return torch.clamp_max(dist, budget + 1)

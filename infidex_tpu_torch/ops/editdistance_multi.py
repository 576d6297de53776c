"""Multi-query banded edit distance (plain PyTorch).

Port of ``infidex_tpu/ops/editdistance_multi.py``: all query tokens vs all
doc tokens in ONE banded DP sweep. The candidate axis C is minor
everywhere — [W, Q, D, C] DP state, [Q, L, C] query chars, [L, D, C] doc
chars — and every function keeps the reference's layout and integer
semantics, so results are identical on any device.

* ``batched_lev_multi``: banded Levenshtein, band half-width = budget.
  Exact min(dist, budget+1).
* ``alignment_tensors``: aligned / one-shifted / reversed char equality
  [Q, L, D, C].
* ``damerau_rescue``: the reference CalculateDamerau transposition rescue
  (Metrics/LevenshteinDistance.cs:281-341) applied to clamped lev values.
* ``batched_damerau_multi``: convenience wrapper (lev sweep + rescue).
* ``coverage_distances_plain``: the five Damerau distance tensors the
  coverage program needs (two sweeps, five rescues), composed of the
  functions above. It is the distance part of ``ops/coverage_kernel.py
  coverage_pairs_plain``, which runs for CPU tensors; on the card the
  hand-written kernel ``csrc/coverage_pairs.cu`` writes the distances into
  the pair word, and ``unpack_distances`` reads them out of it.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _kernels


def _as(x, like: torch.Tensor, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=like.device)


def first_true(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along ``dim`` (0 when none), int32 — what
    ``argmax`` of a boolean mask returns, as a masked min over the index
    (one reduction, much cheaper than argmax on the CPU)."""
    n = mask.shape[dim]
    shape = [1] * mask.dim()
    shape[dim] = n
    iota = torch.arange(n, dtype=torch.int32, device=mask.device).view(shape)
    first = torch.where(mask, iota, n).amin(dim)
    return torch.where(first == n, 0, first)


def _cummin_plus_axis0(row: torch.Tensor) -> torch.Tensor:
    """row[o] = min_{o'<=o}(row[o'] + (o - o')) along axis 0 (band axis),
    as the recurrence out[o] = min(row[o], out[o-1] + 1) over the short
    band (W <= 7 steps; ``torch.cummin`` is far slower on the CPU)."""
    out = row.clone()
    for o in range(1, row.shape[0]):
        torch.minimum(out[o], out[o - 1] + 1, out=out[o])
    return out


def batched_lev_multi(q_chars, q_lens, d_chars, d_lens, *, budget: int,
                      l_max: int) -> torch.Tensor:
    """min(lev(q_i, d_cd), budget+1) for every (i, d, c). Shape [Q, D, C].

    q_chars int32 [Q, L] or [Q, L, C]; q_lens [Q] or [Q, C]; d_chars int32
    [L, D, C]; d_lens [D, C] or [Q, D, C]. Query tensors may carry the
    per-candidate trailing axis (each candidate belongs to its own query).
    """
    d_chars = torch.as_tensor(d_chars)
    q_chars = _as(q_chars, d_chars)
    q_lens = _as(q_lens, d_chars)
    d_lens = _as(d_lens, d_chars)
    i32 = torch.int32
    dev = d_chars.device
    L, D, C = d_chars.shape
    q3 = q_chars if q_chars.dim() == 3 else q_chars[..., None]   # [Q,L,1|C]
    ql2 = q_lens if q_lens.dim() == 2 else q_lens[:, None]       # [Q,1|C]
    Q = q3.shape[0]
    Lq = q3.shape[1]
    W = 2 * budget + 1
    big = budget + 1
    d_len3 = d_lens[None] if d_lens.dim() == 2 else d_lens       # [1|Q,D,C]

    off = torch.arange(W, dtype=i32, device=dev) - budget         # i - j
    init = torch.where(off >= 0, off, budget + 2)
    row = init[:, None, None, None].expand(W, Q, D, C).clamp_max(big + 1)
    row = row.contiguous()
    pad_row = torch.full((1, Q, D, C), big + 1, dtype=i32, device=dev)
    for j in range(min(L, l_max)):
        d_char = d_chars[j]                                  # [D, C]
        qi_clip = torch.clamp(j + off, 0, Lq - 1).long()     # [W]
        q_at_w = q3[:, qi_clip].permute(1, 0, 2)[:, :, None, :]  # [W,Q,1,C]
        sub = (q_at_w != d_char[None, None]).to(i32)
        diag = row + sub
        up = torch.cat([row[1:], pad_row], dim=0) + 1
        base = torch.minimum(diag, up)
        i_here = (j + 1) + off                               # [W]
        zero_mask = (i_here == 0)[:, None, None, None]
        base = torch.where(zero_mask, torch.clamp_max(base, j + 1), base)
        new_row = _cummin_plus_axis0(base)
        ih = i_here[:, None, None]                           # [W,1,1]
        iv = (ih >= 0) & (ih <= ql2[None])                   # [W,Q,1|C]
        iv = iv[:, :, None]
        new_row = torch.where(iv, new_row, big + 1)
        new_row = torch.clamp_max(new_row, big + 1)
        d_valid = (j < d_len3)[None]                         # [1,1|Q,D,C]
        row = torch.where(d_valid, new_row, row)

    o_iota = torch.arange(W, dtype=i32, device=dev)
    o_final = (ql2[:, None, :] - d_len3 + budget).expand(Q, D, C)
    sel = o_iota[:, None, None, None] == o_final[None]
    dist = torch.where(sel, row, big).amin(dim=0)
    q_len_b = ql2[:, None, :].expand(Q, D, C)
    d_len_b = d_len3.expand(Q, D, C)
    dist = torch.where(q_len_b == 0, d_len_b, dist)
    dist = torch.where(d_len_b == 0, q_len_b, dist)
    return torch.clamp_max(dist, big).to(i32)


def alignment_tensors(q_chars, d_chars, q_chars_rev=None, d_chars_rev=None):
    """(eq, eq_qd1, eq_q1d, rev_eq) in [Q, L, D, C] layout.

    eq[l]     = q[l] == d[l]
    eq_qd1[l] = q[l] == d[l+1]   (d shifted left by one)
    eq_q1d[l] = q[l+1] == d[l]   (q shifted left by one)
    rev_eq[l] = q_rev[l] == d_rev[l]  (None when rev inputs absent)

    q_chars: [Q, L] or [Q, L, C]; d_chars: [L, D, C].
    """
    d_chars = torch.as_tensor(d_chars)
    q_chars = _as(q_chars, d_chars)
    L, D, C = d_chars.shape
    d_t = d_chars[None]                                          # [1,L,D,C]
    q3 = q_chars if q_chars.dim() == 3 else q_chars[..., None]    # [Q,L,1|C]
    q_t = q3[:, :, None, :]                                      # [Q,L,1,1|C]
    eq = q_t == d_t

    zpad_d = torch.zeros((1, 1, D, C), dtype=d_chars.dtype,
                         device=d_chars.device)
    d_shift = torch.cat([d_t[:, 1:], zpad_d], dim=1)
    eq_qd1 = q_t == d_shift

    zpad_q = torch.zeros(q_t.shape[:1] + (1,) + q_t.shape[2:],
                         dtype=q3.dtype, device=q3.device)
    q_shift = torch.cat([q_t[:, 1:], zpad_q], dim=1)
    eq_q1d = q_shift == d_t

    rev_eq = None
    if q_chars_rev is not None and d_chars_rev is not None:
        d_chars_rev = _as(d_chars_rev, d_chars)
        q_chars_rev = _as(q_chars_rev, d_chars)
        qr3 = (q_chars_rev if q_chars_rev.dim() == 3
               else q_chars_rev[..., None])
        rev_eq = qr3[:, :, None, :] == d_chars_rev[None]
    return eq, eq_qd1, eq_q1d, rev_eq


def damerau_rescue(dist, eq, eq_qd1, eq_q1d, q_lens, d_lens,
                   *, max_distance: int, rev_eq=None):
    """Reference transposition rescue on clamped lev distances.

    dist [Q,D,C] = min(lev, max_distance+2); eq/eq_qd1/eq_q1d [Q,L,D,C];
    d_lens [D,C] or [Q,D,C]. Returns CalculateDamerau-equivalent distances
    (clamped above max_distance).
    """
    q_lens = _as(q_lens, dist)
    d_lens = _as(d_lens, dist)
    i32 = torch.int32
    L = eq.shape[1]
    no = max_distance + 1
    ql2 = q_lens if q_lens.dim() == 2 else q_lens[:, None]       # [Q,1|C]
    q_len_b = ql2[:, None, :]                                    # [Q,1,1|C]
    d_len3 = d_lens[None] if d_lens.dim() == 2 else d_lens       # [1|Q,D,C]
    len_diff_ok = (d_len3 - q_len_b).abs() <= max_distance

    l_iota = torch.arange(L, dtype=i32, device=dist.device)[None, :, None, None]
    ql4 = ql2[:, None, None, :]                                  # [Q,1,1,1|C]
    dl4 = d_lens[None, None] if d_lens.dim() == 2 else d_lens[:, None]

    in_scan = (l_iota < (ql4 - 1)) & (l_iota < dl4)
    mism = (~eq) & in_scan
    has_mism = mism.any(dim=1)                                   # [Q,D,C]
    p = first_true(mism, 1)                                     # [Q,D,C]
    p4 = p[:, None]                                              # [Q,1,D,C]
    sel_p = l_iota == p4

    # Swap: p+1 < d_len, q[p]==d[p+1], q[p+1]==d[p]
    swap_at_p = (eq_qd1 & eq_q1d & sel_p).any(dim=1)
    p1_ok = (p + 1) < d_len3
    swap_fixes = p1_ok & swap_at_p

    remaining = max_distance - 1
    if remaining < 0:
        return torch.where(len_diff_ok, dist, no)

    rest_q_len = torch.clamp_min(q_len_b - (p + 2), 0)
    rest_d_len = torch.clamp_min(d_len3 - (p + 2), 0)
    rest_short = torch.minimum(rest_q_len, rest_d_len)
    rest_diff = (rest_q_len - rest_d_len).abs()

    after = l_iota >= (p4 + 2)
    within = l_iota < (p4 + 2 + rest_short[:, None])
    window_mism = (~eq) & after & within
    any_wm = window_mism.any(dim=1)
    first_wm = first_true(window_mism, 1)
    aligned_prefix = torch.where(any_wm, first_wm - (p + 2), rest_short)

    rest_equal = (rest_diff == 0) & (aligned_prefix >= rest_short)

    if remaining == 0:
        rest_dist = torch.where(rest_equal, 0, 1)
        rescue_ok = swap_fixes & rest_equal
    else:
        if rev_eq is None:
            raise ValueError(
                "damerau_rescue with max_distance >= 2 requires rev_eq "
                "(and unclamped d_lens)")
        shorter4 = torch.minimum(ql4, dl4)
        rev_mism = (~rev_eq) & (l_iota < shorter4)
        any_rm = rev_mism.any(dim=1)
        suffix_run = torch.where(
            any_rm, first_true(rev_mism, 1),
            torch.minimum(q_len_b, d_len3).expand(any_rm.shape))
        suffix_run = torch.minimum(suffix_run, rest_short)
        rest_lev1 = torch.where(
            rest_diff == 0,
            aligned_prefix + suffix_run >= rest_short - 1,
            (rest_diff == 1) & (aligned_prefix + suffix_run >= rest_short))
        rest_dist = torch.where(rest_equal, 0,
                                torch.where(rest_lev1, 1, remaining + 1))
        rescue_ok = swap_fixes & (rest_dist <= remaining)

    rescued = 1 + rest_dist
    use_rescue = (dist > max_distance) & (dist <= max_distance + 1) & \
        has_mism & rescue_ok
    result = torch.where(use_rescue, rescued, dist)
    return torch.where(len_diff_ok, result, no).to(i32)


def batched_damerau_multi(q_chars, q_lens, d_chars, d_lens,
                          q_chars_rev: Optional[torch.Tensor] = None,
                          d_chars_rev: Optional[torch.Tensor] = None,
                          *, max_distance: int, l_max: int) -> torch.Tensor:
    """Convenience wrapper: lev sweep + rescue (see damerau_rescue)."""
    dist = batched_lev_multi(q_chars, q_lens, d_chars, d_lens,
                             budget=max_distance + 1, l_max=l_max)
    eq, eq_qd1, eq_q1d, rev_eq = alignment_tensors(
        q_chars, d_chars, q_chars_rev, d_chars_rev)
    return damerau_rescue(dist, eq, eq_qd1, eq_q1d, q_lens, d_lens,
                          max_distance=max_distance, rev_eq=rev_eq)


def coverage_distances_plain(qc3, qr3, qlens2, chars_t, chars_rev_t, lens):
    """``(dam1, dam2, pdam1, pdam2, pdam3)``, each int32 [Q, D, C]: every
    query token against every doc token of each candidate, in plain
    PyTorch (the pair kernel's distance fields hold the same values).

    ``qc3``/``qr3`` int32 [Q, L, C] query chars and their reverse,
    ``qlens2`` int32 [Q, C]; ``chars_t``/``chars_rev_t`` int32 [L, D, C]
    doc chars (zero where the token is invalid), ``lens`` int32 [D, C].
    ``dam1``/``dam2``: the Damerau distance clamped above 1 / 2;
    ``pdam1..3``: the same at max distance 1 against the doc token's
    prefix of ``q_len``, ``q_len + 1`` and ``q_len - 1`` chars."""
    L, D, _ = chars_t.shape
    # Sweep A (budget 3) gives exact min(lev, 4), shared by the md=1 and
    # md=2 Damerau values; sweep B stacks the three prefix-window variants
    # along the D axis.
    eq_al, eq_qd1, eq_q1d, rev_eq = alignment_tensors(
        qc3, chars_t, qr3, chars_rev_t)
    lev3 = batched_lev_multi(qc3, qlens2, chars_t, lens, budget=3, l_max=L)
    dam1 = damerau_rescue(torch.clamp_max(lev3, 3), eq_al, eq_qd1, eq_q1d,
                          qlens2, lens, max_distance=1)
    dam2 = damerau_rescue(lev3, eq_al, eq_qd1, eq_q1d, qlens2, lens,
                          max_distance=2, rev_eq=rev_eq)
    ql_b = qlens2[:, None, :]                                   # [Q,1,C]
    dl1 = torch.minimum(lens[None], ql_b)                       # [Q,D,C]
    dl2 = torch.minimum(lens[None], ql_b + 1)
    dl3 = torch.minimum(lens[None], torch.clamp_min(ql_b - 1, 0))
    chars3 = torch.cat([chars_t, chars_t, chars_t], dim=1)      # [L,3D,C]
    dl_stack = torch.cat([dl1, dl2, dl3], dim=1)                # [Q,3D,C]
    lev_p = batched_lev_multi(qc3, qlens2, chars3, dl_stack,
                              budget=2, l_max=L)
    del chars3, dl_stack
    pdam1 = damerau_rescue(lev_p[:, :D], eq_al, eq_qd1, eq_q1d,
                           qlens2, dl1, max_distance=1)
    pdam2 = damerau_rescue(lev_p[:, D:2 * D], eq_al, eq_qd1, eq_q1d,
                           qlens2, dl2, max_distance=1)
    pdam3 = damerau_rescue(lev_p[:, 2 * D:], eq_al, eq_qd1, eq_q1d,
                           qlens2, dl3, max_distance=1)
    return dam1, dam2, pdam1, pdam2, pdam3


def unpack_distances(pairs: torch.Tensor):
    """``(dam1, dam2, pdam1, pdam2, pdam3)`` int32 out of pair words
    (``_kernels.PAIR_DIST_SHIFTS``: three bits each)."""
    return tuple((pairs >> shift) & 7 for shift in _kernels.PAIR_DIST_SHIFTS)

"""The Stage-1 epilogue kernels on synthetic rows, on a card.

    python3 scripts/epilogue_probe.py

A quick check of a kernel design before a full ``chip_smoke.py`` run:
builds the kernels and times (torch.profiler, five calls) the top-k at k
500 and 20,000 on 128 rows of 2^20 scores with 15,000 positives each
(beside ``torch.topk`` over the int64 keys), on all-zero rows, the pass
without fuzzy groups, and the LIM rows with a dense class, with a sparse
one (100 members a row) and with a sparse one and 64 fuzzy groups; each
result is compared with its plain version. Prints the card's name and
power limit first.
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from infidex_tpu_torch.index import device as D
    from infidex_tpu_torch.ops import _kernels

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    _kernels.build()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    n_q, n = 128, 1 << 20
    s = torch.zeros(n_q, n, device=dev)
    idx = torch.randint(0, n, (n_q, 15000), device=dev, generator=g)
    s.scatter_(1, idx, torch.rand(n_q, 15000, device=dev, generator=g) * 10)
    c = (s > 0).float() * 2
    live = torch.ones(n, device=dev)

    def dev_ms(fn, name, reps=5, one=True):
        """(device ms a call, records kept) of the kernels named ``name``:
        with ``one`` (a kernel a call) the mean of the records the
        profiler kept (it drops one now and then), else their sum over
        the calls."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and name in e.name]
        total = sum(e.time_range.elapsed_us() for e in ev) / 1e3
        return (total / len(ev) if one else total / reps), len(ev)

    keys = D.order_keys(s, torch.arange(n, device=dev)[None, :])
    for k in (500, 20000):
        same = torch.equal(_kernels.stage1_topk(s, k)[1],
                           D.stable_top_k_plain(s, k)[1])
        print(f"top-k k {k}: equal {same}; kernel "
              f"{dev_ms(lambda: _kernels.stage1_topk(s, k), 'stage1_topk')}"
              f"; torch.topk over the keys "
              f"{dev_ms(lambda: torch.topk(keys, k, dim=1), '', one=False)}")
    del keys
    zeros = torch.zeros_like(s)
    print(f"top-k k 500, zero rows: "
          f"{dev_ms(lambda: _kernels.stage1_topk(zeros, 500), 'stage1_topk')}")
    del zeros
    ss, cc = s.clone(), c.clone()
    print(f"pass, no fuzzy groups: "
          f"{dev_ms(lambda: _kernels.stage1_epilogue(ss, cc, live, None, None, None, None, None), 'stage1_epilogue')}")
    del ss, cc

    def lim(cnt, thresh, fz_any=None, tables=(None,) * 4):
        args = (cnt, live, thresh, *tables[:2], *tables[2:], 500, 256, n, 0,
                1 << 24)
        same = torch.equal(_kernels.stage1_lim(*args), D.lim_rows_plain(
            cnt, live, thresh, fz_any, 500, 256, n, 0, 1 << 24))
        return same, dev_ms(lambda: _kernels.stage1_lim(*args), "stage1_lim")

    print(f"LIM, dense class: {lim(c, (c * live).max(dim=1).values)}")
    sparse = c.clone()
    sel = torch.randint(0, n, (n_q, 100), device=dev, generator=g)
    sparse.scatter_(1, sel, torch.full((n_q, 100), 3.0, device=dev))
    top = (sparse * live).max(dim=1).values
    print(f"LIM, sparse class: {lim(sparse, top)}")
    # 64 fuzzy groups of ~2,000 docs, two a query for the first 32 queries
    n_grp, words = 64, n // 32
    dense = torch.zeros(n_grp, n, device=dev)
    dense.scatter_(1, torch.randint(0, n, (n_grp, 2000), device=dev,
                                    generator=g), 1.0)
    w = (dense.view(n_grp, words, 32).long()
         << torch.arange(32, device=dev)).sum(dim=2)
    bits = torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)
    fidf = torch.rand(n_grp, device=dev, generator=g) + 0.1
    gq = torch.arange(n_grp, device=dev) // 2
    q_off = torch.zeros(n_q + 1, dtype=torch.int32, device=dev)
    q_off[1:] = torch.bincount(gq, minlength=n_q).cumsum(0).int()
    q_grp = torch.arange(n_grp, dtype=torch.int32, device=dev)
    fz_any = torch.zeros(n_q, n, dtype=torch.bool, device=dev)
    fz_any.index_put_((gq,), dense > 0, accumulate=True)
    print(f"LIM, sparse class, fuzzy groups: "
          f"{lim(sparse, top, fz_any, (bits.contiguous(), fidf, q_off, q_grp))}")


if __name__ == "__main__":
    main()

"""Share of its bound that the Stage-1 pass kernel reaches
(``csrc/stage1_epilogue.cu``, profiler name ``stage1_epilogue_kernel``):
the bytes each call needs, counted from its shapes as ``chip_smoke.py``
counts them (scores and counts read, scores written, and with fuzzy
groups counts written; the live mask read, the row maxima written; with
fuzzy groups the doc factors, the presence bitset, the groups' idf and
the group tables read), over the kernel's profiler time, against the
H100's 3.35 TB/s. Where the profiler kept fewer records than calls, the
bytes are the mean call's times the records kept."""

from benchmark.devtrace import HBM_BYTES_S

KERNEL = "stage1_epilogue_kernel"


def _bytes(rec, scores, cnt, live, bits, fidf, doc_fac, q_off, q_grp,
           **_):
    n_q, n_pad = scores.shape
    n_grp = bits.shape[0] if bits is not None else 0
    nbytes = n_q * n_pad * (16 if n_grp else 12) + 4 * n_pad + 4 * n_q
    if n_grp:
        nbytes += 4 * n_pad + 4 * bits.numel() + 4 * n_grp \
            + 4 * (n_q + 1 + n_grp)
    rec.calls[KERNEL].append(nbytes)


def install(ctx, rec):
    from infidex_tpu_torch.ops import _kernels

    rec.wrap(_kernels, "stage1_epilogue", "stage1_epilogue", _bytes)


def read(rec):
    calls = rec.calls.get(KERNEL, [])
    s, n = rec.kernel_s(lambda name: name.startswith(KERNEL))
    if not calls or not n or s <= 0:
        return None
    nbytes = sum(calls) * min(1.0, n / len(calls))
    return 100.0 * nbytes / HBM_BYTES_S / s

"""Device milliseconds a batch of the coverage + fusion kernels, from the
profiler: every kernel whose name starts with ``coverage_``
(``coverage_gather_kernel``, ``coverage_pairs_kernel``,
``coverage_cascade_kernel``, ``coverage_lcs_kernel``,
``coverage_fusion_kernel``)."""


def read(rec):
    s, n = rec.kernel_s(lambda name: name.startswith("coverage_"))
    if not n or not rec.batches:
        return None
    return s * 1e3 / rec.batches

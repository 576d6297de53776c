"""Device milliseconds a batch of the Stage-1 kernels, from the profiler:
every kernel whose name starts with ``stage1_`` (``stage1_scatter_lanes_
kernel``, ``stage1_fuzzy_mark_kernel``, ``stage1_epilogue_kernel``,
``stage1_topk_kernel``, ``stage1_lim_kernel``, ``stage1_extras_kernel``).
The zeroing of the score rows is a PyTorch fill and is not counted."""


def read(rec):
    s, n = rec.kernel_s(lambda name: name.startswith("stage1_"))
    if not n or not rec.batches:
        return None
    return s * 1e3 / rec.batches

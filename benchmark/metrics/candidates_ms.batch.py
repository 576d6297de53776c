"""Milliseconds a batch of host candidate assembly: spans around
``native.tier_batch`` (the tier pools), ``native.conj_pool_native`` (the
conjunctive pool) and ``SearchPipeline._coverage_begin_fast`` (each
query's candidates resolved and encoded for coverage), summed over the
threads that ran them (tier and conjunctive jobs run on worker threads
beside the pipeline thread), divided by the batches served."""

NAMES = ("tier_batch", "conj_pool", "coverage_begin")


def install(ctx, rec):
    from infidex_tpu_torch import native

    rec.wrap(native, "tier_batch", "tier_batch")
    rec.wrap(native, "conj_pool_native", "conj_pool")
    rec.wrap(ctx.eng._pipeline, "_coverage_begin_fast", "coverage_begin")


def read(rec):
    if not rec.batches or not any(s[0] in NAMES for s in rec.spans):
        return None
    return rec.span_s(*NAMES) * 1e3 / rec.batches

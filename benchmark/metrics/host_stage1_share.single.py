"""Percent of the window's searches that took the host Stage-1 route:
searches in which ``vector_model.host_stage1.search_batch`` ran (a
wrapper on it, as ``chip_smoke.py`` counts it), over the searches."""


def _mark(rec, *args, **kwargs):
    if rec.current is not None:
        rec.marked["host_stage1"].add(rec.current)


def install(ctx, rec):
    rec.wrap(ctx.eng.vector_model.host_stage1, "search_batch",
             "host_stage1", _mark)


def read(rec):
    if not rec.searches:
        return None
    return 100.0 * len(rec.marked["host_stage1"]) / rec.searches

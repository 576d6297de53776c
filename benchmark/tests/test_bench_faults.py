"""The check that decides ``correct``: the harness driven on the CPU with
the program broken under it comes out not correct, and the control (the
reference with bfloat16 final scores) comes out mismatched."""

import pytest

from benchmark import control, run
from helpers import SHRINK, cpu_run

CELLS = ["movies1m.batch-mixed", "movies1m.batch-exact",
         "movies1m.single-mixed"]


def _wrap(ctx, attr, change):
    orig = getattr(ctx.eng, attr)
    setattr(ctx.eng, attr, lambda qs, *a, **k: change(qs, orig, *a, **k))


def alter_answer(ctx):
    """A score altered where the answer is produced."""
    def bump(result):
        if result.records:
            result.records[0].score += 1.0
        return result

    if ctx.traffic["entry"] == "batch":
        _wrap(ctx, "search_many",
              lambda qs, orig, *a, **k: [bump(r) for r in orig(qs, *a, **k)])
    else:
        _wrap(ctx, "search", lambda q, orig, *a, **k: bump(orig(q, *a, **k)))


def drop_half(ctx):
    """Half of each batch left out (empty results), or every other
    search answered empty."""
    empty = ctx.it.Result.make_empty
    if ctx.traffic["entry"] == "batch":
        def half(qs, orig, *a, **k):
            n = len(qs) // 2
            return orig(qs[:n], *a, **k) + [empty() for _ in qs[n:]]
        _wrap(ctx, "search_many", half)
    else:
        seen = []

        def every_other(q, orig, *a, **k):
            seen.append(1)
            return orig(q, *a, **k) if len(seen) % 2 else empty()
        _wrap(ctx, "search", every_other)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = cpu_run(cell)
    assert r["correct"] and r["checks"]["mismatched"]["value"] == 0


@pytest.mark.parametrize("fault", [alter_answer, drop_half])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault):
    r = cpu_run(cell, tamper=fault,
                shrink=dict(SHRINK, traffic=dict(SHRINK["traffic"],
                                                 check_sample=12)))
    assert not r["correct"]
    assert r["checks"]["mismatched"]["value"] > 0


def stage1_rounded(ctx):
    """Stage 1's scores, and so the candidates' base scores, rounded to
    bfloat16 where Stage 1 finishes."""
    import torch

    vm = ctx.eng.vector_model
    fin, fin_arr = vm.finish_stage1, vm.finish_stage1_arrays

    def bf(x):
        return torch.as_tensor(x, dtype=torch.float32).to(
            torch.bfloat16).float().numpy()
    vm.finish_stage1 = lambda s, i, *a, **k: fin(bf(s), i, *a, **k)
    vm.finish_stage1_arrays = lambda s, i: fin_arr(bf(s), i)


@pytest.mark.parametrize("cell", CELLS)
def test_stage1_precision_fault_is_not_correct(cell):
    r = cpu_run(cell, tamper=stage1_rounded,
                shrink=dict(SHRINK, traffic=dict(SHRINK["traffic"],
                                                 check_sample=12)))
    assert not r["correct"]
    assert r["checks"]["stage1_scores"]["value"] > 0


def test_control_is_mismatched():
    lines = control.readings(run.load_manifest(), CELLS, 2**31 + 1, 256,
                             device="cpu", shrink=SHRINK | {
                                 "traffic": {"check_sample": 32}})
    for line in lines:
        assert line["mismatched"] > line["of"] // 2, line
        assert line["stage1_scores"] == line["of"], line

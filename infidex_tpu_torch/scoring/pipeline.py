"""Search pipeline of the port: the reference pipeline, device I/O in torch.

The reference's ``scoring/pipeline.py`` is host orchestration except for
two methods that touch the device: ``_dispatch_chunk`` (launch one
coverage-kernel call) and ``_device_collect`` (read the packed outputs
back). The reference file is loaded once more under the name
``infidex_tpu_torch.scoring._reference_pipeline`` with this package as its
``__package__``, so its relative imports reach the port's modules; the
``SearchPipeline`` defined here subclasses it and overrides just those two
methods. Every other name of the reference module is re-exported as is.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from ..runtime import load_reference_module

_ref = load_reference_module(__package__, "scoring", "pipeline.py")
globals().update({k: v for k, v in vars(_ref).items()
                  if not k.startswith("__")})


class SearchPipeline(_ref.SearchPipeline):
    """The reference pipeline with its device calls on the port."""

    def _dispatch_chunk(self, ids: np.ndarray, qsel: np.ndarray,
                        base: np.ndarray, lcs_v: np.ndarray,
                        wave_args: tuple, config):
        """Enqueue ONE coverage-kernel call for up to
        DEVICE_COVERAGE_CHUNK candidates; returns the packed device
        output for collection (CUDA work runs asynchronously). Unlike the
        reference, the rows are not padded to a shape bucket: eager
        PyTorch compiles nothing per shape, and rows are scored
        independently."""
        from ..ops.coverage_kernel import coverage_fusion_batch

        tables = self._model.coverage_tables
        q_args, qlen_arg, lcs_args = wave_args
        return coverage_fusion_batch(
            tables.word_chars, tables.word_chars_rev, tables.word_lens,
            tables.doc_tokens, tables.doc_tok_offsets,
            tables.doc_tok_count, tables.doc_adj_ws,
            tables.doc_text_len, np.asarray(ids, np.int32),
            np.asarray(qsel, np.int32), *q_args,
            np.asarray(lcs_v, np.float32), np.asarray(base, np.float32),
            qlen_arg, tables.text_chars, tables.lcs_ok, *lcs_args,
            config=config)

    def _device_collect(self, pending: List[tuple]) -> None:
        """Read back dispatched coverage chunks (one packed transfer per
        chunk) and route each row group to its owning job."""
        for out, qsel, idx, keys, n, wave_jobs in pending:
            t0w = time.perf_counter()
            packed = out.cpu().numpy()
            self.device_wait_s += time.perf_counter() - t0w
            self.device_calls += 1
            score = packed[0][:n]
            # [2, C] layout: one f32 row = tie<<16 | word_hits<<8 | lcs
            meta = packed[1][:n].astype(np.int64)
            tie = meta >> 16
            wh = (meta >> 8) & 255
            lcs_row = meta & 255
            order = np.argsort(qsel, kind="stable")
            sq = qsel[order]
            uq, starts = np.unique(sq, return_index=True)
            bounds = np.append(starts, n)
            for g, qi in enumerate(uq.tolist()):
                rows = order[bounds[g]:bounds[g + 1]]
                job = wave_jobs[qi]
                g_wh = wh[rows]
                g_idx = idx[rows]
                if job.get("fast"):
                    job["max_word_hits"] = max(
                        job["max_word_hits"], int(g_wh.max()))
                    memo = job["wh_memo_arr"]
                    zero = memo[g_idx] == 0
                    memo[g_idx[zero]] = np.minimum(
                        g_wh[zero].astype(np.int64), 255)
                    # fill the truncation memo (finish_fast reads
                    # lcs_memo_arr > 0)
                    lmemo = job["lcs_memo_arr"]
                    g_lcs = lcs_row[rows]
                    lz = lmemo[g_idx] == 0
                    lmemo[g_idx[lz]] = g_lcs[lz]
                    job["res_scores"].append(score[rows].astype(np.float32))
                    job["res_ties"].append(tie[rows].astype(np.int64))
                    job["res_keys"].append(keys[rows])
                    job["res_idx"].append(g_idx)
                else:
                    whm = job["word_hits_memo"]
                    fs = job["final_scores"]
                    mwh = job["max_word_hits"]
                    for r in rows.tolist():
                        hits = int(wh[r])
                        ix = int(idx[r])
                        if whm.get(ix, 0) == 0:
                            whm[ix] = min(hits, 255)
                        if hits > mwh:
                            mwh = hits
                        fs.append(_ref.ScoreEntry(float(score[r]),
                                                  int(keys[r]), int(tie[r])))
                    job["max_word_hits"] = mwh


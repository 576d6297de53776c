"""SearchEngine facade: locking, status, normalization, post-processing.

Behavioral reference: Infidex ``SearchEngine.cs`` — reader/writer locking,
Ready/Indexing/Loading status, query normalization + lowercasing + synonym
canonicalization before the pipeline, empty-query facets, post-processing
order filter -> boost -> sort, save/load with the WordMatcher trailer and
derived stats recomputed on load.
"""

from __future__ import annotations

import enum
from typing import Callable, Dict, Iterable, List, Optional, Sequence

from . import tracing
from .api.fields import DocumentFields
from .api.query import INT_MAX, Query, Result
from .core import facets as facet_builder
from .core.config import ConfigurationParameters, WordMatcherSetup, get_config
from .core.documents import Document
from .coverage.engine import CoverageEngine
from .coverage.setup import CoverageSetup
from .index.short_query import PositionalPrefixIndex, ShortQueryResolver
from .index.vector_model import ScoreEntry, VectorModel
from .index.word_matcher import WordMatcher
from .scoring.pipeline import SearchPipeline
from .scoring.result_processor import ResultProcessor
from .synonyms import SynonymMap
from .tokenization.normalizer import TextNormalizer
from .tokenization.tokenizer import Tokenizer, TokenizerSetup
from .utils.locks import ReadWriteLock


class SearchEngineStatus(enum.Enum):
    READY = "Ready"
    INDEXING = "Indexing"
    LOADING = "Loading"


class IndexStatistics:
    """``build_seconds``: seconds of each phase of the last
    ``index_documents`` (``bulk_index`` or ``index_documents``,
    ``inverted_lists``, ``word_matcher``, ``optimized_indexes``,
    ``short_query_resolver``, ``invalidate_caches``); empty before the
    first."""

    def __init__(self, document_count: int, vocabulary_size: int,
                 build_seconds: Optional[Dict[str, float]] = None):
        self.document_count = document_count
        self.vocabulary_size = vocabulary_size
        self.build_seconds = dict(build_seconds or {})

    def __repr__(self) -> str:
        return f"{self.document_count} documents, {self.vocabulary_size} terms"


class SearchEngine:
    def __init__(
        self,
        index_sizes: Sequence[int],
        start_pad_size: int = 2,
        stop_pad_size: int = 0,
        enable_coverage: bool = True,
        text_normalizer: Optional[TextNormalizer] = None,
        tokenizer_setup: Optional[TokenizerSetup] = None,
        coverage_setup: Optional[CoverageSetup] = None,
        stop_term_limit: int = 1_250_000,
        word_matcher_setup: Optional[WordMatcherSetup] = None,
        field_weights: Optional[Sequence[float]] = None,
        synonym_map: Optional[SynonymMap] = None,
    ):
        text_normalizer = text_normalizer or TextNormalizer.create_default()
        tokenizer_setup = tokenizer_setup or TokenizerSetup.create_default()

        tokenizer = Tokenizer(list(index_sizes), start_pad_size, stop_pad_size,
                              text_normalizer, tokenizer_setup)
        self._vector_model = VectorModel(tokenizer, stop_term_limit,
                                         field_weights, synonym_map)
        self._vector_model.short_query_index = PositionalPrefixIndex(
            delimiters=tokenizer_setup.delimiters)

        self._coverage_setup: Optional[CoverageSetup] = None
        self._coverage_engine: Optional[CoverageEngine] = None
        if enable_coverage:
            self._coverage_setup = coverage_setup or CoverageSetup.create_default()
            self._coverage_engine = CoverageEngine(tokenizer, self._coverage_setup)

        self._word_matcher: Optional[WordMatcher] = None
        if word_matcher_setup is not None and tokenizer_setup is not None:
            self._word_matcher = WordMatcher(
                word_matcher_setup, tokenizer_setup.delimiters, text_normalizer)

        self._synonym_map = synonym_map
        self._pipeline = SearchPipeline(
            self._vector_model, self._coverage_engine, self._coverage_setup,
            self._word_matcher, synonym_map)

        self._is_indexed = False
        self._build_seconds: Dict[str, float] = {}
        self._document_field_schema: Optional[DocumentFields] = None
        self._compiled_filter_cache: Dict = {}
        # Columnar attribute image for vectorized filters/facets (SURVEY
        # §7.5); built lazily on first filtered/faceted query, dropped on
        # any index mutation.
        self._column_store = None
        self._rw_lock = ReadWriteLock()
        self.status = SearchEngineStatus.READY
        self.progress_changed: List[Callable[[int], None]] = []
        self._word_matcher_setup = word_matcher_setup
        self._engine_config = dict(
            index_sizes=list(index_sizes), start_pad_size=start_pad_size,
            stop_pad_size=stop_pad_size, enable_coverage=enable_coverage,
            stop_term_limit=stop_term_limit)

    # ------------------------------------------------------------------
    @property
    def synonym_map(self) -> Optional[SynonymMap]:
        return self._synonym_map

    @staticmethod
    def create_default() -> "SearchEngine":
        config = get_config(400)
        return SearchEngine(
            index_sizes=config.index_sizes,
            start_pad_size=config.start_pad_size,
            stop_pad_size=config.stop_pad_size,
            enable_coverage=True,
            text_normalizer=config.text_normalizer,
            tokenizer_setup=config.tokenizer_setup,
            coverage_setup=None,
            stop_term_limit=config.stop_term_limit,
            word_matcher_setup=config.word_matcher_setup,
            field_weights=config.field_weights,
        )

    @staticmethod
    def create_minimal() -> "SearchEngine":
        return SearchEngine(index_sizes=[3], start_pad_size=2, stop_pad_size=0,
                            enable_coverage=False)

    # ------------------------------------------------------------------
    # Indexing

    def index_documents(self, documents: Iterable[Document],
                        progress: Optional[Callable[[int], None]] = None,
                        monitor=None) -> None:
        """Index a batch; ``monitor`` (api.ProcessMonitor) is polled for
        cancellation every 100 documents (SearchEngine.cs:136)."""
        with self._rw_lock.write_lock():
            self.status = SearchEngineStatus.INDEXING
            try:
                self._index_documents_internal(list(documents), progress,
                                               monitor)
            finally:
                self.status = SearchEngineStatus.READY

    def _index_documents_internal(self, doc_list: List[Document],
                                  progress: Optional[Callable[[int], None]],
                                  monitor=None) -> None:
        self._is_indexed = False
        if doc_list and self._document_field_schema is None \
                and doc_list[0].fields is not None:
            self._document_field_schema = doc_list[0].fields

        phases: Dict[str, float] = {}
        with tracing.span("build.index", request=tracing.request()):
            try:
                self._build_phases(doc_list, progress, monitor, phases)
            finally:
                self._vector_model._bulk_image = None
        self._build_seconds = phases
        self._column_store = None
        self._report_progress(100, progress)

    def _build_phases(self, doc_list: List[Document],
                      progress: Optional[Callable[[int], None]], monitor,
                      phases: Dict[str, float]) -> None:
        total = len(doc_list)
        if self._can_bulk_index(doc_list):
            with tracing.timed("build.bulk_index", phases, "bulk_index"):
                self._vector_model.bulk_index_documents(
                    doc_list, word_matcher=self._word_matcher,
                    progress=lambda p: self._report_progress(p, progress),
                    monitor=monitor)
        else:
            with tracing.timed("build.index_documents", phases,
                               "index_documents"):
                for i, doc in enumerate(doc_list):
                    if (monitor is not None and i % 100 == 0
                            and monitor.is_cancelled):
                        raise InterruptedError("indexing cancelled")
                    stored = self._vector_model.index_document(doc)
                    if self._word_matcher is not None:
                        self._word_matcher.load(stored.indexed_text,
                                                stored.id)
                    if total > 0:
                        percent = int((i + 1) * 50.0 / total)
                        self._report_progress(percent, progress)

        with tracing.timed("build.inverted_lists", phases,
                           "inverted_lists"):
            self._vector_model.build_inverted_lists()
        if self._word_matcher is not None:
            with tracing.timed("build.word_matcher", phases,
                               "word_matcher"):
                self._word_matcher.finalize_index()
        self._is_indexed = True
        with tracing.timed("build.optimized_indexes", phases,
                           "optimized_indexes"):
            self._vector_model.build_optimized_indexes()
        with tracing.timed("build.short_query_resolver", phases,
                           "short_query_resolver"):
            self._rebuild_short_query_resolver()
        with tracing.timed("build.invalidate_caches", phases,
                           "invalidate_caches"):
            self._pipeline.invalidate_caches(
                appended_terms=self._appended_terms())

    def _can_bulk_index(self, doc_list: List[Document]) -> bool:
        """Native bulk build applies to fresh indexes only (the C++
        builder starts from an empty term dictionary) and requires the
        WordMatcher to share the tokenizer's delimiter set (one delimiter
        table drives all three passes)."""
        if len(doc_list) < 256:
            return False
        model = self._vector_model
        if len(model.term_dict) != 0 or model._segments:
            return False
        if model.synonym_map is not None and \
                model.synonym_map.has_canonical_mappings:
            # canonicalization rewrites index_text per doc — fine — but the
            # wm text uses the raw text in both paths; keep bulk on.
            pass
        if self._word_matcher is not None:
            setup = model.tokenizer.tokenizer_setup
            tok_delims = set(setup.delimiters) if setup else {" "}
            if self._word_matcher._delims != tok_delims:
                return False
        try:
            from .native.bulk import bulk_available

            return bulk_available()
        except Exception:
            return False

    def index_documents_async(self, documents: Iterable[Document],
                              progress: Optional[Callable[[int], None]] = None,
                              monitor=None):
        """Async wrapper (SearchEngine.cs:108-122 Task.Run parity);
        returns a concurrent.futures.Future."""
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=1)
        fut = pool.submit(self.index_documents, list(documents), progress,
                          monitor)
        fut.add_done_callback(lambda _: pool.shutdown(wait=False))
        return fut

    def search_async(self, query: Query):
        """Async wrapper; returns a concurrent.futures.Future[Result]."""
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=1)
        fut = pool.submit(self.search, query)
        fut.add_done_callback(lambda _: pool.shutdown(wait=False))
        return fut

    def _rebuild_short_query_resolver(self) -> None:
        m = self._vector_model
        if m.short_query_index is None:
            return
        ap = getattr(m, "_last_append", None)
        res = m.short_query_resolver
        if (ap is not None and res is not None
                and res._prefix_index is m.short_query_index
                and res._documents is m.documents
                and m.documents.mutation_epoch == m._derived_doc_epoch):
            # Append-only finalize: merge the newly-frozen prefix rows
            # into the existing champion lists (exactness argument in
            # ShortQueryResolver.append_docs) instead of a full doc-table
            # pass + all-prefix rebuild (5.4s at 1M docs).
            res.append_docs(m.short_query_index.last_appended, *ap)
            return
        m.short_query_resolver = ShortQueryResolver(
            m.short_query_index, m.documents, m._delimiters(),
            m._bulk_product("sq_tables"))
        # Eager champion builds at finalize (ShortQueryResolver.cs:
        # 113-204 builds all prefix lists in parallel at freeze) so the
        # first short query per prefix pays no scan spike. Vectorized;
        # the lazy per-prefix path remains as fallback/oracle.
        import os as _os

        if _os.environ.get("INFIDEX_TPU_EAGER_CHAMPIONS", "1") != "0":
            m.short_query_resolver.build_all_champions()

    def _report_progress(self, percent: int,
                         progress: Optional[Callable[[int], None]]) -> None:
        for cb in self.progress_changed:
            cb(percent)
        if progress is not None:
            progress(percent)

    def index_document(self, document: Document) -> None:
        """Add one document; derived stats stay stale until calculate_weights."""
        with self._rw_lock.write_lock():
            self.status = SearchEngineStatus.INDEXING
            try:
                stored = self._vector_model.index_document(document)
                if self._word_matcher is not None:
                    self._word_matcher.load(stored.indexed_text, stored.id)
                self._is_indexed = False
                self._column_store = None
            finally:
                self.status = SearchEngineStatus.READY

    def flush(self, segment_path: str, materialize: bool = True) -> None:
        """Roll the in-memory postings into an on-disk segment
        (SearchEngine.Flush, SearchEngine.cs:211-222).

        ``materialize=False`` enables memory-bounded serving: the flushed
        postings stay on disk (decoded lazily per query) instead of being
        rebuilt into the HBM-resident unified CSR — the reference's
        MMapBlockPostingsEnum.cs capability. Slower per query; bounded
        resident memory."""
        with self._rw_lock.write_lock():
            self.status = SearchEngineStatus.INDEXING
            try:
                self._vector_model.flush(segment_path,
                                         materialize=materialize)
                self._vector_model.build_inverted_lists()
                self._pipeline.invalidate_caches()
                self._column_store = None
                self._is_indexed = True
            finally:
                self.status = SearchEngineStatus.READY

    def _appended_terms(self):
        """[(term, tid), ...] the last finalize appended, or None after
        a full rebuild (pipeline vocab cache: extend vs drop)."""
        m = self._vector_model
        lnt = getattr(m, "_last_new_terms", None)
        if lnt is None:
            return None
        base_t, n_new = lnt
        terms = m.term_dict.terms
        return [(terms[base_t + i], base_t + i) for i in range(n_new)]

    def calculate_weights(self) -> None:
        with self._rw_lock.write_lock():
            self.status = SearchEngineStatus.INDEXING
            try:
                self._vector_model.calculate_weights()
                if self._word_matcher is not None:
                    self._word_matcher.finalize_index()
                self._vector_model.build_optimized_indexes()
                self._rebuild_short_query_resolver()
                self._pipeline.invalidate_caches(
                    appended_terms=self._appended_terms())
                self._column_store = None
                self._is_indexed = True
            finally:
                self.status = SearchEngineStatus.READY

    def delete_documents(self, document_key: int) -> None:
        with self._rw_lock.write_lock():
            self._vector_model.documents.delete_documents_by_key(document_key)
            self._column_store = None
            if self._vector_model.device is not None:
                import numpy as np

                n = len(self._vector_model.documents)
                deleted = np.array(
                    [self._vector_model.documents.get_document(i).deleted
                     for i in range(n)], dtype=bool)
                self._vector_model.device.set_deleted(deleted)
                if self._vector_model.sharded is not None:
                    self._vector_model.sharded.set_deleted(deleted)
                # keep the host-side mirrors (tiered Stage-1, fast-path
                # finish) in sync with the device live mask
                self._vector_model.deleted_arr = deleted

    # ------------------------------------------------------------------
    # Multi-device serving

    def enable_sharded_serving(self, mesh=None, n_devices: Optional[int] = None
                               ) -> None:
        """Serve Stage-1 scoring and coverage sharded over a device mesh.

        Documents shard across devices; postings and queries replicate;
        per-shard top-k lists merge over ICI — the mesh analogue of the
        reference's per-segment search + heap merge (VectorModel.cs:573-585).
        Search results are identical to single-device serving (pinned by
        tests/test_sharded_engine.py on an 8-CPU mesh)."""
        from .parallel.sharding import make_mesh

        with self._rw_lock.write_lock():
            if mesh is None:
                mesh = make_mesh(n_devices)
            self._vector_model.enable_sharding(mesh)

    def disable_sharded_serving(self) -> None:
        with self._rw_lock.write_lock():
            self._vector_model.disable_sharding()

    # ------------------------------------------------------------------
    # Search

    def _servable(self) -> bool:
        """True when a finalized index image exists to serve from.

        Incremental adds set ``_is_indexed = False`` (derived stats are
        stale until ``calculate_weights``) but searches keep serving the
        LAST finalized image, like the reference: a live engine must not
        go dark between an add and the next finalize
        (SearchEngine.cs:165-185 accumulate-then-CalculateWeights cycle)."""
        return self._is_indexed or self._vector_model.built is not None

    def search(self, query: Query) -> Result:
        with tracing.span("engine.search", request=tracing.request()):
            return self._search(query)

    def _search(self, query: Query) -> Result:
        import time as _time

        t_start = _time.perf_counter()
        with self._rw_lock.read_lock():
            if not self._servable():
                return Result.make_empty()

            q = query.copy()
            q_text = q.text.strip()
            if self._vector_model.tokenizer.text_normalizer is not None:
                q_text = self._vector_model.tokenizer.text_normalizer.normalize(q_text)
            q_text = q_text.lower()
            if (self._synonym_map is not None
                    and self._synonym_map.has_canonical_mappings
                    and self._vector_model.tokenizer.tokenizer_setup is not None):
                q_text = self._synonym_map.canonicalize_text(
                    q_text, self._vector_model.tokenizer.tokenizer_setup.delimiters)
            q.text = q_text
            q._timeout_ms = max(0, min(q._timeout_ms, 10000))

            if (not q.text or q.text.isspace()) and q.enable_facets:
                return self._handle_empty_query_with_facets(q)
            if not q.text or q.text.isspace():
                return Result.make_empty()

            # Deadline enforcement (Api/Query.cs:75 TimeOutLimitMilliseconds;
            # 0 = unlimited): the pipeline checks between stages and per
            # coverage chunk, returning partial results on expiry.
            deadline = (t_start + q.time_out_limit_milliseconds / 1000.0
                        if q.timeout_enforced else None)
            status: Dict[str, bool] = {}
            results = self._pipeline.execute(
                q.text,
                (q.coverage_setup or self._coverage_setup) if q.enable_coverage else None,
                q.coverage_depth,
                q.max_number_of_records_to_return,
                deadline=deadline,
                status=status,
                prefilter_mask=self._prefilter_mask(q.filter),
            )
            with tracing.span("engine.post_process"):
                results = self._apply_post_processing(results, q)

            facets = None
            if q.enable_facets:
                facets = self._build_facets_batch([results])[0]

            top = results[: q.max_number_of_records_to_return]
            return Result(
                records=top,
                facets=facets,
                truncation_index=len(top) - 1 if top else 0,
                truncation_score=top[-1].score if top else 0.0,
                did_time_out=status.get("timed_out", False),
                total_candidates=len(results),
                execution_time_ms=int(
                    (_time.perf_counter() - t_start) * 1000),
            )

    def explain(self, query_text: str, document_key: int) -> dict:
        """Per-document ranking explanation (FusionScorer.LogExplanation,
        Scoring/FusionScorer.cs:238-261): coverage features + fusion
        precedence/semantic components for one (query, document) pair,
        computed on the host oracle."""
        from .scoring.fusion import fusion_calculate
        from .scoring.segment_processor import calculate_lcs

        with self._rw_lock.read_lock():
            if not self._servable() or self._coverage_engine is None:
                return {}
            doc = self._vector_model.documents.get_document_by_public_key(
                document_key)
            if doc is None:
                return {}
            norm = self._vector_model.tokenizer.text_normalizer
            q_text = query_text.strip().lower()
            if norm is not None:
                q_text = norm.normalize(q_text)
            doc_text = doc.indexed_text
            if norm is not None:
                doc_text = norm.normalize(doc_text)
            context = self._coverage_engine.prepare_query(q_text)
            setup = self._coverage_setup
            tolerance = 0
            if len(q_text) >= setup.coverage_q_limit_for_error_tolerance:
                tolerance = int(len(q_text) *
                                setup.coverage_lcs_error_tolerance_relative_q)
            lcs_val = calculate_lcs(q_text, doc_text, tolerance)
            features = self._coverage_engine.calculate_features(
                context, doc_text, lcs_val, doc.id)
            score, tiebreaker = fusion_calculate(
                q_text, doc_text, features, 0.0,
                self._vector_model.tokenizer.min_index_size)
            return {
                "query": q_text,
                "document": doc_text,
                "score": float(score),
                "precedence": int(score),
                "semantic": float(score) - int(score),
                "tiebreaker": int(tiebreaker),
                "lcs": int(lcs_val),
                "word_hits": features.word_hits,
                "terms_with_any_match": features.terms_with_any_match,
                "terms_fully_matched": features.terms_fully_matched,
                "coverage_score": features.coverage_score,
                "is_complete": features.terms_with_any_match ==
                features.terms_count,
                "lexical_prefix_last": features.fusion.lexical_prefix_last,
                "is_perfect_doc": features.fusion.is_perfect_doc_lexical,
                "has_anchor_stem": features.fusion.has_anchor_stem,
            }

    def search_batch(self, queries: List[Query]) -> List[Result]:
        """Execute B searches with shared device work.

        Per-query semantics are identical to ``search``; the two device
        stages are batched across queries (one Stage-1 kernel call for the
        whole batch; coverage chunks mix candidates of all queries). This is
        the high-throughput entry point: on links with high per-call latency
        it multiplies QPS by roughly the batch size.
        """
        with tracing.span("engine.search_batch", request=tracing.request()):
            return self._search_batch(queries)

    def _search_batch(self, queries: List[Query]) -> List[Result]:
        import time as _time

        t_start = _time.perf_counter()
        with self._rw_lock.read_lock():
            if not self._servable():
                return [Result.make_empty() for _ in queries]
            prepped, direct, statuses = self._prep_batch_queries(queries)
            results_by_query: Dict[int, List[ScoreEntry]] = {}
            for (_, depth, max_records, _fid), idxs in self._group_by_params(
                    prepped, direct).items():
                q0 = prepped[idxs[0]]
                setup = (q0.coverage_setup or self._coverage_setup) \
                    if q0.enable_coverage else None
                batch_out = self._pipeline.execute_batch(
                    [prepped[i].text for i in idxs], setup, depth, max_records,
                    deadlines=self._batch_deadlines(prepped, idxs, t_start),
                    statuses=[statuses[i] for i in idxs],
                    prefilter_mask=self._prefilter_mask(q0.filter))
                for i, res in zip(idxs, batch_out):
                    results_by_query[i] = res
            return self._finalize_batch_results(
                prepped, direct, statuses, results_by_query, t_start)

    def serving_split(self, reset: bool = True) -> dict:
        """Cumulative host/device serving split since the last reset:
        ``device_wait_s`` is time the pipeline thread spent BLOCKED on
        device readbacks (Stage-1 groups + coverage chunks) and
        ``device_calls`` the round-trip count. Under the pipelined
        scheduler, wall = host work + this blocked time, so the pair
        tells which side binds a serving run (the benchmark's
        ``device_wait_ms.*`` readers take it over a window)."""
        p = self._pipeline
        out = dict(device_wait_s=p.device_wait_s,
                   device_calls=p.device_calls)
        if reset:
            p.device_wait_s = 0.0
            p.device_calls = 0
        return out

    #: default software-pipeline depth for search_many. Depth 2 overlaps
    #: each device program with ONE other batch's host segment; when a
    #: single program (the 1M Stage-1 group, ~195ms) outlasts that
    #: segment the readback still blocks (BENCH r4: 118ms blocked/batch
    #: with 293ms of host work available). Deeper pipelines overlap more
    #: segments at the cost of per-query latency; tuned by TPU A/B.
    PIPELINE_DEPTH = int(__import__("os").environ.get(
        "INFIDEX_TPU_PIPELINE_DEPTH", "2"))

    def search_many(self, queries: List[Query], batch_size: int = 64,
                    pipeline_depth: Optional[int] = None) -> List[Result]:
        """Execute MANY searches as software-pipelined sub-batches.

        Splits the queries into ``batch_size`` batches and overlaps batch
        i+1's host work (tokenize, WordMatcher lookups, candidate resolve)
        with batch i's kernels in flight on the card: CUDA launches return
        before the kernels finish (``SearchPipeline.
        execute_batches_pipelined``). Per-query semantics are identical to
        ``search_batch``; this is the bulk/serving entry point — the
        steady-state cost per batch approaches max(host_ms, device_ms)
        instead of their sum.
        """
        with tracing.span("engine.search_many", request=tracing.request()):
            return self._search_many(queries, batch_size, pipeline_depth)

    def _search_many(self, queries: List[Query], batch_size: int,
                     pipeline_depth: Optional[int]) -> List[Result]:
        import time as _time

        if pipeline_depth is None:
            pipeline_depth = self.PIPELINE_DEPTH
        t_start = _time.perf_counter()
        with self._rw_lock.read_lock():
            if not self._servable():
                return [Result.make_empty() for _ in queries]
            prepped, direct, statuses = self._prep_batch_queries(queries)
            specs: List[dict] = []
            spec_idxs: List[List[int]] = []
            for (_, depth, max_records, _fid), idxs in self._group_by_params(
                    prepped, direct).items():
                q0 = prepped[idxs[0]]
                setup = (q0.coverage_setup or self._coverage_setup) \
                    if q0.enable_coverage else None
                pf = self._prefilter_mask(q0.filter)
                for lo in range(0, len(idxs), batch_size):
                    sub = idxs[lo:lo + batch_size]
                    specs.append(dict(
                        search_texts=[prepped[i].text for i in sub],
                        coverage_setup=setup,
                        coverage_depth=depth,
                        max_results=max_records,
                        deadlines=self._batch_deadlines(prepped, sub, t_start),
                        statuses=[statuses[i] for i in sub],
                        prefilter_mask=pf))
                    spec_idxs.append(sub)
            results_by_query: Dict[int, List[ScoreEntry]] = {}
            for sub, batch_out in zip(spec_idxs,
                                      self._pipeline.execute_batches_pipelined(
                                          specs, pipeline_depth)):
                for i, res in zip(sub, batch_out):
                    results_by_query[i] = res
            return self._finalize_batch_results(
                prepped, direct, statuses, results_by_query, t_start)

    def _prep_batch_queries(self, queries: List[Query]):
        """Shared search_batch/search_many query prep: normalize text,
        canonicalize synonyms, clamp timeouts, answer empty queries."""
        prepped: List[Query] = []
        direct: Dict[int, Result] = {}
        for i, query in enumerate(queries):
            q = query.copy()
            q_text = q.text.strip()
            if self._vector_model.tokenizer.text_normalizer is not None:
                q_text = self._vector_model.tokenizer.text_normalizer.normalize(q_text)
            q_text = q_text.lower()
            if (self._synonym_map is not None
                    and self._synonym_map.has_canonical_mappings
                    and self._vector_model.tokenizer.tokenizer_setup is not None):
                q_text = self._synonym_map.canonicalize_text(
                    q_text, self._vector_model.tokenizer.tokenizer_setup.delimiters)
            q.text = q_text
            q._timeout_ms = max(0, min(q._timeout_ms, 10000))
            if not q.text or q.text.isspace():
                direct[i] = (self._handle_empty_query_with_facets(q)
                             if q.enable_facets else Result.make_empty())
            prepped.append(q)
        statuses: List[Dict[str, bool]] = [{} for _ in prepped]
        return prepped, direct, statuses

    def _group_by_params(self, prepped: List[Query],
                         direct: Dict[int, Result]) -> Dict[tuple, List[int]]:
        """Group queries by identical pipeline parameters; each group is
        one batched pipeline run (parameters are almost always uniform)."""
        groups: Dict[tuple, List[int]] = {}
        for i, q in enumerate(prepped):
            if i in direct:
                continue
            setup = (q.coverage_setup or self._coverage_setup) \
                if q.enable_coverage else None
            key = (id(setup), q.coverage_depth,
                   q.max_number_of_records_to_return, id(q.filter))
            groups.setdefault(key, []).append(i)
        return groups

    @staticmethod
    def _batch_deadlines(prepped: List[Query], idxs: List[int],
                         t_start: float) -> List[Optional[float]]:
        return [
            (t_start + prepped[i].time_out_limit_milliseconds / 1000.0)
            if prepped[i].timeout_enforced else None
            for i in idxs]

    def _finalize_batch_results(self, prepped: List[Query],
                                direct: Dict[int, Result],
                                statuses: List[Dict[str, bool]],
                                results_by_query: Dict[int, List[ScoreEntry]],
                                t_start: float) -> List[Result]:
        import time as _time

        out: List[Result] = []
        with tracing.span("engine.post_process"):
            processed: Dict[int, List[ScoreEntry]] = {
                i: self._apply_post_processing(results_by_query[i], q)
                for i, q in enumerate(prepped) if i not in direct}
        # Facets for the WHOLE batch in one pass per field: the counts
        # matrix is a single device segment-sum (ops/facets.py) or a host
        # bincount, never a per-result Python document walk.
        facet_idx = [i for i, q in enumerate(prepped)
                     if i not in direct and q.enable_facets]
        facet_maps = {}
        if facet_idx:
            batch_facets = self._build_facets_batch(
                [processed[i] for i in facet_idx])
            facet_maps = dict(zip(facet_idx, batch_facets))
        for i, q in enumerate(prepped):
            if i in direct:
                out.append(direct[i])
                continue
            results = processed[i]
            facets = facet_maps.get(i) if q.enable_facets else None
            top = results[: q.max_number_of_records_to_return]
            out.append(Result(
                records=top,
                facets=facets,
                truncation_index=len(top) - 1 if top else 0,
                truncation_score=top[-1].score if top else 0.0,
                did_time_out=statuses[i].get("timed_out", False),
                total_candidates=len(results),
                execution_time_ms=int(
                    (_time.perf_counter() - t_start) * 1000),
            ))
        return out

    def _handle_empty_query_with_facets(self, q: Query) -> Result:
        """Empty-query faceting without materializing a ScoreEntry per doc:
        live ids come from the ColumnStore, the filter is one dense mask,
        and only the top ``max_records`` entries are built."""
        from .filtering.columnar import contains_derived

        docs = self._vector_model.documents
        store = self._get_column_store()
        live = store.live_doc_ids
        if q.filter is not None:
            if contains_derived(q.filter):
                all_results = [ScoreEntry(65535.0, d.document_key)
                               for d in docs.all_documents()]
                processor = ResultProcessor(docs, self._compiled_filter_cache,
                                            column_store=store)
                all_results = processor.apply_filter(all_results, q.filter)
                top = all_results[: q.max_number_of_records_to_return]
                facets = facet_builder.build_facets(
                    top, docs, self._document_field_schema)
                return Result(records=top, facets=facets,
                              truncation_index=len(top) - 1 if top else 0,
                              truncation_score=top[-1].score if top else 0.0)
            mask = store.evaluate(q.filter)
            if getattr(q.filter, "number_of_documents_in_filter", None) == 0:
                q.filter.number_of_documents_in_filter = int(mask[live].sum())
            live = live[mask[live]]
        top = [ScoreEntry(65535.0, docs.get_document(int(i)).document_key)
               for i in live[: q.max_number_of_records_to_return]]
        facets = facet_builder.build_facets(
            top, docs, self._document_field_schema)
        return Result(records=top, facets=facets,
                      truncation_index=len(top) - 1 if top else 0,
                      truncation_score=top[-1].score if top else 0.0)

    def _apply_post_processing(self, results: List[ScoreEntry], q: Query) -> List[ScoreEntry]:
        needs_store = (q.filter is not None
                       or (q.enable_boost and bool(q.boosts)))
        processor = ResultProcessor(
            self._vector_model.documents, self._compiled_filter_cache,
            column_store=self._get_column_store() if needs_store else None)
        if q.compiled_filter_bytecode is not None:
            from .filtering.serializer import deserialize

            results = processor.apply_filter(
                results, q.filter, precompiled=deserialize(q.compiled_filter_bytecode))
        elif q.filter is not None:
            results = processor.apply_filter(results, q.filter)
        if q.enable_boost and q.boosts:
            results = processor.apply_boosts(results, q.boosts)
        if q.sort_by is not None:
            results = processor.apply_sort(results, q.sort_by, q.sort_ascending)
        return results

    # ------------------------------------------------------------------
    def get_document(self, document_key: int) -> Optional[Document]:
        with self._rw_lock.read_lock():
            return self._vector_model.documents.get_document_by_public_key(document_key)

    def get_documents(self, document_key: int) -> List[Document]:
        with self._rw_lock.read_lock():
            return self._vector_model.documents.get_documents_by_key(document_key)

    def get_statistics(self) -> IndexStatistics:
        with self._rw_lock.read_lock():
            return IndexStatistics(self._vector_model.documents.count,
                                   len(self._vector_model.term_dict),
                                   self._build_seconds)

    # ------------------------------------------------------------------
    # Persistence (index/persistence.py)

    def save(self, file_path: str) -> None:
        from .index.persistence import save_engine

        with self._rw_lock.write_lock():
            save_engine(self, file_path)

    @staticmethod
    def load(file_path: str, **engine_kwargs) -> "SearchEngine":
        from .index.persistence import load_engine

        return load_engine(file_path, **engine_kwargs)

    # internals used by persistence
    @property
    def vector_model(self) -> VectorModel:
        return self._vector_model

    @property
    def word_matcher(self) -> Optional[WordMatcher]:
        return self._word_matcher

    @property
    def document_field_schema(self) -> Optional[DocumentFields]:
        return self._document_field_schema

    def _mark_indexed(self) -> None:
        self._is_indexed = True
        self._pipeline.invalidate_caches()
        self._column_store = None

    def _prefilter_mask(self, filt):
        """Dense doc mask for PRE-filtering: selective filters intersect
        into Stage-1 scoring (scores of non-matching docs zero before the
        device top-k) instead of post-filtering the 500 covered candidates
        — so a filter that keeps 1% of docs still fills the result page.
        Post-filter semantics (ResultProcessor.cs:35-70) still run on the
        output (idempotent here) and remain the ONLY filter for
        DerivedFilter and sharded serving. Disable with
        INFIDEX_TPU_PREFILTER=0."""
        if filt is None:
            return None
        import os as _os

        if _os.environ.get("INFIDEX_TPU_PREFILTER", "1") == "0":
            return None
        if self._vector_model.sharded is not None:
            return None
        if self._vector_model._mmap_stage1 is not None:
            return None   # mmap serving scores on host: post-filter only
        from .filtering.columnar import contains_derived

        if contains_derived(filt):
            return None
        try:
            store = self._get_column_store()
            cache = getattr(store, "_prefilter_masks", None)
            if cache is None:
                cache = store._prefilter_masks = {}
            hit = cache.get(id(filt))
            if hit is not None and hit[0] is filt:
                mask = hit[1]
            else:
                mask = store.evaluate(filt)
                if len(cache) >= 64:
                    cache.clear()
                cache[id(filt)] = (filt, mask)
        except Exception:
            return None   # unsupported columnar shape: post-filter only
        if mask is None or mask.size < self._vector_model.doc_keys_arr.size:
            return None
        return mask

    def _build_facets_batch(self, results_lists):
        """Facet dicts for several queries' result lists at once.

        Reference semantics: Core/FacetBuilder.cs:19-56 (count field
        values over the result set via the first live document per public
        key; count desc / value asc; top 100 per field). Counting runs
        over ColumnStore dictionary codes — one device segment-sum for
        the whole batch when it amortizes a dispatch, host bincounts
        otherwise — instead of the reference's per-document host walk.
        """
        schema = self._document_field_schema
        facetable = schema.get_facetable_field_list() if schema else []
        if not facetable:
            return [{} for _ in results_lists]
        import numpy as _np

        docs = self._vector_model.documents
        store = self._get_column_store()
        id_lists = []
        for results in results_lists:
            ids = [docs.first_live_id(e.document_id) for e in results]
            id_lists.append(_np.asarray(
                [i for i in ids if i is not None], dtype=_np.int64))
        ctr = self._facet_device_counter(store)
        out = [dict() for _ in results_lists]
        for field in facetable:
            pairs_per_q = store.facet_pairs_batch(
                field.name, id_lists, is_array=field.is_array,
                device_counter=ctr)
            for i, pairs in enumerate(pairs_per_q):
                if pairs:
                    out[i][field.name] = pairs
        return out

    def _facet_device_counter(self, store):
        """DeviceFacetCounter tied to this ColumnStore (rebuilt stores
        drop their device code tables with them). INFIDEX_TPU_DEVICE_FACETS:
        "0" never dispatch, "1" dispatch whenever the cardinality cap
        allows, unset/auto = dispatch only when the Stage-1 device backend
        is active and the batch amortizes the link round trip."""
        import os as _os

        mode = _os.environ.get("INFIDEX_TPU_DEVICE_FACETS", "auto")
        if mode == "0":
            return None
        if self._vector_model.device is None and mode != "1":
            return None
        ctr = getattr(store, "_device_facet_counter", None)
        if ctr is None:
            from .ops.facets import DeviceFacetCounter

            ctr = DeviceFacetCounter()
            store._device_facet_counter = ctr
        if mode == "1":
            ctr.MIN_BATCH_IDS = 0
        return ctr

    def _get_column_store(self):
        """Lazily-built ColumnStore; a fully-built store is published with
        one atomic attribute assignment so concurrent readers either see
        None (and build their own) or a complete store."""
        store = self._column_store
        if store is None:
            from .filtering.columnar import ColumnStore

            store = ColumnStore(self._vector_model.documents)
            self._column_store = store
        return store

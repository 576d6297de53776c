"""infidex_tpu_torch — the PyTorch/CUDA port of infidex_tpu.

A package that stands on its own: it imports ``torch``, never ``jax``,
and nothing of ``infidex_tpu``. The host modules (engine, vector model,
candidate assembly, tokenization, coverage oracle, fusion, filters,
persistence, the native C++ library) are copies of the reference's files.
The modules that touch the device are the port's own: ``runtime``,
``convert``, ``index/device.py``, ``ops/*``, ``parallel/sharding.py``
(sharded serving over a list of devices), the device methods of
``scoring/pipeline.py`` (``_dispatch_chunk``, ``_device_collect``) and of
``index/mmap_serving.py`` (``_dispatch_group``, ``search_batch_collect``),
and the CUDA sources under ``csrc/``.

The device is explicit (``runtime.set_device`` / ``runtime.device``):
CUDA by default, the CPU only on request.
"""

from .api.fields import DocumentFields, Field, Weight
from .api.filters import (CompositeFilter, DerivedFilter, Filter,
                          FilterBuilder, FilterParseException, InFilter,
                          LiteralFilter, NullFilter, RangeFilter, RegexFilter,
                          StringFilter, StringOperation, TernaryFilter,
                          ValueFilter)
from .api.query import Boost, BoostStrength, Query, Result
from .core.config import (AutoSegmentationSetup,
                          ConfigurationParameters, WordMatcherSetup,
                          get_config, has_config)
from .core.documents import Document, DocumentCollection
from .coverage.setup import CoverageSetup
from .engine import IndexStatistics, SearchEngine, SearchEngineStatus
from .index.vector_model import ScoreEntry, VectorModel
from .api.process_monitor import ProcessMonitor
from .core.shingle import Shingle, SystemStatus
from .core.topk import TopKHeap
from .filtering.mask import FilterCache, FilterMask
from .index.trie import TrieIndex
from .synonyms import SynonymMap
from .utils.roaring import RoaringBitmap
from .tokenization.normalizer import TextNormalizer
from .tokenization.tokenizer import Tokenizer, TokenizerSetup

__version__ = "0.1.0"

__all__ = [
    "AutoSegmentationSetup",
    "Boost",
    "FilterCache",
    "FilterMask",
    "ProcessMonitor",
    "RoaringBitmap",
    "Shingle",
    "SystemStatus",
    "TopKHeap",
    "TrieIndex",
    "BoostStrength",
    "CompositeFilter",
    "ConfigurationParameters",
    "CoverageSetup",
    "DerivedFilter",
    "Document",
    "Filter",
    "FilterBuilder",
    "FilterParseException",
    "InFilter",
    "LiteralFilter",
    "NullFilter",
    "RangeFilter",
    "RegexFilter",
    "StringFilter",
    "StringOperation",
    "TernaryFilter",
    "ValueFilter",
    "DocumentCollection",
    "DocumentFields",
    "Field",
    "IndexStatistics",
    "Query",
    "Result",
    "ScoreEntry",
    "SearchEngine",
    "SearchEngineStatus",
    "SynonymMap",
    "TextNormalizer",
    "Tokenizer",
    "TokenizerSetup",
    "VectorModel",
    "Weight",
    "WordMatcherSetup",
    "get_config",
    "has_config",
]

"""infidex_tpu_torch — the PyTorch/CUDA port of infidex_tpu.

Package-path overlay: this package owns only the modules that touch the
device (``runtime``, ``convert``, ``index/device.py``,
``index/mmap_serving.py``, ``ops/*``, ``scoring/pipeline.py`` and the CUDA
sources under ``csrc/``). Its
``__path__`` (and that of each owned subpackage) ends with the matching
directory of ``infidex_tpu``, so every other module — engine, vector
model, tokenization, coverage oracle, fusion, filters — is the
reference's own file, loaded under this package's name. Its relative
imports (``from .device import ...``) therefore resolve to the port's
device modules. The port imports ``torch`` and never ``jax``.

The device is explicit (``runtime.set_device`` / ``runtime.device``):
CUDA by default, the CPU only on request.
"""

from .runtime import reference_dir as _reference_dir

__path__.append(_reference_dir())

from .api.fields import DocumentFields, Field, Weight  # noqa: E402
from .api.filters import (CompositeFilter, DerivedFilter, Filter,  # noqa: E402
                          FilterBuilder, FilterParseException, InFilter,
                          LiteralFilter, NullFilter, RangeFilter, RegexFilter,
                          StringFilter, StringOperation, TernaryFilter,
                          ValueFilter)
from .api.query import Boost, BoostStrength, Query, Result  # noqa: E402
from .core.config import (AutoSegmentationSetup,  # noqa: E402
                          ConfigurationParameters, WordMatcherSetup,
                          get_config, has_config)
from .core.documents import Document, DocumentCollection  # noqa: E402
from .coverage.setup import CoverageSetup  # noqa: E402
from .engine import IndexStatistics, SearchEngine, SearchEngineStatus  # noqa: E402
from .index.vector_model import ScoreEntry, VectorModel  # noqa: E402
from .api.process_monitor import ProcessMonitor  # noqa: E402
from .core.shingle import Shingle, SystemStatus  # noqa: E402
from .core.topk import TopKHeap  # noqa: E402
from .filtering.mask import FilterCache, FilterMask  # noqa: E402
from .index.trie import TrieIndex  # noqa: E402
from .synonyms import SynonymMap  # noqa: E402
from .utils.roaring import RoaringBitmap  # noqa: E402
from .tokenization.normalizer import TextNormalizer  # noqa: E402
from .tokenization.tokenizer import Tokenizer, TokenizerSetup  # noqa: E402

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

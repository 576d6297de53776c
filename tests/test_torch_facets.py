"""Facets and filters through the port (infidex_tpu_torch, plain PyTorch
on the CPU).

* The port's ``DeviceFacetCounter`` against the reference's (JAX on the
  CPU) on the same seeded numpy ids and codes: ragged rows padded with
  -1, empty rows, missing values (code -1), V = 2 and V = 8192. Integer
  counts: exact.
* The reference suite's own facet and filter tests
  (tests/test_facets_batch.py, test_filters.py, test_prefilter.py,
  test_columnar_and_postprocessing.py) imported, not copied, and run with
  their modules' reference names bound to the port's objects (the
  rebinding of tests/test_torch_entry_points.py).
"""

import numpy as np
import pytest
import torch

from infidex_tpu.ops import facets as ref_facets
from infidex_tpu_torch import runtime
from infidex_tpu_torch.ops import facets
from tests import test_columnar_and_postprocessing as columnar_tests
from tests import test_facets_batch as facets_tests
from tests import test_filters as filters_tests
from tests import test_prefilter as prefilter_tests
from tests.test_torch_entry_points import _bind_to_port

runtime.set_device("cpu")
torch.set_num_threads(1)

_SUITES = (columnar_tests, facets_tests, filters_tests, prefilter_tests)


@pytest.fixture(scope="module", autouse=True)
def _reference_tests_on_the_port():
    mp = pytest.MonkeyPatch()
    try:
        for mod in _SUITES:
            _bind_to_port(mp, mod)
        yield
    finally:
        mp.undo()


def _id_lists(rng, n_docs: int, n_rows: int):
    lists = [rng.choice(n_docs, size=int(rng.randint(0, 400)),
                        replace=False).astype(np.int64)
             for _ in range(n_rows)]
    lists[1] = np.zeros(0, np.int64)          # an empty result list
    return lists


@pytest.mark.parametrize("n_values", [2, 37, 8192])
def test_device_counter_matches_reference(n_values):
    rng = np.random.RandomState(n_values)
    n_docs = 3000
    codes = rng.randint(-1, n_values, size=n_docs).astype(np.int32)
    codes[rng.rand(n_docs) < 0.2] = -1       # missing values
    id_lists = _id_lists(rng, n_docs, 11)
    want = ref_facets.DeviceFacetCounter().counts("f", codes, n_values,
                                                  id_lists)
    ctr = facets.DeviceFacetCounter()
    got = ctr.counts("f", codes, n_values, id_lists)
    assert got.dtype == np.int32 and got.shape == (11, n_values)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, facets.facet_counts_batch_host(codes, n_values, id_lists))
    # the cached code table serves a second, smaller batch
    np.testing.assert_array_equal(
        ctr.counts("f", codes, n_values, id_lists[:3]), want[:3])


def test_facet_counts_skips_pads_and_missing_values():
    codes = torch.tensor([0, 1, -1, 1], dtype=torch.int32)
    ids = torch.tensor([[0, 1, 2, 3], [3, 3, -1, -1], [-1, -1, -1, -1]])
    got = facets.facet_counts(ids, codes, 2)
    assert got.dtype == torch.int32
    assert got.tolist() == [[1, 2], [0, 2], [0, 0]]


def test_reference_names_are_bound_to_the_port():
    import infidex_tpu_torch as port

    assert facets_tests.DeviceFacetCounter is facets.DeviceFacetCounter
    for mod in (facets_tests, prefilter_tests, columnar_tests):
        assert mod.SearchEngine is port.SearchEngine, mod.__name__
    assert filters_tests.FilterVM.__module__.startswith("infidex_tpu_torch")


# --- the reference suites' tests, on the port ---------------------------

docs = columnar_tests.docs


class TestColumnarVsVMOnPort(columnar_tests.TestColumnarVsVM):
    pass


class TestEndToEndPostProcessingOnPort(
        columnar_tests.TestEndToEndPostProcessing):
    pass


class TestParserOnPort(filters_tests.TestParser):
    pass


class TestParserErrorsOnPort(filters_tests.TestParserErrors):
    pass


class TestVMOnPort(filters_tests.TestVM):
    pass


class TestBytecodeOnPort(filters_tests.TestBytecode):
    pass


class TestFilterBuilderOnPort(filters_tests.TestFilterBuilder):
    pass


def _suite_class(mod, name: str):
    """A test class holding ``mod``'s module-level tests, with ``mod``'s
    ``engine`` fixture rebuilt by its own code under the port's names
    (one engine per class, as the module had one)."""

    def engine(self):
        return mod.engine.__wrapped__()

    body = {"engine": pytest.fixture(scope="class")(engine)}
    body.update({k: staticmethod(v) for k, v in vars(mod).items()
                 if k.startswith("test_") and callable(v)})
    return type(name, (), body)


TestFacetsBatchOnPort = _suite_class(facets_tests, "TestFacetsBatchOnPort")
TestPrefilterOnPort = _suite_class(prefilter_tests, "TestPrefilterOnPort")

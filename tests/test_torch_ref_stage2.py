"""The reference suite's Stage-2 parity, persistence and segment tests on the
port (infidex_tpu_torch, plain PyTorch on the CPU): tests/
test_fast_path_parity.py, test_device_pipeline_parity.py,
test_persistence_parity.py and test_segments.py.

The tests are imported, not copied, and run with their module's reference
names (``SearchEngine``, ``Document``, ``Query``, ...) bound to the port's
objects (the rebinding of tests/test_torch_entry_points.py); imports
inside a test body resolve to the port's modules too.
"""

from tests import test_device_pipeline_parity as device_pipeline
from tests import test_fast_path_parity as fast_path
from tests import test_persistence_parity as persistence
from tests import test_segments as segments
from tests.test_torch_entry_points import reference_suites_on_port

# importing test_torch_entry_points put the port on the CPU with one
# intra-op thread
_bound, test_reference_names_are_bound_to_the_port = reference_suites_on_port(
    device_pipeline, fast_path, persistence, segments,
    sys_modules=("index.segments", "index.postings_enum"))


test_device_path_matches_host_path = \
    device_pipeline.test_device_path_matches_host_path

engine = fast_path.engine
test_fast_equals_slow_batch = fast_path.test_fast_equals_slow_batch
test_fast_equals_sequential = fast_path.test_fast_equals_sequential

engines = persistence.engines


class TestPersistenceParityOnPort(persistence.TestPersistenceParity):
    pass


class TestColumnarDocPayloadOnPort(persistence.TestColumnarDocPayload):
    pass


test_index_size_at_reference_scale = \
    persistence.test_index_size_at_reference_scale
test_concurrent_searches_during_save = \
    persistence.test_concurrent_searches_during_save


class TestSegmentFileOnPort(segments.TestSegmentFile):
    pass


class TestFlushIntegrationOnPort(segments.TestFlushIntegration):
    pass


class TestBlockPostingsOnPort(segments.TestBlockPostings):
    pass

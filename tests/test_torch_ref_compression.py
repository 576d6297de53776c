"""The reference suite's compression tests (tests/test_compression.py) on the
port (infidex_tpu_torch, plain PyTorch on the CPU).

The tests are imported, not copied, and run with their module's reference
names bound to the port's objects (the rebinding of
tests/test_torch_entry_points.py); imports inside a test body resolve to
the port's modules too.
"""

from tests import test_compression as suite
from tests.test_torch_entry_points import reference_suites_on_port

# importing test_torch_entry_points put the port on the CPU with one
# intra-op thread
_bound, test_reference_names_are_bound_to_the_port = reference_suites_on_port(
    suite, sys_modules=())


TestBitSet = suite.TestBitSet
TestCompactArray = suite.TestCompactArray
TestDArray = suite.TestDArray
TestEliasFano = suite.TestEliasFano
TestGroupVarInt = suite.TestGroupVarInt
TestAutoSegmenter = suite.TestAutoSegmenter

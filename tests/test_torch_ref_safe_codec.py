"""The reference suite's safe-codec tests (tests/test_safe_codec.py) on the
port (infidex_tpu_torch, plain PyTorch on the CPU).

The tests are imported, not copied, and run with their module's reference
names bound to the port's objects (the rebinding of
tests/test_torch_entry_points.py); imports inside a test body resolve to
the port's modules too.
"""

from tests import test_safe_codec as suite
from tests.test_torch_entry_points import reference_suites_on_port

# importing test_torch_entry_points put the port on the CPU with one
# intra-op thread
_bound, test_reference_names_are_bound_to_the_port = reference_suites_on_port(
    suite, sys_modules=(
        "core.documents", "engine", "index.persistence",
        "utils.safe_codec"))


test_roundtrip_primitives = suite.test_roundtrip_primitives
test_roundtrip_nested_payload_shape = suite.test_roundtrip_nested_payload_shape
test_roundtrip_ndarray_2d_and_bool = suite.test_roundtrip_ndarray_2d_and_bool
test_surrogate_strings_roundtrip = suite.test_surrogate_strings_roundtrip
test_malformed_inputs_raise = suite.test_malformed_inputs_raise
test_object_dtype_rejected_on_encode = \
    suite.test_object_dtype_rejected_on_encode
test_disallowed_dtype_rejected_on_decode = \
    suite.test_disallowed_dtype_rejected_on_decode
test_unencodable_type_rejected = suite.test_unencodable_type_rejected
test_load_rejects_tampered_payload = suite.test_load_rejects_tampered_payload
test_string_list_fast_path_roundtrip = \
    suite.test_string_list_fast_path_roundtrip
test_string_list_tamper_detection = suite.test_string_list_tamper_detection

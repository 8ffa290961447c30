"""The benchmark's own CPU checks of the port, collected here so that the
test suite runs them.

- ``benchmark/tests/test_benchmark_faults.py``: whole runs of tiny cells
  with the timed path broken underneath (a frozen state, half of each batch
  left out, an altered answer) must come out not ``correct``, where the
  sound runs come out ``correct``;
- ``benchmark/tests/test_benchmark_controls.py``: the float8 control in the
  program's place must come out not ``correct``;
- ``benchmark/tests/test_benchmark_reference.py``: the benchmark's inputs,
  its independent reference forward and train step, and its closed-form
  FLOPs against the port.

The cases are imported by name, with the fixture they share, and stay
defined in the benchmark's files.
"""

from benchmark.tests.test_benchmark_controls import (  # noqa: F401
    test_eval_control_fails,
    test_train_control_fails,
)
from benchmark.tests.test_benchmark_faults import (  # noqa: F401
    test_eval_answer_altered,
    test_eval_sound,
    test_serve_answer_altered,
    test_serve_sound,
    test_train_half_batch,
    test_train_sound,
    test_train_state_unchanged,
)
from benchmark.tests.test_benchmark_reference import (  # noqa: F401
    fusion,
    test_closed_form_flops_equal_flop_counter,
    test_decoded_pixels_equal_the_ports,
    test_fusion_forward_equals_the_ports,
    test_inputs_equal_the_ports,
    test_text_forward_equals_the_ports,
    test_train_step_equals_the_ports,
)

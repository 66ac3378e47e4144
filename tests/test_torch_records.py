"""The stored JAX results that the port's parity tests read
(``tools/torch_test_records.py``, ``tools/_records.py``): every test module
the tool records has its record, the record holds exactly the results the
module lists in ``JAX_RECORDS``, and a stored result reads back as the JAX
package's own types."""
import importlib

import numpy as np
import pytest

from tools import _records
from tools.torch_test_records import MODULES


@pytest.mark.parametrize("name", MODULES)
def test_record_holds_every_listed_result(name):
    module = importlib.import_module(name)
    assert set(module.JAX_RECORDS), name
    assert _records.Records(name).names() == set(module.JAX_RECORDS)


def test_flatten_round_trips_namedtuples_dicts_lists_and_none():
    from ocs2_tpu.core.types import PerformanceIndex

    perf = PerformanceIndex(*(np.float32(i) for i in range(len(PerformanceIndex._fields))))
    tree = {"a": [np.arange(3), (np.float32(2.5), None)], "perf": perf, "s": np.int32(7)}
    back = _records.unflatten(_records.flatten(tree, "x"), "x")
    assert isinstance(back["perf"], PerformanceIndex) and back["perf"] == perf
    assert isinstance(back["a"], list) and isinstance(back["a"][1], tuple)
    np.testing.assert_array_equal(back["a"][0], np.arange(3))
    assert back["a"][1][1] is None and float(back["a"][1][0]) == 2.5 and int(back["s"]) == 7

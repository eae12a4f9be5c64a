"""Native C++ parser/levelizer vs the Python reference implementations."""

import numpy as np
import pytest

from oece_tpu.circuits import native
from oece_tpu.circuits.bristol import parse_bristol
from oece_tpu.circuits.netlist import levelize

from oece_tpu.harness.tb import R as REF

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built"
)


@pytest.mark.parametrize(
    "path",
    [
        "old_bristol_ckts/arith/adder_32bit.txt",
        "old_bristol_ckts/arith/mult_32x32.txt",
        "new_bristol_ckts/arith/adder64.txt",
        "new_bristol_ckts/crypto/sha256.txt",
    ],
)
def test_native_parse_matches_python(path):
    nl_py = parse_bristol(f"{REF}/{path}")
    nl_c = native.parse_bristol_native(f"{REF}/{path}")
    assert nl_c is not None
    assert nl_c.n_wires == nl_py.n_wires
    assert np.array_equal(nl_c.op, nl_py.op)
    assert np.array_equal(nl_c.in0, nl_py.in0)
    assert np.array_equal(nl_c.in1, nl_py.in1)
    assert np.array_equal(nl_c.out, nl_py.out)
    assert [list(a) for a in nl_c.inputs] == [list(a) for a in nl_py.inputs]
    assert [list(a) for a in nl_c.outputs] == [list(a) for a in nl_py.outputs]


def test_native_levelize_used_and_consistent():
    nl = parse_bristol(f"{REF}/new_bristol_ckts/crypto/sha256.txt")
    lv_native = native.levelize_native(nl)
    assert lv_native is not None
    plan = levelize(nl)  # uses native automatically
    s = plan.stats()
    assert s["depth"] == 3919 and s["bootstrap_gates"] == 124920

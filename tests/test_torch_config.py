"""The port's ``.info`` config loader (``ocs2_tpu_torch/utils/config.py``) vs
the JAX package's (``ocs2_tpu/utils/config.py``), on the CPU.

The twins of ``tests/test_components.py::TestConfig``: the same text goes
through both parsers, and the trees, the settings dataclasses they fill, the
matrices and the key mapping must be equal (exact: the grammar is plain
Python, and the matrices are the same float32 products).
"""
import dataclasses

import numpy as np
import pytest
import torch

from ocs2_tpu.solvers import sqp as jsqp
from ocs2_tpu.utils import config as jconfig

from ocs2_tpu_torch.mpc import mpc
from ocs2_tpu_torch.solvers import ddp, sqp
from ocs2_tpu_torch.utils import config

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

INFO = """
; task file in the reference .info grammar
mpc
{
  timeHorizon        2.5
  numIntervals       32
  coldStart          true
  solver             sqp
}
sqp
{
  maxIterations      7
  integrator         rk4
  armijoFactor       1e-3
}
ddp
{
  algorithm          slq
  maxIterations      15
  minRelCost         1e-5   ; a trailing comment
  useFeedbackPolicy  false
}
Q
{
  scaling 2e0
  (0,0) 1.0
  (1,1) 3.0
}
x_init
{
  (0) 0.5
  (1) -0.5
}
nested
{
  inner
  {
    value  "quoted"   # another comment style
    flag   yes
  }
  empty
}
"""


def test_parse_info_matches_jax():
    tree = config.parse_info(INFO)
    assert tree == jconfig.parse_info(INFO)
    assert tree["nested"]["inner"]["value"] == "quoted" and tree["nested"]["empty"] == ""


def test_load_settings_fills_the_ports_sqp_settings_as_jax_fills_its_own():
    st = config.load_settings(config.parse_info(INFO), "sqp", sqp.SqpSettings)
    ref = jconfig.load_settings(jconfig.parse_info(INFO), "sqp", jsqp.SqpSettings)
    assert st.max_iterations == 7 and st.integrator == "rk4"
    assert abs(st.armijo_factor - 1e-3) < 1e-12
    # Unlisted fields keep the port's defaults.
    assert st.num_alphas == sqp.SqpSettings().num_alphas
    shared = {f.name for f in dataclasses.fields(sqp.SqpSettings)} & {
        f.name for f in dataclasses.fields(jsqp.SqpSettings)}
    for name in shared:
        assert getattr(st, name) == getattr(ref, name), name


@pytest.mark.parametrize("prefix, cls, want", [
    ("ddp", ddp.DdpSettings, dict(algorithm="slq", max_iterations=15, min_rel_cost=1e-5,
                                  use_feedback_policy=False)),
    ("mpc", mpc.MpcSettings, dict(time_horizon=2.5, num_intervals=32, cold_start=True,
                                  solver="sqp")),
])
def test_load_settings_coerces_each_field_type(prefix, cls, want):
    st = config.load_settings(config.parse_info(INFO), prefix, cls)
    for name, value in want.items():
        got = getattr(st, name)
        assert got == value and type(got) is type(value), (name, got)


def test_load_settings_overrides_win():
    st = config.load_settings(config.parse_info(INFO), "sqp", sqp.SqpSettings, max_iterations=3)
    assert st.max_iterations == 3 and st.integrator == "rk4"
    assert config.load_settings({}, "missing", sqp.SqpSettings) == sqp.SqpSettings()


def test_matrices_and_vectors_match_jax():
    tree = config.parse_info(INFO)
    q = config.load_matrix(tree, "Q", (2, 2), device="cpu")
    assert q.dtype == torch.float32 and q.device.type == "cpu"
    np.testing.assert_array_equal(q.numpy(), [[2.0, 0.0], [0.0, 6.0]])
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(jconfig.load_matrix(jconfig.parse_info(INFO), "Q", (2, 2))))
    v = config.load_matrix(tree, "x_init", (2,), device="cpu")
    np.testing.assert_array_equal(v.numpy(), [0.5, -0.5])
    with pytest.raises(KeyError, match="R"):
        config.load_matrix(tree, "R", (2, 2), device="cpu")


def test_scalars_and_bools_match_jax():
    tree, jtree = config.parse_info(INFO), jconfig.parse_info(INFO)
    for dotted, default in (("mpc.timeHorizon", 0.0), ("mpc.missing", 4.0)):
        assert config.load_scalar(tree, dotted, default) == jconfig.load_scalar(
            jtree, dotted, default)
    for dotted, default in (("mpc.coldStart", False), ("nested.inner.flag", False),
                            ("ddp.useFeedbackPolicy", True), ("mpc.missing", True)):
        assert config.load_bool(tree, dotted, default) == jconfig.load_bool(
            jtree, dotted, default), dotted
    assert config.get_path(tree, "nested.inner.value") == "quoted"
    assert config.get_path(tree, "nested.nothing.here", 7) == 7


def test_load_info_reads_a_file(tmp_path):
    path = tmp_path / "task.info"
    path.write_text(INFO)
    assert config.load_info(str(path)) == jconfig.load_info(str(path))


@pytest.mark.parametrize("name", ["timeHorizon", "useFeedbackPolicy", "maxIterations", "x",
                                  "numFilters", "Filter0", "rk4Substeps"])
def test_camel_to_snake_matches_jax(name):
    assert config.camel_to_snake(name) == jconfig.camel_to_snake(name)


def test_camel_to_snake():
    assert config.camel_to_snake("timeHorizon") == "time_horizon"
    assert config.camel_to_snake("useFeedbackPolicy") == "use_feedback_policy"


def test_load_matrix_defaults_to_the_card():
    import inspect

    assert inspect.signature(config.load_matrix).parameters["device"].default == "cuda"

"""One SSL step of the port against the JAX package's ``make_ssl_step``
for two settings of the knobs, on the CPU: the pruned default (the
teacher on the unlabeled scene alone, its plain forward, the student's
jittered copies for the labeled scene only) and ``exact_jitter`` (the
teacher's jittered forward, jittered copies of every student scene).
tests/test_torch_ssl_teacher.py holds ``full_teacher``. Inputs and bounds
are those of tests/test_torch_ssl_step.py (see its docstring), held by
tests/torch_ssl_cases.py::check_one_step; each JAX step compiles on its
own for 20-40 s, so the settings are spread over files.
"""
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from tests import torch_ssl_cases as C  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    return C.make_setup()


@pytest.mark.parametrize("knobs", ["pruned", "exact_jitter"])
def test_ssl_step_knobs_match_jax(setup, knobs):
    C.check_one_step(setup, knobs)

"""One SSL step of the port against the JAX package's ``make_ssl_step``
with ``full_teacher``, on the CPU: the teacher runs its plain forward on
every scene of the batch, labeled ones included, with view-stats on.
Inputs and bounds are those of tests/test_torch_ssl_step.py (see its
docstring), held by tests/torch_ssl_cases.py::check_one_step.
"""
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from tests import torch_ssl_cases as C  # noqa: E402

torch.set_num_threads(1)


def test_ssl_step_full_teacher_matches_jax():
    C.check_one_step(C.make_setup(), "full_teacher")

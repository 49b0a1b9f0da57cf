"""A module-scoped autouse fixture that runs a test module's torch work
on one intra-op thread; a module takes it with

    from torch_threads import one_intra_op_thread  # noqa: F401

The suite runs its modules in several worker processes side by side on
one host. There torch's OpenMP regions, one for each small op, wait on
threads that have no core, and a module of small ops takes two to three
times as long as on one thread. The fixture changes no assertion, case
or tolerance; the reference side (JAX) does not read torch's count."""
import pytest
import torch


@pytest.fixture(scope='module', autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

import pytest


@pytest.fixture(autouse=True)
def few_threads():
    """Torch on two threads: the tests share the machine."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

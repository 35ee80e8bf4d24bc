"""The card fixture of the benchmark's own tests."""
import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture
def card():
    """Skips a test that needs a CUDA card where there is none; the look
    happens here, never while a module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)

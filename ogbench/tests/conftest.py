"""Shared fixtures of the benchmark's tests: small scenes on the CPU, and
the `gpu` marker's check, made inside a fixture."""

import pytest
import torch

# a few threads per process: the tests run under several workers
torch.set_num_threads(2)

# the tests' size of every cell: scene sizes and mix settings
SMALL = dict(splats=3000, width=160, height=120, views=4)
SMALL_MIX = dict(chunk_steps=2, warmup_steps=1, gap_steps=1)


@pytest.fixture
def small(monkeypatch):
    """Every cell that ogbench.run loads, at the tests' size."""
    from ogbench import run

    load = run.load_cell

    def load_small(name, root=run.ROOT):
        cell = load(name, root)
        cell["config"]["scene"].update(SMALL)
        cell["traffic"].update(SMALL_MIX)
        return cell

    monkeypatch.setattr(run, "load_cell", load_small)


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")

"""Shared pieces of the benchmark's tests: a small cell that the CPU can
run in seconds, and the fixture that decides whether a card is there."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    """The CUDA device, or a skip where this machine has none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def small_cell(name: str = "p8_720p.texture", width: int = 128,
               height: int = 64, chunk: int = 12, quality: int = 3):
    """A cell of BENCHMARK.json, with its own limits, cut to a clip the
    CPU encodes in seconds."""
    from benchmark.harness.manifest import load_cell

    cell = load_cell(name)
    cell.config = dict(cell.config, settings=dict(
        cell.config["settings"], source_width=width, source_height=height))
    cell.traffic = dict(cell.traffic, chunk_frames=chunk,
                        quality_frames=quality)
    return cell

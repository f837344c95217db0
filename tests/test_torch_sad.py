"""The port's plain sad_lattice (svt_av1_psyex_tpu_torch/ops/sad_ref.py)
against the JAX package's Pallas kernel (svt_av1_psyex_tpu/ops/pallas/
sad.py), run as tests/test_pallas.py runs it on the CPU: in interpret
mode. The lattice is integer, so the two must agree bit for bit, at 8
bits and at 10 bits up to 1023."""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from svt_av1_psyex_tpu.ops.pallas.sad import sad_lattice  # noqa: E402
from svt_av1_psyex_tpu_torch.ops.sad_ref import NOFF, sad_lattice_ref  # noqa: E402


def inputs(nsb: int, bit_depth: int, seed: int):
    rng = np.random.RandomState(seed)
    hi = (1 << bit_depth) - 1
    tiles = rng.randint(0, hi + 1, (nsb, 64, 64)).astype(np.int32)
    wins = rng.randint(0, hi + 1, (nsb, 80, 80)).astype(np.int32)
    # the extremes: a box of max samples against a window of zeros
    tiles[0, :8, :8] = hi
    wins[0, :, :] = np.where(np.arange(80)[None, :] < 40, 0, wins[0])
    return tiles, wins


@pytest.mark.parametrize("bit_depth", [8, 10])
@pytest.mark.parametrize("nsb", [1, 3])
def test_plain_equals_pallas_interpret(nsb, bit_depth):
    tiles, wins = inputs(nsb, bit_depth, seed=nsb * 10 + bit_depth)
    want = np.asarray(sad_lattice(jnp.asarray(tiles), jnp.asarray(wins)))
    got = sad_lattice_ref(torch.from_numpy(tiles), torch.from_numpy(wins))
    assert got.dtype == torch.int32 and got.shape == (nsb, NOFF, 8, 8)
    assert np.array_equal(got.numpy(), want)
    if bit_depth == 10:
        assert got.max().item() == 64 * 1023    # offset (0, 0), box (0, 0)

"""The port's multi-device layout (svt_av1_psyex_tpu_torch/parallel/):
frames over dp, superblock rows over sp.

On the CPU every shard of a mesh is a CPU device, and the sharded
analysis runs the same torch functions on each shard's rows (with the
row above them, and for inter frames a reference slab) as the unsharded
call does on the whole frame. So:

* the sharded packed rows of intra_analysis_batch and inter_analysis
  equal the unsharded rows bit for bit, floats included, on even and
  uneven splits, at 8 and 10 bits, with psy on;
* the port's sharded streams equal its unsharded streams and the JAX
  package's streams under the matching jax.sharding.Mesh, byte for byte
  (a p12 keyframe group under (2, 2); a p6 keyframe + mini-GOP with 9 px
  of vertical motion per frame under (1, 4) and (1, 2));
* the port's dryrun_multichip(4, device="cpu") passes;
* a mesh that names CUDA devices where there is none raises.

The JAX side runs on the repository conftest's 8 virtual CPU devices;
the test marked cuda, which needs no JAX, runs on the card."""

import sys
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from svt_av1_psyex_tpu_torch.device import inter as port_inter  # noqa: E402
from svt_av1_psyex_tpu_torch.device import intra as port_intra  # noqa: E402
from svt_av1_psyex_tpu_torch.device.me import REACH, SLAB  # noqa: E402
from svt_av1_psyex_tpu_torch.parallel.mesh import (  # noqa: E402
    DeviceMesh,
    ShardedRows,
    split,
)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch ops (test files run
    in parallel worker processes; see tests/test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(shape):
    return DeviceMesh.spread(shape, "cpu")


def jax_mesh(shape):
    jax = pytest.importorskip("jax")
    from jax.sharding import Mesh

    n = shape[0] * shape[1]
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), ("dp", "sp"))


def smooth(rng, shape, maxv):
    """A smoothed random texture: blocks with a clean SAD basin."""
    a = rng.integers(0, maxv + 1, shape).astype(np.int64)
    for _ in range(3):
        a = (a + np.roll(a, 1, -1) + np.roll(a, 1, -2)
             + np.roll(a, (1, 1), (-2, -1))) // 4
    return a


# ---- the mesh itself ------------------------------------------------------

def test_split_is_contiguous_and_uneven_where_it_must_be():
    assert split(17, 2) == [(0, 9), (9, 17)]         # 1080p over sp = 2
    assert split(12, 4) == [(0, 3), (3, 6), (6, 9), (9, 12)]
    assert split(3, 2) == [(0, 2), (2, 3)]
    assert split(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]
    assert SLAB >= REACH == 296 and SLAB % 16 == 0


def test_mesh_layout_and_placement():
    mesh = cpu_mesh((2, 3))
    assert mesh.shape == (2, 3) and mesh.axis_names == ("dp", "sp")
    assert mesh.device(1, 2) == torch.device("cpu")
    assert mesh.placement() == {"cpu": 6}
    with pytest.raises(ValueError, match="needs 4 devices"):
        DeviceMesh(["cpu"] * 3, (2, 2))


def test_cuda_mesh_raises_without_a_card():
    """A mesh never falls back to the CPU: naming CUDA devices where
    there is no card raises, and so does an encoder whose device is not
    its mesh's first."""
    from svt_av1_psyex_tpu_torch.codec.encoder import Av1Encoder, SequenceConfig

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceMesh(["cuda:0"] * 4, (2, 2))
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceMesh.spread((2, 2), "cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        Av1Encoder(SequenceConfig(width=64, height=64), preset=12,
                   mesh=cpu_mesh((1, 2)))
    mesh = DeviceMesh([torch.device("cpu")] * 2, (1, 2))
    enc = Av1Encoder(SequenceConfig(width=64, height=64), preset=12,
                     device="cpu", mesh=mesh)
    assert enc.mesh is mesh


def test_encoder_mesh_is_one_shard_by_default_and_starts_on_its_device():
    """Without a mesh the encoder's analysis runs over the (1, 1) mesh on
    its device: one shard, the whole batch. A mesh given to the encoder,
    or to one encode_keyframes call, must start on the encoder's
    device."""
    from types import SimpleNamespace

    from svt_av1_psyex_tpu_torch.codec.encoder import Av1Encoder, SequenceConfig

    seq = SequenceConfig(width=64, height=64)
    enc = Av1Encoder(seq, preset=12, device="cpu")
    assert enc.mesh.shape == (1, 1)
    assert enc.mesh.devices == [torch.device("cpu")]
    elsewhere = SimpleNamespace(first=torch.device("meta"))
    with pytest.raises(ValueError, match="the mesh starts on meta"):
        Av1Encoder(seq, preset=12, device="cpu", mesh=elsewhere)
    frames = [list(f) for f in blobs(64, 64, 2)]
    with pytest.raises(ValueError, match="the mesh starts on meta"):
        enc.encode_keyframes(frames, 140, mesh=elsewhere)
    with pytest.raises(ValueError, match="the mesh starts on meta"):
        enc.encode_keyframes(frames[:1], 140, mesh=elsewhere)


def test_sharded_rows_reassemble_fields_and_frames():
    """Two fields, (1, 2) and (2, 1) blocks per superblock row, 3 rows of
    2 frames in three shards: the unsharded raster comes back."""
    fields = [(1, 2), (2, 1)]
    full = np.arange(2 * (3 * 2 + 6), dtype=np.float32).reshape(2, 12)

    def part(f0, f1, r0, r1):
        a = full[f0:f1, :6].reshape(f1 - f0, 3, 2)[:, r0:r1]
        b = full[f0:f1, 6:].reshape(f1 - f0, 6, 1)[:, 2 * r0:2 * r1]
        return torch.from_numpy(np.concatenate(
            [a.reshape(f1 - f0, -1), b.reshape(f1 - f0, -1)], axis=1))

    shards = [((0, 1), (0, 2), part(0, 1, 0, 2)),
              ((0, 1), (2, 3), part(0, 1, 2, 3)),
              ((1, 2), (0, 3), part(1, 2, 0, 3))]
    assert np.array_equal(ShardedRows(shards, fields, 2, 3).numpy(), full)


# ---- packed analysis rows: sharded == unsharded, bit for bit ---------------

RD_INTRA = [1000, 200, 900, 600, 1100, 1100, 1500, 1700, 1700, 1600]
RD_INTER = np.concatenate([
    RD_INTRA, [1900, 2050] + [1 << 28] * 6, [1400, 1550] + [1 << 28] * 6,
    [3500, 2900], [77]]).astype(np.int32)


@pytest.mark.parametrize("bd", [8, 10])
def test_intra_rows_sharded_equal_unsharded(bd):
    """3 frames of 192x320 (3 superblock rows) over (2, 2): 2 + 1 frames,
    2 + 1 rows; psy on; one frame with another qindex (two fullloop
    launches per shard and depth)."""
    rng = np.random.default_rng(3 + bd)
    maxv = (1 << bd) - 1
    lumas = smooth(rng, (3, 192, 320), maxv).astype(
        np.uint8 if bd == 8 else np.uint16)
    qps = np.stack([port_intra.qp_row_for(q, 0, 0, bd)
                    for q in (120, 120, 160)])
    rds = np.broadcast_to(np.array(RD_INTRA + [77], np.int32), (3, 11))
    want = port_intra.intra_analysis_batch(
        torch.from_numpy(lumas.astype(np.int32)), qps, rds, bit_depth=bd,
        psy=True).numpy()
    for shape in ((2, 2), (1, 3), (3, 1)):
        got = port_intra.intra_analysis_sharded(
            lumas, qps, rds, cpu_mesh(shape), bit_depth=bd, psy=True)
        assert len(got.shards) == {(2, 2): 4, (1, 3): 3, (3, 1): 3}[shape]
        assert np.array_equal(got.numpy(), want), shape


def moving_planes(rng, h, w, maxv):
    """A src and two refs of one textured scene: the refs 40 rows above
    and 50 rows below (motion across several superblock rows), so that
    the winning motion vectors cross shard edges."""
    big = smooth(rng, (h + 200, w + 64), maxv)
    src = big[100:100 + h, 32:32 + w]
    refs = np.stack([big[60:60 + h, 30:30 + w], big[150:150 + h, 35:35 + w]])
    return src.astype(np.int32), refs.astype(np.int32)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("h,w,sps", [(192, 320, (2,)), (576, 128, (3, 4))],
                         ids=["3rows-320w", "9rows-128w"])
def test_inter_rows_sharded_equal_unsharded(bd, h, w, sps):
    """The fused inter analysis with 2 refs (compound on), psy on, over
    sp = 2 on 3 superblock rows (2 + 1), and over sp = 3 and 4 on 9 rows,
    where the reference slabs are clipped inside the frame (shards start
    below SLAB)."""
    rng = np.random.default_rng(7 + bd)
    src, refs = moving_planes(rng, h, w, (1 << bd) - 1)
    qp = port_intra.qp_row_for(120, 0, 0, bd)
    want = port_inter.inter_analysis(
        torch.from_numpy(src), torch.from_numpy(refs), qp, RD_INTER,
        bit_depth=bd, psy=True).numpy()
    u = port_inter.unpack_inter_analysis(want, h, w)
    assert np.abs(u[64]["mv_y"]).max() > 32              # crosses shards
    assert set(np.unique(u[8]["cand"])) & {port_inter.CAND_COMP_NEW,
                                          port_inter.CAND_COMP_ZERO}
    for sp in sps:
        got = port_inter.inter_analysis_sharded(
            src, refs, qp, RD_INTER, cpu_mesh((1, sp)), bit_depth=bd,
            psy=True).numpy()
        assert got.shape == (1, want.size)
        assert np.array_equal(got[0], want), sp


# ---- streams: the port sharded == unsharded == the JAX package sharded -----

def blobs(w, h, n):
    from mkclip import synth_frame

    from svt_av1_psyex_tpu_torch.streams import VideoFormat

    fmt = VideoFormat(w, h, fps=Fraction(30, 1))
    return [synth_frame(fmt, t, "blobs") for t in range(n)]


def test_keyframe_group_streams_match_unsharded_and_jax():
    """2 frames of 128x256 at p12, q140 under a (2, 2) mesh: one frame
    per dp shard, two superblock rows per sp shard."""
    mesh_j = jax_mesh((2, 2))
    from svt_av1_psyex_tpu.codec.encoder import Av1Encoder as JaxEncoder
    from svt_av1_psyex_tpu.codec.encoder import SequenceConfig as JaxSeq

    from svt_av1_psyex_tpu_torch.codec.encoder import Av1Encoder, SequenceConfig

    w, h = 128, 256
    frames = blobs(w, h, 2)

    def port(mesh):
        enc = Av1Encoder(SequenceConfig(width=w, height=h), preset=12,
                         device="cpu", mesh=mesh)
        return enc.encode_keyframes([list(f) for f in frames], 140)

    sharded = port(cpu_mesh((2, 2)))
    assert len(sharded) == 2 and all(sharded)
    assert sharded == port(None)
    ref = JaxEncoder(JaxSeq(width=w, height=h), preset=12).encode_keyframes(
        [list(f) for f in frames], 140, mesh=mesh_j)
    assert sharded == ref


def gop_frames(n=3, w=256, h=256, motion=9):
    """A textured scene moving `motion` rows per frame; chroma from the
    same scene at half size."""
    rng = np.random.default_rng(11)
    big = smooth(rng, (h + motion * n, w), 255)
    out = []
    for t in range(n):
        y = big[motion * t: motion * t + h].astype(np.uint8)
        c = y[::2, ::2] // 2 + 64
        out.append([y, c.copy(), (255 - c).astype(np.uint8)])
    return out


def encode_gop(enc, frames, plan_minigop):
    """KF + plan_minigop(0, 1, 2, future_slot=1) at q110, as the JAX
    package's dryrun_multichip drives it; `enc` and `plan_minigop` of
    either package."""
    tus = [enc.encode_keyframe([p.copy() for p in frames[0]], 110)]
    for pl in plan_minigop(0, 1, 2, future_slot=1):
        src = frames[pl.disp_idx] if pl.show_existing_slot is None else None
        tus.append(enc.encode_frame([p.copy() for p in src] if src else None,
                                    110, plan=pl))
    return tus


@pytest.fixture(scope="module")
def gop_unsharded():
    from svt_av1_psyex_tpu_torch.codec.encoder import Av1Encoder, SequenceConfig
    from svt_av1_psyex_tpu_torch.codec.gop import plan_minigop

    enc = Av1Encoder(SequenceConfig(width=256, height=256), preset=6,
                     device="cpu")
    return encode_gop(enc, gop_frames(), plan_minigop)


@pytest.mark.parametrize("sp", [4, 2])
def test_p6_gop_streams_match_unsharded_and_jax(sp, gop_unsharded):
    """A p6 keyframe + 2-frame mini-GOP at 256x256 with 9 px of vertical
    motion per frame under a (1, sp) mesh (sp = 4: one superblock row per
    shard): the keyframe's and both inter frames' analyses are sharded."""
    mesh_j = jax_mesh((1, sp))
    from svt_av1_psyex_tpu.codec.encoder import Av1Encoder as JaxEncoder
    from svt_av1_psyex_tpu.codec.encoder import SequenceConfig as JaxSeq
    from svt_av1_psyex_tpu.codec.gop import plan_minigop as jax_plans

    from svt_av1_psyex_tpu_torch.codec.encoder import Av1Encoder, SequenceConfig
    from svt_av1_psyex_tpu_torch.codec.gop import plan_minigop
    from svt_av1_psyex_tpu_torch.codec.md_device import DeviceInterMD

    frames = gop_frames()
    mesh = cpu_mesh((1, sp))
    dispatched = []

    class Recording(Av1Encoder):
        def _begin_frame_impl(self, *a, **k):
            st = super()._begin_frame_impl(*a, **k)
            if isinstance(st, dict) and st["dmd"] is not None:
                dispatched.append(st["dmd"])
            return st

    enc = Recording(SequenceConfig(width=256, height=256), preset=6,
                    device="cpu")
    enc.mesh = mesh
    sharded = encode_gop(enc, frames, plan_minigop)
    assert len(sharded) == 4 and all(sharded)
    assert len(dispatched) == 3 and all(d.mesh is mesh for d in dispatched)
    assert sum(isinstance(d, DeviceInterMD) for d in dispatched) == 2
    assert sharded == gop_unsharded
    jenc = JaxEncoder(JaxSeq(width=256, height=256), preset=6)
    jenc.mesh = mesh_j
    assert sharded == encode_gop(jenc, frames, jax_plans)


def test_dryrun_multichip_on_cpu(capsys):
    from svt_av1_psyex_tpu_torch.parallel.dryrun import (
        dryrun_multichip,
        mesh_shape,
    )

    assert [mesh_shape(n) for n in (1, 2, 3, 4, 8)] == [
        (1, 1), (2, 1), (3, 1), (2, 2), (4, 2)]
    out = dryrun_multichip(4, device="cpu")
    assert out["mesh"] == (2, 2) and out["placement"] == {"cpu": 4}
    assert out["keyframes"] == 2 and out["gop_tus"] == 4
    printed = capsys.readouterr().out
    assert printed.count("TUs identical to the unsharded encode") == 2


@pytest.fixture
def cuda_device():
    from svt_av1_psyex_tpu_torch.runtime import resolve_device

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return resolve_device("cuda")


@pytest.mark.cuda
def test_sharded_rows_on_card_launch_per_shard(cuda_device):
    """On the card each kernel launches once per shard where the
    unsharded call launches it once. Shards of a few superblocks (intra:
    2 frames x 5 superblocks; inter: a 576x128 frame over sp = 3, 2 x 3
    superblocks) keep every mode, candidate and motion vector of the
    unsharded rows; a J may move in its last bits, since there cuBLAS's
    sgemm, the batched 8x8 psy Hadamard and torch's sums of few blocks
    answer by the batch size (parallel/mesh.py). Prints how many Js
    moved at each depth."""
    from svt_av1_psyex_tpu_torch.ops.cuda import fullloop as cuda_fullloop
    from svt_av1_psyex_tpu_torch.ops.cuda import sad as cuda_sad

    def counted(fn):
        cuda_fullloop.launches = cuda_sad.launches = 0
        out = fn()
        return out, (cuda_fullloop.launches, cuda_sad.launches)

    def held(tag, want, got):
        moved = {}
        for blk in want:
            for f, a in want[blk].items():
                if f == "j":
                    assert np.allclose(got[blk][f], a, rtol=1e-6, atol=0), \
                        (tag, blk)
                    moved[blk] = int(np.sum(got[blk][f] != a))
                else:
                    assert np.array_equal(got[blk][f], a), (tag, blk, f)
        print(f"{tag}: Js moved per depth {moved}")

    mesh = DeviceMesh.spread((1, 3), cuda_device)
    rng = np.random.default_rng(5)
    lumas = smooth(rng, (2, 192, 320), 255).astype(np.uint8)
    qps = np.broadcast_to(port_intra.qp_row_for(120, 0, 0, 8), (2, 10))
    rds = np.broadcast_to(np.array(RD_INTRA + [77], np.int32), (2, 11))
    want, n1 = counted(lambda: port_intra.intra_analysis_batch(
        torch.from_numpy(lumas).to(cuda_device), qps, rds,
        psy=True).cpu().numpy())
    got, nm = counted(lambda: port_intra.intra_analysis_sharded(
        lumas, qps, rds, mesh, psy=True).numpy())
    for f in range(2):
        held(f"intra frame {f}",
             port_intra.unpack_rd_analysis(want[f], 192, 320),
             port_intra.unpack_rd_analysis(got[f], 192, 320))
    assert n1[0] > 0 and nm == (n1[0] * 3, 0)
    src, refs = moving_planes(rng, 576, 128, 255)
    qp = port_intra.qp_row_for(120, 0, 0, 8)
    want, n1 = counted(lambda: port_inter.inter_analysis(
        torch.from_numpy(src).to(cuda_device),
        torch.from_numpy(refs).to(cuda_device), qp, RD_INTER,
        psy=True).cpu().numpy())
    got, nm = counted(lambda: port_inter.inter_analysis_sharded(
        src, refs, qp, RD_INTER, mesh, psy=True).numpy())
    held("inter", port_inter.unpack_inter_analysis(want, 576, 128),
         port_inter.unpack_inter_analysis(got[0], 576, 128))
    assert min(n1) > 0 and nm == (n1[0] * 3, n1[1] * 3)

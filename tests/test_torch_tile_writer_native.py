"""The port's C superblock writer (native/tilewriter.c, reached through
TileWriter._write_sb_native) against the Python walk of
bitstream/tile_writer.py, which it replaces superblock by superblock.

Two kinds of check, each superblock compared on its own:
- encodes through the port's SvtAv1Encoder on the CPU, once with the C
  writer and once with the Python walk only (TileWriter._native_setup
  patched to decline): the benchmark cells' configurations in miniature
  (8-bit preset-8 "texture" and 10-bit preset-6 "blobs" with loop
  restoration, each a keyframe and one 4-frame mini-GOP, at a size that
  is not a multiple of 64), two tile columns, and a screen-content clip
  whose palette leaves send their superblocks to the Python walk;
- random superblocks of every partition type and every mode-info syntax
  element the C writer codes (filter intra, CfL, inter-intra, masked and
  distance-weighted compound, OBMC and local warp, global motion, delta q,
  segment ids, vartx), coded by both walks in lockstep.
After each superblock the coded bytes, the writer's neighbour grids, the
coefficient contexts, the MiState grids, every CDF row and counter and
the running delta-q index must be the same."""

import hashlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmark.harness.frames import FrameSource  # noqa: E402
from svt_av1_psyex_tpu_torch.bitstream import tile_writer as TW  # noqa: E402
from svt_av1_psyex_tpu_torch.native import ecenc  # noqa: E402

if ecenc.get_lib() is None:
    pytest.skip("the native host tier did not build (gcc)",
                allow_module_level=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: test files run in parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(tw) -> str:
    """Digest of everything a superblock's coding reads or changes."""
    h = hashlib.sha1(tw.enc.done())
    cw = tw.coeff_writer
    for a in (tw.y_modes, tw.skips, tw.inters, tw.flt, tw.ref0g, tw.ref1g,
              tw.cgig, tw.cpig, tw.pal_size, tw.above_part, tw.left_part,
              tw.txi_above, tw.txi_left, tw.txp_above, tw.txp_left,
              tw._seg_map, *cw.above, *cw.left):
        h.update(a.tobytes())
    if tw.mi_state is not None:
        for g in tw.mi_state._GRIDS:
            h.update(getattr(tw.mi_state, g).tobytes())
    for _, fam in sorted(tw.cdfs.__dict__.items()):
        rows = fam.values() if isinstance(fam, dict) else [fam]
        for r in rows:
            if isinstance(r, list):
                h.update(r[0].tobytes())
                h.update(r[1].tobytes())
    h.update(str(tw.prev_qindex).encode())
    return h.hexdigest()


# ---- encodes -----------------------------------------------------------------
def _sc_frames(w, h, n):
    """Flat fields with thin bars (tests/test_palette.py's screen
    content), moving 2 px a frame."""
    rng = np.random.default_rng(0)
    y = np.full((h, w), 32, np.uint8)
    y[0 : h // 2, :] = 200
    for _ in range(12):
        r0, c0 = rng.integers(0, min(w, h) - 24, 2)
        y[r0 : r0 + 3, c0 : c0 + 24] = 90
        y[r0 : r0 + 20, c0 : c0 + 2] = 140
    planes = [y, np.full((h // 2, w // 2), 110, np.uint8),
              np.full((h // 2, w // 2), 140, np.uint8)]
    return [[np.roll(p, 2 * t, axis=1) for p in planes] for t in range(n)]


# name: (content, width, height, bit depth, preset, frames, log2 tile
# columns, screen content mode)
CASES = {
    "p8_texture": ("texture", 200, 136, 8, 8, 5, 0, 0),
    "p6_blobs10": ("blobs", 200, 136, 10, 6, 5, 0, 0),
    "p8_two_tiles": ("texture", 136, 64, 8, 8, 1, 1, 0),
    "p8_screen": ("screen", 128, 64, 8, 8, 2, 0, 1),
}


def _encode(case, native: bool):
    """(TUs, a state digest after each superblock, the stage clock's
    timing) of one encode through SvtAv1Encoder with the stage clock on,
    the C writer allowed or declined."""
    from svt_av1_psyex_tpu_torch.api.encoder import SvtAv1Encoder

    kind, w, h, bd, preset, n, tiles, sc = CASES[case]
    if kind == "screen":
        frames = _sc_frames(w, h, n)
    else:
        src = FrameSource(kind, w, h, bd, 2111111119, "cpu", span=n)
        frames = [src.frame(t) for t in range(n)]
    states = []
    write = TW.TileWriter.write_superblock
    setup = TW.TileWriter._native_setup

    def spy(self, node, r, c):
        write(self, node, r, c)
        states.append(_state(self))

    saved = os.environ.get("SVT_TPU_TIMING")
    os.environ["SVT_TPU_TIMING"] = "1"
    TW.TileWriter.write_superblock = spy
    if not native:
        TW.TileWriter._native_setup = lambda self: False
    try:
        api = SvtAv1Encoder(device="cpu")
        cfg = api.config
        cfg.source_width, cfg.source_height = w, h
        cfg.encoder_bit_depth = bd
        cfg.enc_mode, cfg.crf, cfg.hierarchical_levels = preset, 30, 2
        cfg.frame_rate_numerator, cfg.frame_rate_denominator = 30, 1
        cfg.tile_columns, cfg.screen_content_mode = tiles, sc
        api.init()
        for t, f in enumerate(frames):
            api.send_picture([p.copy() for p in f], t)
        api.send_picture(None)
        tus = []
        while (pkt := api.get_packet()) is not None:
            if not pkt.is_eos:
                tus.append(pkt.data)
        return tus, states, dict(api._enc.timing)
    finally:
        TW.TileWriter.write_superblock = write
        TW.TileWriter._native_setup = setup
        if saved is None:
            os.environ.pop("SVT_TPU_TIMING", None)
        else:
            os.environ["SVT_TPU_TIMING"] = saved


_RUNS: dict = {}


def _runs(case):
    if case not in _RUNS:
        _RUNS[case] = (_encode(case, True), _encode(case, False))
    return _RUNS[case]


@pytest.mark.parametrize("case", list(CASES))
def test_streams_and_state_are_those_of_the_python_walk(case):
    (tus, states, _), (py_tus, py_states, _) = _runs(case)
    assert tus == py_tus
    assert len(states) == len(py_states) > 0
    for i, (a, b) in enumerate(zip(states, py_states)):
        assert a == b, f"superblock {i} of the encode"


@pytest.mark.parametrize("case", list(CASES))
def test_the_clock_counts_the_superblocks_each_walk_wrote(case):
    """n.ec_sbs and n.ec_sbs_native on the stage clock: every superblock
    of the cell-like encodes through C (a C build that failed would read
    below 1), the palette superblocks of the screen content through
    Python, none through C when it is declined."""
    (_, states, timing), (_, _, py_timing) = _runs(case)
    assert timing["n.ec_sbs"] == py_timing["n.ec_sbs"] == len(states)
    assert py_timing["n.ec_sbs_native"] == 0
    share = timing["n.ec_sbs_native"] / timing["n.ec_sbs"]
    if case == "p8_screen":
        assert 0 < share < 1.0
    else:
        assert share == 1.0
    assert timing["n.ec_symbols"] == py_timing["n.ec_symbols"]
    assert timing["n.ec_calls"] < py_timing["n.ec_calls"]


# ---- random superblocks --------------------------------------------------------
MI_ROWS, MI_COLS = 34, 50   # 136 x 200: partial superblocks at both edges


def _frame(intra: bool):
    from svt_av1_psyex_tpu_torch.bitstream.headers import (
        FrameConfig, SequenceConfig)

    seq = SequenceConfig(width=MI_COLS * 4, height=MI_ROWS * 4,
                         enable_filter_intra=True,
                         enable_interintra_compound=True,
                         enable_masked_compound=True,
                         enable_warped_motion=True, enable_jnt_comp=True)
    gm = (None, (1, (-3000, 5000, 65536, 0, 0, 65536)),
          (2, (40000, -20000, 66000, 700, -700, 66000)),
          (3, (-9000, 12000, 65000, -300, 900, 67000)), None,
          (1, (8192, -8192, 65536, 0, 0, 65536)), None)
    fr = FrameConfig(frame_type=0 if intra else 1, base_q_idx=100,
                     order_hint=6, tx_mode_select=True, delta_q_present=True,
                     delta_q_res=4, reference_select=not intra,
                     allow_screen_content_tools=True, interp_filter=4,
                     is_motion_mode_switchable=not intra, cdef_bits=2,
                     allow_warped_motion=not intra, gm=None if intra else gm)
    fr.ref_order_hints = (5, 4, 2, 0, 7, 8, 10)
    return seq, fr


def _writer(seq, fr, cdfs, rng_seed):
    from svt_av1_psyex_tpu_torch.bitstream.coeff_writer import CoeffWriter
    from svt_av1_psyex_tpu_torch.codec.mvp import MiState

    rng = np.random.default_rng(rng_seed)
    tw = TW.TileWriter(seq, fr, cdfs, MI_ROWS, MI_COLS)
    tw.coeff_writer = CoeffWriter(tw, MI_ROWS, MI_COLS, 1, 1)
    sb_rows, sb_cols = -(-MI_ROWS // 16), -(-MI_COLS // 16)
    tw.cdef_fb_map = rng.integers(0, 4, (sb_rows, sb_cols))
    tw.sb_qindex_map = rng.integers(60, 140, (sb_rows, sb_cols)).astype(np.int32)
    tw.seg_target = rng.integers(0, 3, (MI_ROWS, MI_COLS)).astype(np.int8)
    tw.seg_last_active = 2
    if not fr.frame_is_intra:
        tw.mi_state = MiState(MI_ROWS, MI_COLS)
        tw.mi_state.sign_bias = np.array([0, 0, 0, 0, 0, 1, 1, 1], bool)
    return tw


def _tx_types(is_inter: bool, tx: int, reduced: bool) -> list:
    """The tx types of the extended set a block's luma may code."""
    from svt_av1_psyex_tpu_torch.codec.constants import tx_size_sqr, tx_size_sqr_up

    up, sq = int(tx_size_sqr_up(tx)), int(tx_size_sqr(tx))
    if up > 3:
        return [0]
    if is_inter:
        if reduced or up == 3:
            return [0, 9]
        if sq == 2:
            return [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]
        return list(range(16))
    if up == 3:
        return [0]
    if reduced or sq == 2:
        return [0, 1, 2, 3, 9]
    return [0, 1, 2, 3, 9, 10, 11]


def _txb(rng, plane, plane_bsize, tx, tx_type, ux, uy):
    from svt_av1_psyex_tpu_torch.bitstream.coeff_writer import _scan_kind
    from svt_av1_psyex_tpu_torch.bitstream.tables import scan_table
    from svt_av1_psyex_tpu_torch.codec.constants import TX_H, TX_W

    cw, ch = min(int(TX_W[tx]), 32), min(int(TX_H[tx]), 32)
    q = np.zeros((ch, cw), np.int32)
    scan = scan_table(tx, _scan_kind(tx_type))
    n = int(rng.integers(0, min(cw * ch, 40)))
    for pos in scan[: n + 1 if rng.random() < 0.5 else n]:
        v = int(rng.choice([1, 1, 1, 2, 3, 5, 17, 300]))
        if rng.random() < 0.3:
            q.flat[pos] = v * (1 if rng.random() < 0.5 else -1)
    nz = [i for i, pos in enumerate(scan) if q.flat[pos]]
    return {"plane": plane, "plane_bsize": plane_bsize, "tx_size": tx,
            "tx_type": tx_type, "qcoeff": q, "eob": nz[-1] + 1 if nz else 0,
            "ux": ux, "uy": uy}


def _leaf(rng, bsize, r, c, intra_frame: bool, fr):
    from svt_av1_psyex_tpu_torch.codec.constants import (
        BLOCK_H, BLOCK_W, MAX_TX_SIZE_RECT, SPLIT_TX_SIZE, WEDGE_BITS,
        bsize_to_max_depth, block_size_of)

    bw, bh = int(BLOCK_W[bsize]), int(BLOCK_H[bsize])
    lf = TW.LeafBlock(bsize)
    lf.skip = bool(rng.random() < 0.3)
    lf.is_inter = (not intra_frame) and bool(rng.random() < 0.7)
    lf.tx_depth = int(rng.integers(0, bsize_to_max_depth(bsize) + 1)) \
        if bsize else 0
    if not lf.is_inter:
        lf.y_mode = int(rng.integers(0, 13))
        lf.uv_mode = int(rng.integers(0, 14 if max(bw, bh) <= 32 else 13))
        lf.angle_delta_y = int(rng.integers(-3, 4))
        lf.angle_delta_uv = int(rng.integers(-3, 4))
        if lf.uv_mode == 13:
            while lf.cfl_alpha_u == lf.cfl_alpha_v == 0:
                lf.cfl_alpha_u = int(rng.integers(-16, 17))
                lf.cfl_alpha_v = int(rng.integers(-16, 17))
        if lf.y_mode == 0 and max(bw, bh) <= 32 and rng.random() < 0.5:
            lf.use_filter_intra = True
            lf.filter_intra_mode = int(rng.integers(0, 5))
    else:
        comp = min(bw, bh) >= 8 and rng.random() < 0.4
        if comp:
            lf.ref_frame = int(rng.integers(1, 5))
            lf.ref_frame1 = int(rng.integers(5, 8))
            lf.inter_mode = int(rng.integers(17, 25))
            if rng.random() < 0.5:
                lf.comp_group_idx = 1
                lf.comp_type = 2 if (WEDGE_BITS[bsize] and rng.random() < 0.5) else 3
                lf.wedge_index = int(rng.integers(0, 16))
                lf.wedge_sign = int(rng.integers(0, 2))
                lf.mask_type = int(rng.integers(0, 2))
            else:
                lf.compound_idx = int(rng.integers(0, 2))
        else:
            lf.ref_frame = int(rng.integers(1, 8))
            lf.inter_mode = int(rng.integers(13, 17))
            if 8 <= bw <= 32 and 8 <= bh <= 32 and rng.random() < 0.4:
                lf.interintra_mode = int(rng.integers(0, 4))
                lf.wedge_interintra = int(rng.integers(0, 2)) \
                    if WEDGE_BITS[bsize] else 0
                lf.wedge_index = int(rng.integers(0, 16))
        near = lf.inter_mode in (14, 18)
        lf.drl_index = int(rng.integers(0, 3)) if near else 0
        lf.mv = (int(rng.integers(-300, 300)), int(rng.integers(-300, 300)))
        lf.mv1 = (int(rng.integers(-300, 300)), int(rng.integers(-300, 300)))
        lf.interp_filter = int(rng.integers(0, 3))
        lf.motion_mode = 0  # the Python walk picks it (_fix_motion_mode)
    if not lf.skip:
        tx = int(MAX_TX_SIZE_RECT[bsize])
        for _ in range(lf.tx_depth):
            tx = int(SPLIT_TX_SIZE[tx])
        types = _tx_types(lf.is_inter, tx, fr.reduced_tx_set)
        lf.coeffs = [_txb(rng, 0, bsize, tx, int(rng.choice(types)), c, r)]
        uv_bs = block_size_of(max(bw // 2, 4), max(bh // 2, 4))
        uv_tx = int(MAX_TX_SIZE_RECT[uv_bs])
        for p in (1, 2):
            lf.coeffs.append(_txb(rng, p, uv_bs, uv_tx, 0, c >> 1, r >> 1))
    return lf


def _tree(rng, bsize, r, c, intra_frame, fr):
    from svt_av1_psyex_tpu_torch.codec.constants import (
        BLOCK_H, BLOCK_W, Partition, subsize)

    bw4, bh4 = int(BLOCK_W[bsize]) >> 2, int(BLOCK_H[bsize]) >> 2
    has_rows = r + bh4 // 2 < MI_ROWS
    has_cols = c + bw4 // 2 < MI_COLS
    if bw4 == 1:
        p = Partition.NONE
    elif not has_rows and not has_cols:
        p = Partition.SPLIT
    elif not has_rows:
        p = rng.choice([Partition.SPLIT, Partition.HORZ])
    elif not has_cols:
        p = rng.choice([Partition.SPLIT, Partition.VERT])
    elif bw4 == 2:
        p = Partition(int(rng.integers(0, 4)))
    else:
        p = Partition(int(rng.choice([0, 0, 1, 2, 3, 3, 3, 4, 5, 6, 7, 8, 9])))
    node = TW.PartitionNode(p)
    if p == Partition.NONE:
        node.leaf = _leaf(rng, bsize, r, c, intra_frame, fr)
        return node
    sub = subsize(p, bsize)
    hw4, hh4 = bw4 // 2, bh4 // 2
    if p == Partition.SPLIT:
        for rr, cc in ((r, c), (r, c + hw4), (r + hh4, c), (r + hh4, c + hw4)):
            node.children.append(_tree(rng, sub, rr, cc, intra_frame, fr))
        return node
    sq = subsize(Partition.SPLIT, bsize)
    layout = {
        Partition.HORZ: [(r, c, sub), (r + hh4, c, sub)],
        Partition.VERT: [(r, c, sub), (r, c + hw4, sub)],
        Partition.HORZ_A: [(r, c, sq), (r, c + hw4, sq), (r + hh4, c, sub)],
        Partition.HORZ_B: [(r, c, sub), (r + hh4, c, sq), (r + hh4, c + hw4, sq)],
        Partition.VERT_A: [(r, c, sq), (r + hh4, c, sq), (r, c + hw4, sub)],
        Partition.VERT_B: [(r, c, sub), (r, c + hw4, sq), (r + hh4, c + hw4, sq)],
        Partition.HORZ_4: [(r + i * (bh4 // 4), c, sub) for i in range(4)],
        Partition.VERT_4: [(r, c + i * (bw4 // 4), sub) for i in range(4)],
    }[p]
    for rr, cc, b in layout:
        node.children.append(TW.PartitionNode(
            Partition.NONE, leaf=_leaf(rng, b, rr, cc, intra_frame, fr)))
    return node


@pytest.mark.parametrize("intra", [True, False], ids=["key", "inter"])
def test_random_superblocks_code_as_the_python_walk(intra):
    """Every superblock of two frames of random trees: the Python walk
    (which picks each leaf's motion mode among those its position
    allows) and then the C writer code it from the same state."""
    from svt_av1_psyex_tpu_torch.bitstream.tables import FrameCdfs

    seq, fr = _frame(intra)
    cdfs = FrameCdfs(fr.base_q_idx)
    py, nat = _writer(seq, fr, cdfs.clone(), 7), _writer(seq, fr, cdfs, 7)
    py._native = False
    pick = np.random.default_rng(11)
    orig = py._write_motion_mode

    def _fix_motion_mode(leaf, r, c, bsize):
        kind = py.motion_mode_kind(leaf, r, c, bsize)
        leaf.motion_mode = {"none": 0, "obmc": int(pick.integers(0, 2)),
                            "full": int(pick.integers(0, 3))}[kind]
        orig(leaf, r, c, bsize)

    py._write_motion_mode = _fix_motion_mode
    rng = np.random.default_rng(3 if intra else 5)
    n = 0
    for frame in range(2):
        for r in range(0, MI_ROWS, 16):
            for c in range(0, MI_COLS, 16):
                node = _tree(rng, 12, r, c, intra, fr)
                py.write_superblock(node, r, c)
                nat.write_superblock(node, r, c)
                n += 1
                assert _state(nat) == _state(py), (frame, r, c)
    assert nat.n_sbs_native == nat.n_sbs == n and py.n_sbs_native == 0
    assert nat.finish() == py.finish()

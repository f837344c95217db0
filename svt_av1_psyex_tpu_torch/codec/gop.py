"""Hierarchical GOP planning: dyadic mini-GOPs with backward references.

Counterpart: the reference's picture-decision process
(pd_process.c mini-GOP construction, pred structure PRED_RANDOM_ACCESS,
pred_structure.c 2-6 hierarchical levels) as a recursive dyadic planner:
an anchor chain at layer 0 plus a B-pyramid referencing its nearest past
and future coded frames, emitted in coded order with show_existing_frame
for every out-of-display-order frame.

Mini-GOP lengths are powers of two up to 16 (5 hierarchical layers).
Slots: 0/1 alternate as the anchor chain ("LAST pool" / mini-GOP ARF);
2 + layer hold the B-pyramid's internal anchors, reused per level as the
recursion unwinds (the reference's DPB virtual-buffer discipline,
pd_process.c ref assignment).
"""

from __future__ import annotations

from dataclasses import dataclass, field

# named reference indices (spec): LAST=1 ... ALTREF=7
LAST, LAST2, LAST3, GOLDEN, BWDREF, ALTREF2, ALTREF = 1, 2, 3, 4, 5, 6, 7

MAX_MINIGOP = 16


@dataclass
class FramePlan:
    disp_idx: int
    frame_type: int  # 0 KEY, 1 INTER
    show_frame: bool = True
    show_existing_slot: int | None = None  # emit show_existing TU instead
    refs: dict = field(default_factory=dict)  # ref name (1..7) -> slot
    refresh_flags: int = 0
    primary_ref_name: int | None = None  # named ref carrying the CDFs
    layer: int = 0
    tpl_betas: object = None  # per-SB TPL beta grid (QPM input) or None
    q_offset: int = 0
    chroma_q_offset: int = 0  # per-layer chroma qindex offset (config)


# per-layer qindex offsets (hierarchical ladder shape; anchors lowest).
# Used when neither RC nor TPL owns the allocation.
_LAYER_QOFF = [0, 8, 12, 16, 20, 24]


def _qoff(layer: int) -> int:
    return _LAYER_QOFF[min(layer, len(_LAYER_QOFF) - 1)]


def plan_minigop(anchor_slot: int, start_disp: int, length: int,
                 future_slot: int, mid_slot: int = 2) -> list[FramePlan]:
    """Coded-order plans for one dyadic mini-GOP of `length` (power of 2,
    <= 16) displayed frames start_disp .. start_disp+length-1, referencing
    the previous anchor in `anchor_slot`. The mini-GOP's ARF lands in
    `future_slot`; pyramid internals use slots >= mid_slot.

    Coding order is BFS-by-layer (with a top split when the pyramid has
    more internal frames than free DPB slots): every frame of a layer is
    coded before the next layer starts, and concurrently-live pyramid
    frames hold DISTINCT slots. Same-layer frames never reference each
    other, so the encoder can begin them together and pipeline their
    device analyses against the host commit/entropy tail (the
    picture-level parallelism of SURVEY §2.1 — the reference runs N
    EncDec instances on different pictures, enc_handle.c:478; here the
    parallel axis is device-queue depth instead of threads)."""
    assert length & (length - 1) == 0 and 1 <= length <= MAX_MINIGOP
    if length == 1:
        return [FramePlan(start_disp, 1, True,
                          refs={LAST: anchor_slot, ALTREF: anchor_slot},
                          refresh_flags=0xFF,  # becomes the next anchor
                          primary_ref_name=LAST, layer=0,
                          q_offset=_qoff(0))]
    plans: list[FramePlan] = []
    arf_disp = start_disp + length - 1
    # ARF: coded first, displayed last (no-show + show_existing at the end)
    plans.append(FramePlan(arf_disp, 1, False,
                           refs={LAST: anchor_slot, ALTREF: anchor_slot},
                           refresh_flags=1 << future_slot,
                           primary_ref_name=LAST, layer=0,
                           q_offset=_qoff(0)))

    def make_refs(past: int, future: int) -> dict:
        """Nearest past (LAST), nearest future (BWDREF), mini-GOP ARF
        (ALTREF) — collapsed when the nearest future IS the ARF."""
        if future == future_slot:
            return {LAST: past, ALTREF: future}
        return {LAST: past, BWDREF: future, ALTREF: future_slot}

    def leaf(disp: int, past: int, future: int, layer: int) -> FramePlan:
        return FramePlan(disp, 1, True, refs=make_refs(past, future),
                         refresh_flags=0, primary_ref_name=LAST,
                         layer=layer, q_offset=_qoff(layer))

    def mid_plan(disp: int, past: int, future: int, layer: int,
                 slot: int) -> FramePlan:
        return FramePlan(disp, 1, False, refs=make_refs(past, future),
                         refresh_flags=1 << slot, primary_ref_name=LAST,
                         layer=layer, q_offset=_qoff(layer))

    pool = [s for s in range(mid_slot, 8)
            if s not in (anchor_slot, future_slot)]

    def bfs(lo: int, hi: int, past: int, future: int, layer: int,
            free: list) -> None:
        """Whole-segment BFS: every internal frame gets its own slot,
        layers coded together, then leaves + show_existing in display
        order."""
        nodes = []  # (disp, past_slot, future_slot_idx, layer, is_leaf)
        slot_of: dict[int, int] = {}

        def walk(lo, hi, past, future, layer):
            if lo > hi:
                return
            if lo == hi:
                nodes.append((lo, past, future, layer, True))
                return
            mid = (lo + hi) // 2
            s = free[len(slot_of)]
            slot_of[mid] = s
            nodes.append((mid, past, future, layer, False))
            walk(lo, mid - 1, past, s, layer + 1)
            walk(mid + 1, hi, s, future, layer + 1)

        walk(lo, hi, past, future, layer)
        mids = sorted((n for n in nodes if not n[4]),
                      key=lambda n: (n[3], n[0]))
        for disp, p, f, lyr, _ in mids:
            plans.append(mid_plan(disp, p, f, lyr, slot_of[disp]))
        for disp, p, f, lyr, _ in sorted((n for n in nodes if n[4]),
                                         key=lambda n: n[0]):
            plans.append(leaf(disp, p, f, lyr))
            if disp + 1 in slot_of:  # next displayed frame is a pyramid mid
                plans.append(FramePlan(disp + 1, 1,
                                       show_existing_slot=slot_of[disp + 1]))

    def schedule(lo: int, hi: int, past: int, future: int, layer: int,
                 free: list) -> None:
        if lo > hi:
            return
        if lo == hi:
            plans.append(leaf(lo, past, future, layer))
            return
        if (hi - lo + 1) >> 1 <= len(free):
            bfs(lo, hi, past, future, layer, free)
            return
        mid = (lo + hi) // 2
        slot = free[0]
        plans.append(mid_plan(mid, past, future, layer, slot))
        schedule(lo, mid - 1, past, slot, layer + 1, free[1:])
        plans.append(FramePlan(mid, 1, show_existing_slot=slot))
        schedule(mid + 1, hi, slot, future, layer + 1, free[1:])

    schedule(start_disp, arf_disp - 1, anchor_slot, future_slot, 1, pool)
    plans.append(FramePlan(arf_disp, 1, show_existing_slot=future_slot))
    return plans


def plan_key(disp_idx: int) -> FramePlan:
    return FramePlan(disp_idx, 0, True, refresh_flags=0xFF,
                     primary_ref_name=None, layer=0, q_offset=0)

"""The measured window of an encode and the arithmetic of its metrics.

A run feeds the encoder one chunk of frames; every temporal unit (TU)
is stamped on the host's clock when the encoder emits it. The window
opens at the first `send_picture` of a fresh encoder and closes at the
first coded TU that arrives at or after `seconds`: frames are counted
whole, so the window overruns `seconds` by at most the time between two
coded TUs. A show-existing TU codes no frame and counts for nothing.

* fps: coded frames through the closing TU over the window's length;
* first_packet_s: from the window's start to the first TU;
* kbit_per_frame: the bits of the first `quality_frames` coded TUs (in
  coding order) over their count;
* mse_y8: the mean over those frames of the luma MSE of the encoder's
  reconstruction against the source, in 8-bit levels (divided by
  4 ** (bit_depth - 8)).

The quality frames are fixed per cell, so that a faster or a slower
program codes the same frames for them; a run whose window closes first
codes on, outside the window, until it has them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class TU:
    t: float            # seconds since the window opened
    pts: int            # display index of the frame it carries
    nbytes: int
    coded: int          # frames it codes (0: show-existing)
    frame_type: int | None


@dataclass
class Timeline:
    seconds: float
    quality_frames: int
    tus: list = field(default_factory=list)
    close: int | None = None        # index of the closing TU
    quality: list = field(default_factory=list)   # (pts, nbytes, recon_y)
    mse: list = field(default_factory=list)       # mse_y8 per quality frame

    def add(self, tu: TU) -> bool:
        """Record a TU; True when it closes the window."""
        self.tus.append(tu)
        if (self.close is None and tu.coded
                and tu.t >= self.seconds):
            self.close = len(self.tus) - 1
            return True
        return False

    def wants_quality(self) -> bool:
        return len(self.quality) < self.quality_frames

    def add_quality(self, pts: int, nbytes: int, recon_y) -> None:
        self.quality.append((pts, nbytes, recon_y))

    def measure_quality(self, source_y, bit_depth: int) -> None:
        """The MSE of each quality frame's recon against
        `source_y(pts)`; the recons are dropped."""
        self.mse = [mse_y8(r, source_y(p), bit_depth)
                    for p, _, r in self.quality]
        self.quality = [(p, n, None) for p, n, _ in self.quality]

    @property
    def done(self) -> bool:
        return self.close is not None and not self.wants_quality()

    # ---- metrics -----------------------------------------------------------
    @property
    def window_s(self) -> float:
        return self.tus[self.close].t

    @property
    def frames(self) -> int:
        """Coded frames through the closing TU."""
        return sum(tu.coded for tu in self.tus[: self.close + 1])

    def fps(self) -> float:
        return self.frames / self.window_s

    def first_packet_s(self) -> float:
        return self.tus[0].t

    def kbit_per_frame(self) -> float:
        q = self.quality[: self.quality_frames]
        return sum(n for _, n, _ in q) * 8 / 1000.0 / len(q)

    def mse_y8(self) -> float:
        return float(np.mean(self.mse[: self.quality_frames]))


def mse_y8(recon_y: np.ndarray, src_y: np.ndarray, bit_depth: int) -> float:
    """Luma MSE of a reconstruction against its source, in 8-bit levels."""
    d = recon_y.astype(np.float64) - src_y.astype(np.float64)
    return float(np.mean(d * d)) / float(4 ** (bit_depth - 8))

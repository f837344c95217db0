"""Synthetic source frames made on the device from the run's seed.

The kinds are those of the repository's test clips (tools/mkclip.py
`synth_frame`: blobs, texture, noise, gradient, flat), rewritten in
torch so that a frame is made on the card in microseconds rather than
by numpy on the host. What the seed sets is drawn once, on the host, by
`numpy.random.default_rng(seed)`; every field derived from it (the
blobs' start points, the texture and noise fields) is then made on the
device from a `torch.Generator` seeded from that draw. The seed sets
noise only (the blobs' light noise, the texture's field, the noise
kind's frames): the scene's structure (the blobs' sizes, paths and
amplitudes, the texture's band and motion, the noise level) is the same
for every seed, so that seeds change the content and not the amount of
work.

Each kind's parameters come from the traffic file (`params`), with the
defaults below, which are mkclip's. Chroma is mkclip's pair of
sinusoids in every kind.
"""

from __future__ import annotations

import math

import numpy as np
import torch

DEFAULTS = {
    "blobs": {"count": 4, "amp": 0.45, "noise": 0.003,
              "speed_x": 6.0, "speed_y": 3.0},
    "texture": {"amp": 0.18, "band": 0.28, "period": 97.0, "drift": 2.0,
                "dx": 5.0, "dy": 3.0, "passes": 2},
    "noise": {"sigma": 0.03, "fx": 53.0, "fy": 41.0},
    "gradient": {},
    "flat": {},
}

BATCH = 16   # frames made on the card at a time


def _seed_words(seed: int, n: int) -> list[int]:
    """n 63-bit words drawn from the (arbitrarily large) run seed."""
    rng = np.random.default_rng(int(seed))
    return [int(v) for v in rng.integers(0, 2**63 - 1, size=n)]


class FrameSource:
    """Frames of one clip: `kind` at `width` x `height`, `bit_depth`,
    4:2:0, frame t = 0, 1, ... as lists of host planes (Y, U, V) in the
    encoder's input type (uint8 at 8 bits, uint16 above)."""

    def __init__(self, kind: str, width: int, height: int, bit_depth: int,
                 seed: int, device, span: int,
                 params: dict | None = None):
        if kind not in DEFAULTS:
            raise ValueError(f"unknown content kind {kind!r}; known: "
                             f"{sorted(DEFAULTS)}")
        self.kind, self.w, self.h, self.bd = kind, width, height, bit_depth
        self.span = span   # frames 0 .. span - 1 can be made
        self.device = torch.device(device)
        self.p = {**DEFAULTS[kind], **(params or {})}
        self.maxv = float((1 << bit_depth) - 1)
        self.words = _seed_words(seed, 8)
        self._cache: dict[int, list] = {}
        yy, xx = torch.meshgrid(
            torch.arange(height, dtype=torch.float32, device=self.device),
            torch.arange(width, dtype=torch.float32, device=self.device),
            indexing="ij")
        self.yy, self.xx = yy, xx
        self._field = None

    def _gen(self, k: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(self.words[k])
        return g

    # ---- luma of each kind -----------------------------------------------
    def _blobs(self, t: torch.Tensor) -> torch.Tensor:
        p, w, h, mv = self.p, self.w, self.h, self.maxv
        if self._field is None:
            self._field = torch.randn((h, w), generator=self._gen(1),
                                      device=self.device) * (p["noise"] * mv)
        noise = self._field
        tt = t[:, None, None]
        y = ((self.xx / w) * 0.35 * mv + (self.yy / h) * 0.15 * mv)[None]
        y = y.expand(len(t), h, w).clone()
        for i in range(int(p["count"])):
            cx = torch.remainder((0.2 + 0.15 * i) * w + p["speed_x"] * tt
                                 * (1 + i * 0.3), w)
            cy = torch.remainder((0.3 + 0.12 * i) * h + p["speed_y"] * tt
                                 * (1 - i * 0.2), h)
            sig = 0.08 * min(w, h) * (1 + 0.5 * i)
            y += (p["amp"] * mv) * torch.exp(
                -((self.xx - cx) ** 2 + (self.yy - cy) ** 2)
                / (2 * sig ** 2))
        return y + noise

    def _texture(self, t: torch.Tensor) -> torch.Tensor:
        """Band-limited noise translating by (dx, dy) pixels a frame over
        a drifting sinusoid. The field is large enough for the motion of
        the source's span of frames without wrapping, so that it
        translates continuously; fractional motion is bilinear."""
        p, w, h, mv = self.p, self.w, self.h, self.maxv
        if self._field is None:
            fh = h + int(math.ceil(abs(p["dy"]) * self.span)) + 2
            fw = w + int(math.ceil(abs(p["dx"]) * self.span)) + 2
            big = torch.randn((fh, fw), generator=self._gen(2),
                              device=self.device)
            for _ in range(int(p["passes"])):   # cheap low-pass
                big = (big + torch.roll(big, 1, 0) + torch.roll(big, 1, 1)
                       + torch.roll(big, (1, 1), (0, 1))) * 0.25
            self._field = big
        big = self._field
        out = []
        for tv in t.tolist():
            ox, oy = abs(p["dx"]) * tv, abs(p["dy"]) * tv
            ix, iy = int(ox), int(oy)
            fx, fy = ox - ix, oy - iy
            win = big[iy: iy + h + 1, ix: ix + w + 1]
            tex = ((1 - fy) * ((1 - fx) * win[:h, :w] + fx * win[:h, 1:])
                   + fy * ((1 - fx) * win[1:, :w] + fx * win[1:, 1:]))
            if p["dx"] < 0:
                tex = tex.flip(1)
            if p["dy"] < 0:
                tex = tex.flip(0)
            y = (0.5 + p["band"] * torch.sin(
                2 * math.pi * (self.xx + p["drift"] * tv) / p["period"])) * mv
            out.append(y + tex * (p["amp"] * mv))
        return torch.stack(out)

    def _noise(self, t: torch.Tensor) -> torch.Tensor:
        p, mv = self.p, self.maxv
        base = (0.5 + 0.3 * torch.sin(2 * math.pi * self.xx / p["fx"])
                * torch.cos(2 * math.pi * self.yy / p["fy"])) * mv
        out = []
        for tv in t.tolist():
            g = torch.Generator(device=self.device)
            g.manual_seed((self.words[3] + 7919 * int(tv)) % (2**63 - 1))
            out.append(base + torch.randn(base.shape, generator=g,
                                          device=self.device)
                       * (p["sigma"] * mv))
        return torch.stack(out)

    def _gradient(self, t: torch.Tensor) -> torch.Tensor:
        y = (self.xx / self.w + self.yy / self.h) * 0.5 * self.maxv
        return y[None].expand(len(t), self.h, self.w)

    def _flat(self, t: torch.Tensor) -> torch.Tensor:
        return torch.full((len(t), self.h, self.w), float(int(self.maxv) // 2),
                          device=self.device)

    def _chroma(self, t: torch.Tensor):
        ch, cw = (self.h + 1) >> 1, (self.w + 1) >> 1
        cyy, cxx = torch.meshgrid(
            torch.arange(ch, dtype=torch.float32, device=self.device),
            torch.arange(cw, dtype=torch.float32, device=self.device),
            indexing="ij")
        tt = t[:, None, None]
        u = (0.5 + 0.25 * torch.sin(2 * math.pi * (cxx / cw + 0.02 * tt))) \
            * self.maxv
        v = (0.5 + 0.25 * torch.cos(2 * math.pi * (cyy / ch - 0.015 * tt))) \
            * self.maxv
        return u, v

    # ---- planes ------------------------------------------------------------
    def device_planes(self, t0: int, n: int) -> list[torch.Tensor]:
        """Frames t0 .. t0 + n - 1 on the device: [Y, U, V], each
        (n, H, W) int32, clipped to the bit depth."""
        t = torch.arange(t0, t0 + n, dtype=torch.float32, device=self.device)
        y = getattr(self, "_" + self.kind)(t)
        u, v = self._chroma(t)
        # float -> integer as numpy's astype: truncation toward zero
        return [torch.clamp(p, 0, self.maxv).to(torch.int32)
                for p in (y, u, v)]

    def prepare(self, n: int) -> None:
        """Make frames 0 .. n - 1 and keep them on the host (set-up)."""
        for t0 in range(0, n, BATCH):
            self._fill(t0, min(BATCH, n - t0))

    def _fill(self, t0: int, n: int) -> None:
        dt = np.uint8 if self.bd == 8 else np.uint16
        planes = [p.cpu().numpy().astype(dt) for p in
                  self.device_planes(t0, n)]
        for i in range(n):
            self._cache[t0 + i] = [p[i] for p in planes]

    def frame(self, t: int) -> list:
        """Frame t as host planes (made now if set-up did not)."""
        if not 0 <= t < self.span:
            raise IndexError(f"frame {t} outside the source's span "
                             f"0..{self.span - 1}")
        if t not in self._cache:
            self._fill(t, 1)
        return self._cache[t]

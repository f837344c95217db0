"""Everything the harness reaches into the program for, in one place.

The port's public API (`SvtAv1Encoder`: `config`, `init`,
`warm_device`, `send_picture`, `get_packet`) has no packet callback, no
way to read a hidden frame's reconstruction and no stage clock, so the
harness reads these private names of `svt_av1_psyex_tpu_torch`; a
rename in the port breaks the benchmark here, loudly, and nowhere else:

* `SvtAv1Encoder._out_q`: the deque the encoder appends each TU to, as
  it is emitted; replaced by one that stamps each TU (`stamp_packets`);
* `SvtAv1Encoder._enc`: the frame encoder (`codec.encoder.Av1Encoder`);
* `Av1Encoder.last_recon`: the planes of the frame coded last, hidden
  ones too (`recon_y`);
* `Av1Encoder._tick` and `Av1Encoder.timing`: the stage clock under
  SVT_TPU_TIMING=1 (`watch_stages`, `stage_clock`);
* `Av1Encoder.join_warm`: waits for `warm_device`'s thread (`warm`).

The probes (probes.py) wrap, besides, four functions of the port by
their module names: `ops.cuda.fullloop.fullloop`,
`ops.cuda.sad.sad_lattice`, `intra_analysis_sharded` and
`inter_analysis_sharded` as `codec.md_device` (and `codec.encoder`)
call them, and the method `codec.md_device.DeviceIntraMD.plan_frame`.
"""

from __future__ import annotations

from collections import deque


class _StampedQueue(deque):
    """The encoder's output queue, calling `on_packet` on each TU as it
    is emitted."""

    def __init__(self, on_packet):
        super().__init__()
        self.on_packet = on_packet

    def append(self, pkt):
        super().append(pkt)
        if not pkt.is_eos:
            self.on_packet(pkt)


def make_encoder(settings: dict, device, kernels: str = "hand"):
    """A fresh, initialised SvtAv1Encoder with the cell's settings."""
    from svt_av1_psyex_tpu_torch.api.encoder import SvtAv1Encoder

    api = SvtAv1Encoder(device=device, kernels=kernels)
    for k, v in settings.items():
        if not hasattr(api.config, k):
            raise KeyError(f"no encoder setting {k!r}")
        setattr(api.config, k, v)
    api.init()
    return api


def warm(api) -> None:
    """Pays the first-use costs before the window: the native host
    tier's build (into build/torch_native/ of the checkout, once) and
    load, then the encoder's warm_device (both kernels' build and load,
    each device program at the cell's shapes), joined."""
    from svt_av1_psyex_tpu_torch.native import cdefc, commit, ecenc, frame_enc

    if ecenc.get_lib() is None:
        raise RuntimeError("the native host tier did not build or load")
    for mod in (commit, cdefc, frame_enc):
        mod.available()
    api.warm_device()
    api._enc.join_warm()


def stamp_packets(api, on_packet) -> None:
    api._out_q = _StampedQueue(on_packet)


def recon_y(api):
    """A copy of the luma of the frame the encoder coded last."""
    return api._enc.last_recon[0].copy()


def stage_clock(api) -> dict:
    """The stage clock's seconds so far, by stage."""
    return dict(getattr(api._enc, "timing", None) or {})


def watch_stages(api, on_span) -> None:
    """Calls on_span(stage, t0, t1) for each span of the stage clock."""
    enc = api._enc
    tick = enc._tick

    def _tick(key, t0):
        t1 = tick(key, t0)
        on_span(key, t0, t1)
        return t1

    enc._tick = _tick

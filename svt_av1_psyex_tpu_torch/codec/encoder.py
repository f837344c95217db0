"""The port's encoder: the JAX package's Av1Encoder with its device tier
replaced by the port's.

`Av1Encoder` subclasses svt_av1_psyex_tpu/codec/encoder.py's class and
overrides only what reaches JAX:

* the constructor takes the analysis `device` (and `kernels`) and does
  not arm the JAX persistent compile cache;
* the base class never builds its own device MD (`_device_md_precheck`
  is False here); `_begin_frame_impl` runs the base frame set-up and then
  attaches the port's DeviceIntraMD on the same gates;
* `encode_keyframes` runs one batched analysis on the device for the
  whole group, then the host tail per frame;
* `_pick_cdef` picks the native C backend through the port's cdefc, or
  the numpy one; there is no device CDEF.

Inter and intra-only frames, and loop restoration (whose search runs on
the JAX device tier), raise NotImplementedError: they are not ported.
"""

from __future__ import annotations

import time

import numpy as np

from svt_av1_psyex_tpu.bitstream.headers import SequenceConfig
from svt_av1_psyex_tpu.bitstream.tables import FrameCdfs
from svt_av1_psyex_tpu.codec import encoder as ref_encoder
from svt_av1_psyex_tpu.codec.rd import cdf_costs, compute_rdmult
from svt_av1_psyex_tpu.utils import tunnel

from ..device.intra import DEVICE_MODES, intra_analysis_batch, qp_row_for
from ..native import cdefc
from ..runtime import check_kernels, resolve_device
from .md_device import DeviceIntraMD, upload_lumas

__all__ = ["Av1Encoder", "SequenceConfig"]


class Av1Encoder(ref_encoder.Av1Encoder):
    """Keyframe encoder whose device analysis runs in PyTorch on
    `device` ("cpu" or "cuda"). `kernels="plain"` runs the plain PyTorch
    version of every kernel instead of the hand kernel, to compare the
    two on the card; the default "hand" launches the CUDA kernels on a
    CUDA device (on the CPU there are none, and the plain versions run)."""

    def __init__(self, seq, preset: int = 10, *, device,
                 kernels: str = "hand", **kwargs):
        self.device = resolve_device(device)
        self.kernels = check_kernels(kernels)
        # the inherited constructor arms the JAX package's persistent
        # compile cache, which imports jax; the port compiles nothing
        # through XLA, so the one-shot hook is marked as done
        tunnel._cache_armed = True
        super().__init__(seq, preset, **kwargs)
        if seq.enable_restoration:
            raise NotImplementedError(
                "loop restoration is not ported yet (its search runs on "
                "the JAX device tier): pass enable_restoration=False or a "
                "preset above 6")
        self.stage_seconds: dict = {}

    def _device_md_precheck(self) -> bool:
        """Never let the base class build the JAX package's device MD;
        the port attaches its own in _begin_frame_impl."""
        return False

    def _port_device_md_ok(self) -> bool:
        """The base class's frame-independent device-MD gates."""
        return super()._device_md_precheck()

    def _begin_frame_impl(self, planes, base_q_idx=80, force_key=False,
                          plan=None, _analysis_row=None, _group=None):
        slots = getattr(self, "slots", None)
        if plan is None:
            is_key = force_key or slots is None or slots[0] is None
        else:
            is_key = (plan.show_existing_slot is not None
                      or plan.frame_type == 0)
        if not is_key:
            raise NotImplementedError(
                "the port encodes keyframes only: inter and intra-only "
                "frames are not ported yet")
        st = super()._begin_frame_impl(planes, base_q_idx, force_key, plan,
                                       _analysis_row, _group)
        if isinstance(st, (bytes, bytearray)):  # show-existing TU
            return st
        # the device-MD gates of the base class (encoder.py dev_ok)
        if (self._port_device_md_ok()
                and not st["fr"].allow_screen_content_tools
                and st["n_tiles"] == 1):
            dmd = DeviceIntraMD(st["md"], self.seq, st["fr"], st["sb_qmap"],
                                device=self.device, kernels=self.kernels)
            if _analysis_row is None:
                dmd.analyze_dispatch()
            st["dmd"] = dmd
        return st

    @staticmethod
    def _pick_cdef():
        """CDEF backend: native C when it builds, else numpy. Both share
        the full-grid search contract."""
        if cdefc.available():
            return cdefc.cdef_search_frame_c
        from svt_av1_psyex_tpu.ops.cdef import cdef_search_frame

        return cdef_search_frame

    def keyframe_depths(self) -> tuple:
        """Lattice depths of this encoder's keyframes."""
        return DeviceIntraMD.depths_for(
            self._min_partition_bsize, self.mi_rows, self.mi_cols)

    def analyze_keyframes(self, frames: list, base_q_idx: int
                          ) -> np.ndarray:
        """The batched device analysis of a keyframe group: (F, P) packed
        (J, mode) rows on the host, as device.intra.intra_analysis_batch
        returns them (unpack with unpack_rd_analysis at
        self.keyframe_depths())."""
        bd = self.seq.bit_depth
        lumas = np.stack([
            DeviceIntraMD.pad_src(self._pad_plane(
                np.asarray(f[0]), self.aligned_w, self.aligned_h))
            for f in frames])
        q0 = int(np.clip(base_q_idx, 1, 255))
        qp = qp_row_for(q0, 0, 0, bd)
        # RD reduction constants (frame CDF snapshot costs)
        cdfs0 = FrameCdfs(q0)
        mode_rate = cdf_costs(cdfs0.kf_y_mode[0][0, 0])[list(DEVICE_MODES)]
        sk = cdf_costs(cdfs0.skip[0][0])
        psy_fixed = 0
        if self.psy_rd > 0.0:
            from svt_av1_psyex_tpu.ops.psy_dist import hvs_modulation_factor

            psy_fixed = int(round(
                hvs_modulation_factor(self.psy_rd, True, 0) * 256))
        rd = np.concatenate([
            [compute_rdmult(q0, bd), sk[0], sk[1]],
            mode_rate, [psy_fixed]]).astype(np.int32)
        n = len(frames)
        packed = intra_analysis_batch(
            upload_lumas(lumas, bd, self.device),
            np.broadcast_to(qp, (n, qp.size)),
            np.broadcast_to(rd, (n, rd.size)),
            depths=self.keyframe_depths(), bit_depth=bd,
            psy=psy_fixed > 0, kernels=self.kernels)
        return packed.cpu().numpy()

    def encode_keyframes(self, frames: list, base_q_idx: int = 80
                         ) -> list[bytes]:
        """Group-encode consecutive keyframes: ONE batched device
        analysis serves the whole group (frames folded into the block
        batch), then the conformant commit, in-loop filters and entropy
        coding run per frame on the host. frames: per frame, the list of
        planes (numpy arrays). Sets self.recons to each frame's
        reconstruction (what a decoder must output) and
        self.stage_seconds to wall times: "device_analysis" (upload,
        lattice, fetch), "frames" (per-frame set-up, partition DP,
        commit, DLF), "cdef", "finalize" (entropy coding, packing) and
        "host", the sum of the last three."""
        t0 = time.perf_counter()
        self.recons = []
        if not self._port_device_md_ok() or len(frames) <= 1:
            tus = []
            for f in frames:
                tus.append(self.encode_frame(f, base_q_idx, force_key=True))
                self.recons.append(self.last_recon)
            host = time.perf_counter() - t0
            self.stage_seconds = {"device_analysis": 0.0, "frames": host,
                                  "cdef": 0.0, "finalize": 0.0,
                                  "host": host}
            return tus
        rows = self.analyze_keyframes(frames, base_q_idx)
        t1 = time.perf_counter()
        bd = self.seq.bit_depth
        group: list = []
        for i, f in enumerate(frames):
            self.encode_frame(f, base_q_idx, force_key=True,
                              _analysis_row=rows[i], _group=group)
        t2 = time.perf_counter()
        jobs = [st["cdef_job"] for st in group if st["cdef_job"] is not None]
        if jobs:
            _cdef = self._pick_cdef()
            results = [
                _cdef(j["recon_planes"], j["src_planes"], j["skip_g"],
                      j["mi_rows"], j["mi_cols"], j["base_q_idx"],
                      j["rdcost_fn"], level=self._cdef_search_level,
                      bit_depth=bd)
                for j in jobs]
            it = iter(results)
            for st in group:
                if st["cdef_job"] is not None:
                    self._apply_cdef_result(st["fr"], st["tw"], next(it))
        t3 = time.perf_counter()
        tus = []
        for st in group:
            tus.append(self._finalize_frame(st))
            self.recons.append(self.last_recon)
        t4 = time.perf_counter()
        self.stage_seconds = {"device_analysis": t1 - t0, "frames": t2 - t1,
                              "cdef": t3 - t2, "finalize": t4 - t3,
                              "host": t4 - t1}
        return tus

"""SvtAv1EncApp-shaped CLI of the port: y4m in, IVF out.

    python -m svt_av1_psyex_tpu_torch.app.main -i in.y4m -b out.ivf \\
        --preset 8 --crf 30 --device cuda

The JAX package's CLI (svt_av1_psyex_tpu/app/main.py), encoding
through the port's SvtAv1Encoder, with one more option: `--device` names
the analysis device ("cuda" by default; "cpu" runs the plain version of
every kernel). Asking for CUDA where there is none raises. Token names follow
the reference's CLI table (Source/App/app_config.c:1296) for the
implemented set; --svtav1-params k=v:k=v passthrough supported.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..api.encoder import EncoderConfig, SvtAv1Encoder, svt_av1_get_version
from ..api.params import parse_svtav1_params
from ..conformance.dav1d import psnr, ssim
from ..runtime import resolve_device
from ..utils.ivf import IvfWriter
from ..utils.y4m import Y4MReader


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="SvtAv1EncApp",
        description="SVT-AV1-PSYEX rebuild, PyTorch + CUDA port")
    p.add_argument("-i", "--input", required=True, help="input y4m (or '-' stdin)")
    p.add_argument("-b", "--output", required=True, help="output IVF")
    p.add_argument("--device", default="cuda",
                   help="analysis device: cuda (default), cuda:N or cpu")
    p.add_argument("--preset", type=int, default=10)
    p.add_argument("--crf", type=int, default=None)
    p.add_argument("-q", "--qp", type=int, default=35)
    p.add_argument("--keyint", type=int, default=-2)
    p.add_argument("-n", "--frames", type=int, default=0, help="max frames (0=all)")
    p.add_argument("--tune", type=int, default=1)
    p.add_argument("--sharpness", type=int, default=0)
    p.add_argument("--sharp-tx", type=int, default=1, dest="sharp_tx",
                   help="keep luma detail: no RDOQ down-rounding (0/1)")
    p.add_argument("--spy-rd", type=int, default=0, dest="spy_rd",
                   help="alternate psy RD pathways (0 off, 1 full, 2 partial)")
    p.add_argument("--psy-rd", type=float, default=None, dest="psy_rd")
    p.add_argument("--hierarchical-levels", type=int, default=0,
                   dest="hierarchical_levels", help="0 auto, 1-4 = 2^n GOP")
    p.add_argument("--enable-tpl-la", type=int, default=1, dest="enable_tpl_la")
    p.add_argument("--tile-columns", type=int, default=0, dest="tile_columns",
                   help="log2 of tile columns")
    p.add_argument("--film-grain", type=int, default=0, dest="film_grain",
                   help="grain synthesis strength 0-50")
    p.add_argument("--enable-variance-boost", type=int, default=1)
    p.add_argument("--enable-tf", type=int, default=1,
                   help="alt-ref temporal filtering (RA anchors)")
    p.add_argument("--variance-boost-strength", type=int, default=2)
    p.add_argument("--variance-octile", type=int, default=6)
    p.add_argument("--enable-stat-report", type=int, default=0)
    p.add_argument("--lp", type=int, default=0)
    p.add_argument("--rc", type=int, default=0, help="0 CRF/CQP, 1 VBR, 2 CBR")
    p.add_argument("--tbr", type=int, default=2000000, help="target bitrate (bps)")
    p.add_argument("--pred-struct", type=int, default=2, dest="pred_struct",
                   help="1 low delay, 2 random access")
    p.add_argument("--qp-file", default=None, dest="qp_file",
                   help="per-frame QP file (one QP per line; use-q-file)")
    p.add_argument("--skip", type=int, default=0,
                   help="skip first N input frames")
    p.add_argument("--nch", type=int, default=1,
                   help="independent encode channels (app_main.c:169); "
                        "inputs/outputs take comma-separated lists")
    p.add_argument("--svtav1-params", default="")
    p.add_argument("--version", action="version", version=svt_av1_get_version())
    p.add_argument("--progress", type=int, default=1)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    if args.nch > 1:
        return _run_channels(args)
    return _run_channel(args, args.input, args.output)


def _run_channels(args) -> int:
    """Channel parallelism (app_main.c:169-260): N independent encoder
    instances over comma-separated input/output lists, each on its own
    host thread (the encodes share the device; host stages overlap)."""
    import threading

    ins = args.input.split(",")
    outs = args.output.split(",")
    if len(ins) != args.nch or len(outs) != args.nch:
        print("--nch requires matching comma-separated -i/-b lists",
              file=sys.stderr)
        return 1
    rcs = [1] * args.nch

    def run(k):
        rcs[k] = _run_channel(args, ins[k], outs[k])
    threads = [threading.Thread(target=run, args=(k,))
               for k in range(args.nch)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return max(rcs)


def _run_channel(args, input_path: str, output_path: str) -> int:
    fh = sys.stdin.buffer if input_path == "-" else open(input_path, "rb")
    reader = Y4MReader(fh)
    fmt = reader.fmt

    handle = SvtAv1Encoder(device=args.device)
    cfg = EncoderConfig()
    cfg.source_width = fmt.width
    cfg.source_height = fmt.height
    cfg.encoder_bit_depth = fmt.bit_depth
    cfg.encoder_color_format = {"420": 1, "422": 2, "444": 3,
                                "400": 0}[fmt.subsampling]
    cfg.rate_control_mode = args.rc
    cfg.target_bit_rate = args.tbr
    cfg.pred_structure = args.pred_struct
    cfg.frame_rate_numerator = fmt.fps.numerator
    cfg.frame_rate_denominator = fmt.fps.denominator
    cfg.enc_mode = args.preset
    cfg.qp = args.qp
    cfg.crf = args.crf
    cfg.intra_period_length = args.keyint
    cfg.tune = args.tune
    cfg.sharpness = args.sharpness
    cfg.sharp_tx = args.sharp_tx
    cfg.spy_rd = args.spy_rd
    if args.psy_rd is not None:
        cfg.psy_rd = args.psy_rd
    cfg.hierarchical_levels = args.hierarchical_levels
    cfg.enable_tpl_la = args.enable_tpl_la
    cfg.tile_columns = args.tile_columns
    cfg.film_grain_denoise_strength = args.film_grain
    cfg.enable_variance_boost = bool(args.enable_variance_boost)
    cfg.enable_tf = bool(args.enable_tf)
    cfg.variance_boost_strength = args.variance_boost_strength
    cfg.variance_octile = args.variance_octile
    cfg.stat_report = args.enable_stat_report
    cfg.recon_enabled = bool(args.enable_stat_report)
    qp_list = None
    if args.qp_file:
        cfg.use_qp_file = True
        with open(args.qp_file) as qf:
            qp_list = [int(t) for t in qf.read().split() if t.strip()]
    if args.svtav1_params:
        parse_svtav1_params(cfg, args.svtav1_params)

    handle.set_parameter(cfg)
    handle.init()

    out = open(output_path, "wb")
    ivf = IvfWriter(out, fmt.width, fmt.height,
                    fmt.fps.denominator, fmt.fps.numerator)
    n = 0
    t0 = time.perf_counter()
    sum_psnr = np.zeros(3)
    sum_ssim = 0.0
    n_psnr = 0
    srcs: dict[int, list] = {}  # pts -> planes, until recon arrives

    def drain_recons() -> None:
        # recons arrive in coded order; match by pts (RA reorders)
        nonlocal n_psnr
        while (rec := handle.get_recon()) is not None:
            planes = srcs.pop(rec.pts, None)
            if planes is None:
                continue
            for i in range(min(3, len(planes))):
                ph, pw = planes[i].shape
                sum_psnr[i] += psnr(rec.planes[i][:ph, :pw], planes[i],
                                    fmt.bit_depth)
            ph, pw = planes[0].shape
            nonlocal sum_ssim
            sum_ssim += ssim(rec.planes[0][:ph, :pw], planes[0],
                             fmt.bit_depth)
            n_psnr += 1

    skipped = 0
    for planes in reader.frames():
        if skipped < args.skip:
            skipped += 1
            continue
        handle.send_picture(planes, n,
                            qp=(qp_list[n % len(qp_list)]
                                if qp_list else None))
        if cfg.stat_report:
            srcs[n] = planes
            drain_recons()
        while (pkt := handle.get_packet()) is not None:
            if not pkt.is_eos:
                ivf.write_frame(pkt.data, pkt.pts)
        n += 1
        if args.progress:
            print(f"\rEncoding frame {n}", end="", file=sys.stderr, flush=True)
        if args.frames and n >= args.frames:
            break
    handle.send_picture(None)  # EOS
    while (pkt := handle.get_packet()) is not None:
        if not pkt.is_eos:
            ivf.write_frame(pkt.data, pkt.pts)
    if cfg.stat_report:
        drain_recons()
    ivf.close()
    out.close()
    dt = time.perf_counter() - t0
    print(f"\n{n} frames in {dt:.2f}s ({n / dt:.2f} fps)", file=sys.stderr)
    if cfg.stat_report and n_psnr:
        print(f"PSNR Y {sum_psnr[0]/n_psnr:.2f}  U {sum_psnr[1]/n_psnr:.2f}"
              f"  V {sum_psnr[2]/n_psnr:.2f}  SSIM Y {sum_ssim/n_psnr:.4f}",
              file=sys.stderr)
    handle.deinit()
    handle.deinit_handle()
    return 0


if __name__ == "__main__":
    sys.exit(main())

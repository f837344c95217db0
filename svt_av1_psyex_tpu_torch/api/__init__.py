"""Public API of the port, shaped after the reference's EbSvtAv1Enc.h
surface (counterpart of svt_av1_psyex_tpu/api/)."""

from .encoder import (  # noqa: F401
    EncoderConfig,
    Packet,
    SvtAv1Encoder,
    svt_av1_enc_get_packet,
    svt_av1_enc_init,
    svt_av1_enc_init_handle,
    svt_av1_enc_send_picture,
    svt_av1_enc_set_parameter,
    svt_av1_get_version,
    svt_psy_get_version,
)

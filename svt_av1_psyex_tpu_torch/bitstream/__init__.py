"""Bitstream layer: bit I/O, AV1 range coder, OBU framing, syntax coding."""

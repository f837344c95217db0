"""SvtAv1EncApp-shaped CLI of the port."""

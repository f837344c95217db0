"""The multi-device layout of the analysis tier: a (dp, sp) DeviceMesh
(frames over dp, superblock rows over sp) and dryrun_multichip, which
holds a sharded encode against the unsharded one."""

from .mesh import DeviceMesh

__all__ = ["DeviceMesh"]

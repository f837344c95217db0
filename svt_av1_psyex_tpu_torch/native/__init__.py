"""Native (C) backends: ctypes bindings of the C host tier (native/*.c at
the repository root) and the dav1d conformance shim."""

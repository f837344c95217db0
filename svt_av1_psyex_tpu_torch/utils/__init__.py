"""Host utilities: container I/O (IVF), raw video I/O (y4m/yuv), logging."""

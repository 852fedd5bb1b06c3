"""The device's idle share of the traced stretch of train steps, 100 x
(1 - busy / window). It should move ``train_shapes_per_s``."""

KERNELS = {}


def read(trace):
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)

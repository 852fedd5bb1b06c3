"""Device operations (kernels, copies, memsets) a train step: the events of
the checked stretch over its steps. Fusing the step's small operations
lowers it; it should move ``train_shapes_per_s``."""

KERNELS = {}


def read(trace):
    return len(trace.events) / trace.rounds

"""``device_gb``: the most device memory allocated during the window
(``torch.cuda.max_memory_allocated``, reset at its start once the
harness's own tensors were freed): the index and the serving workspace."""


def read(run):
    return run.window_peak / 1e9 if run.on_card else None

"""``train_s``: seconds of ``IVFFlatIndex.train_from_device`` (k-means on
the card), host clock around it with the card synchronised."""


def read(run):
    return run.train_s

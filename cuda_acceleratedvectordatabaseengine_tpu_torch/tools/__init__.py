"""Operational CLIs (ports of the JAX package's ``tools/``), each run as
``python -m cuda_acceleratedvectordatabaseengine_tpu_torch.tools.<name>``
and each on the card unless ``--device`` names another device:

  - ``build_index``  → offline index builder: Arrow file or synthetic rows
                       → trained, chunk-built snapshot, optionally a
                       registered epoch for ``ActivateEpoch``
  - ``autotune``     → measured ``nprobe`` calibration of a snapshot, an
                       optional throughput reading, ``--persist`` into its
                       manifest
  - ``benchmark``    → train / add / search times in the reference's CSV
                       schema
  - ``recall_test``  → recall@k against exact ground truth over an nprobe
                       sweep, IVF-Flat and IVF-PQ (± rerank)
  - ``load_test``    → concurrent gRPC load-test client (speaks only gRPC;
                       needs no device)
  - ``bench``        → the headline harness (the port of the root
                       ``bench.py``): QPS at recall@10 of a generated
                       corpus, one JSON line
"""


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for off
    CUDA), so that a host clock read after it covers the device's work."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

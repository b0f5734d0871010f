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
  - ``streaming_bench`` → the streaming tier at 20M x 768 (the port of
                       ``scripts/dev_streaming_bench.py``): int8 host
                       store, bounded device list cache, one JSON line
  - ``pq_capacity``  → the IVF-PQ capacity tier on that store
                       (``scripts/dev_pq_capacity.py``): ADC on the card,
                       exact host rerank
  - ``pq_sweep``     → IVF-PQ 1M x 768 configs ± rerank
                       (``scripts/dev_pq_sweep.py``)
"""


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for off
    CUDA), so that a host clock read after it covers the device's work."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_loop(fn, n: int, device) -> tuple[float, float | None]:
    """Call ``fn()`` ``n`` times back to back, keeping every result until
    the card is done. Returns the host clock's seconds from the first call
    to the card's last work, and on CUDA the ms a call between two CUDA
    events recorded around the loop on the current stream (None off CUDA):
    device time where ``fn`` only enqueues work, the stream's elapsed time,
    host gaps included, where ``fn`` waits for the card itself."""
    import time

    import torch

    cuda = torch.device(device).type == "cuda"
    synchronize(device)
    if cuda:
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
    t0 = time.perf_counter()
    results = [fn() for _ in range(n)]
    if cuda:
        ev1.record()
    synchronize(device)
    seconds = time.perf_counter() - t0
    del results
    return seconds, (ev0.elapsed_time(ev1) / n if cuda else None)


def peak_host_gb() -> float:
    """The process's peak resident set so far, GB (file pages it mapped and
    touched, such as a memmapped store, count)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9

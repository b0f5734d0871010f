"""One run of one cell: set-up, the measured window, the judgement.

Set-up (counted in ``setup_s``, from the process's start to the window's
first request):

1. the corpus and the query pool on the device from ``--seed``
   (``corpus.py``: each query's exact top-10 spread over the lists its
   search probes);
2. a ``VdbEngine`` from the configuration's engine file (the port's
   ``configs/production.yaml``), ``data_path`` in a temporary directory,
   the configuration's ``engine_overrides`` applied, and the index created
   through ``create_index`` with the arguments of the configuration's index
   kind (``index.kind``: ``kinds/<kind>.py``, ``create_args``);
3. the index built on the whole corpus by the kind's ``build``, through
   the port's own build calls;
4. the corpus freed, then the index installed as ``_load_epoch_into``
   installs a loaded epoch: ``warmup_lists`` at the coalescer's batch sizes
   and the cell's nprobe, the swap under the engine's lock, the coalescer;
   the nprobe that requests are served at (the index's calibration, else
   the engine's ``default_nprobe``) has to be the configuration's
   (the engine has no public entry for an index already built: a snapshot
   of the 10M index would write 15 GB a run);
5. one second of the cell's own traffic, unjudged, so that every shape the
   window uses has run once.

The window: ``--seconds`` of the cell's traffic through ``submit_search`` /
``finish_search``; with ``--trace 1``, profiler windows taken while it runs.
After it, the engine is closed and the index freed, and the plain
reference (``reference/exact.py``) judges every answer of the window
(``check.py``).
"""

from __future__ import annotations

import dataclasses
import gc
import os
import sys
import tempfile
import time

import numpy as np
import torch

from vdb_bench import check, readers, spec, trace, traffic
from vdb_bench.corpus import Corpus, query_pool
from vdb_bench.reference import exact

WARM_S = 1.0           # unjudged traffic at the end of set-up
DRAIN_S = 60.0         # longest wait for the window's last answers
LEAD_SHARE = 0.4       # share of a traced window before its first profile


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return (time.clock_gettime(time.CLOCK_BOOTTIME)
            - start_ticks / os.sysconf("SC_CLK_TCK"))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


class GcPauses:
    """Collector pauses of the interpreter (``gc.callbacks``) while
    installed: the engine shares the interpreter with the callers, so a
    long collection stalls every request at once."""

    def __init__(self):
        self.pauses: list[float] = []
        self._t = 0.0

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.pauses.append(time.perf_counter() - self._t)

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)

    def summary(self) -> str:
        p = self.pauses
        return (f"{len(p)} collections, {sum(p) * 1e3:.1f} ms in all, "
                f"longest {max(p, default=0.0) * 1e3:.2f} ms")


class Run:
    """What one run measured, for the metric readers (``metrics/``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def build_engine(cell: spec.Cell, data_path: str, device, extra: dict):
    """The engine of ``cell``'s configuration with its index created (not
    yet built)."""
    from cuda_acceleratedvectordatabaseengine_tpu_torch.server.config import (
        ServerConfig,
    )
    from cuda_acceleratedvectordatabaseengine_tpu_torch.server.service \
        import VdbEngine

    cfg = cell.config
    config = ServerConfig.from_yaml(
        str(spec.CHECKOUT / cfg["engine_config"])).apply_overrides(
            data_path=data_path, **cfg.get("engine_overrides", {}), **extra)
    engine = VdbEngine(config, device=device)
    ix = cfg["index"]
    m, nbits, tier = cell.kind.create_args(cfg)
    engine.create_index(cfg["name"], ix["dim"], ix["metric"], ix["nlist"],
                        m, nbits, tier)
    return engine


def install(engine, name: str, index, nprobe: int) -> None:
    """Go live as the engine's epoch activation does after its load step:
    warm-up at the coalescer's batch sizes and ``nprobe``, the swap under
    the engine's lock, the coalescer."""
    from cuda_acceleratedvectordatabaseengine_tpu_torch.utils.batching import (
        BUCKETS,
    )

    cap = engine.config.max_batch_size
    sizes = [b for b in BUCKETS if b <= cap]
    if cap not in sizes:
        sizes.append(cap)
    index.warmup_lists(batch_sizes=tuple(sizes), nprobes=(nprobe,))
    st = engine.get_state(name)
    with engine.lock:
        st.index = index
        st.epoch = "vdb_bench"
        st.error = ""
        if st.coalescer is None:
            st.coalescer = engine._make_coalescer(st)
    engine._update_memory_gauge()


def serving_params(engine, name: str, k: int):
    """The search parameters of a request with nprobe unset, resolved as
    the servicer resolves them: the index's calibration, else the engine's
    ``default_nprobe``."""
    from cuda_acceleratedvectordatabaseengine_tpu_torch.models.ivf_flat \
        import SearchParams

    st = engine.get_state(name)
    nprobe = (getattr(st.index, "calibrated_nprobe", None)
              or engine.config.default_nprobe)
    return SearchParams(nprobe=int(nprobe), k=k)


class Live:
    """A built index serving in its engine, with what the judgement and
    the readers need of its set-up (the index kind's ``facts`` among it)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def set_up(cell: spec.Cell, seed: int, dev, engine) -> Live:
    """Steps 1 to 4 of the module's set-up: data, build, install."""
    cfg = cell.config
    name = cfg["name"]
    t_fn = time.perf_counter()
    corpus = Corpus({**cfg["index"], **cfg["corpus"]}, seed, dev)
    x = corpus.all_rows()
    pool = query_pool(corpus, cfg["corpus"], seed).cpu().numpy()
    _sync(dev)
    gen_s = time.perf_counter() - t_fn
    index, train_s, build_s = cell.kind.build(engine, cfg, x, dev)
    del x
    _free(dev)
    k = int(cell.traffic["k"])
    nprobe = int(engine.config.default_nprobe)
    if nprobe != int(cfg["index"]["nprobe"]):
        raise ValueError(f"{name}: the engine serves nprobe {nprobe}, the "
                         f"configuration states {cfg['index']['nprobe']}")
    install(engine, name, index, nprobe)
    params = dataclasses.replace(serving_params(engine, name, k),
                                 **cell.kind.search_fields(cfg))
    if params.nprobe != int(cfg["index"]["nprobe"]):
        raise ValueError(f"{name}: requests are served at nprobe "
                         f"{params.nprobe}, the configuration states "
                         f"{cfg['index']['nprobe']}")
    facts = cell.kind.facts(index)
    log(f"[vdb_bench] built {name}: {index.ntotal} rows, "
        f"{facts.pop('summary')}, nprobe {params.nprobe}, k {k}; corpus "
        f"{gen_s:.2f} s, train {train_s:.2f} s, build {build_s:.2f} s")
    return Live(
        name=name, engine=engine, index=index, corpus=corpus, pool=pool, params=params, k=k, gen_s=gen_s,
        train_s=train_s, build_s=build_s, **facts)


def serve(live: Live, mix: dict, seed: int, seconds: float, phase: int,
          traced: bool = False, on_start=None) -> dict:
    """Drive ``seconds`` of ``mix`` through the engine; returns the
    requests (``cols``: ``traffic.Log.columns``), whether every caller ended
    (``ended``), the start (``t0``), and with ``traced`` the profiler
    windows (``windows``, taken after the first :data:`LEAD_SHARE` of the
    window) and the engine's stage percentiles over that untraced lead
    (``stages``): a window's export holds the interpreter and would count
    in the stages. ``on_start()`` runs just before the first request."""
    sched = traffic.Schedule(mix, live.pool.shape[0], seed, seconds, phase)
    if on_start is not None:
        on_start()
    t0 = time.perf_counter()
    threads, records = traffic.drive(live.engine, live.name, live.params,
                                     live.pool, sched, t0)
    out = {"t0": t0, "windows": [], "stages": None}
    if traced:
        time.sleep(LEAD_SHARE * seconds)
        out["stages"] = live.engine.metrics.get_stage_percentiles()
        out["windows"] = trace.take_windows(
            lambda: time.perf_counter() > t0 + seconds - trace.WINDOW_S,
            log=lambda m: log(f"[vdb_bench] {m}"))
    out["ended"] = traffic.join(
        threads, max(t0 + seconds - time.perf_counter(), 0) + DRAIN_S)
    out["cols"] = records.columns()
    out["notes"] = records.notes
    return out


def take_down(live: Live, dev) -> None:
    """Close the engine and free the index."""
    live.engine.close()
    with live.engine.lock:
        live.engine.get_state(live.name).index = None
    live.index = None
    _free(dev)


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device="cuda", extra_overrides: dict | None = None) -> dict:
    """One run of ``cell``; returns the result object (without the process
    checks of ``run.py``) and logs the rest to standard error.
    ``extra_overrides`` (engine settings on top of the configuration's)
    serve the control runs of ``readings.py``."""
    dev = torch.device(device)
    with tempfile.TemporaryDirectory(prefix="vdb-bench-") as data_path:
        engine = build_engine(cell, data_path, dev, extra_overrides or {})
        try:
            return _run(cell, seed, seconds, traced, dev, engine)
        finally:
            engine.close()


def _run(cell, seed, seconds, traced, dev, engine) -> dict:
    on_card = dev.type == "cuda"
    live = set_up(cell, seed, dev, engine)
    if not serve(live, cell.traffic, seed, WARM_S, phase=0)["ended"]:
        raise RuntimeError("the warm-up's requests did not end")
    if traced:
        trace.warm_profiler()
    _sync(dev)
    setup_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    coalescer = engine.get_state(live.name).coalescer
    co0 = coalescer.stats()
    mark = {}

    def start():
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        engine.metrics.reset_windows()
        mark["setup_s"] = process_age_s()

    with GcPauses() as gc_pauses:
        served = serve(live, cell.traffic, seed, seconds, phase=1,
                       traced=traced, on_start=start)
    log(f"[vdb_bench] collector in the window: {gc_pauses.summary()}")
    cols, windows, ended = (served["cols"], served["windows"],
                            served["ended"])
    t0 = served["t0"]
    t_close = t0 + seconds
    _sync(dev)
    window_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    stages = served["stages"] or engine.metrics.get_stage_percentiles()
    co1 = coalescer.stats()
    take_down(live, dev)

    t_ref = time.perf_counter()
    pool_dev = torch.from_numpy(live.pool).to(dev)
    _, truth_i = exact.exact_topk(pool_dev, live.corpus.chunks(), live.k)
    verdict = check.judge(cols, pool_dev, truth_i, live.corpus,
                          cell.config, ended)
    _sync(dev)
    del truth_i
    bounds = []

    def batch_bounds():
        if not bounds:
            bounds.extend(cell.kind.bounds(cols, pool_dev, live, cell.config,
                                           live.k))
        return bounds
    batches = co1["batches"] - co0["batches"]
    log(f"[vdb_bench] window {seconds} s: {len(cols['request'])} requests, "
        f"{verdict['answered_queries']} queries answered, {batches} device "
        f"batches ({(co1['items'] - co0['items']) / max(batches, 1):.3f} "
        f"requests a batch), shed {co1['shed'] - co0['shed']}; reference "
        f"{time.perf_counter() - t_ref:.2f} s")
    n_due = int((cols["t_due"] < t_close).sum())
    tail = Run(cols=cols, t_close=t_close)
    log(f"[vdb_bench] latency ms over {n_due} requests: p50 "
        f"{readers.latency_ms(tail, 0.5)}, p99 {readers.latency_ms(tail, 0.99)}"
        f", max {readers.latency_ms(tail, 1.0)}")
    late = cols["t_sent"] - cols["t_due"]
    if late.size:
        log(f"[vdb_bench] sender lateness ms: p50 "
            f"{np.percentile(late, 50) * 1e3:.3f}, p99 "
            f"{np.percentile(late, 99) * 1e3:.3f}, max "
            f"{late.max() * 1e3:.3f}")
    if cols["status"].any():
        failed = cols["status"] != traffic.OK
        log(f"[vdb_bench] {int(failed.sum())} requests failed or were "
            f"refused; first: {next(iter(served['notes'].values()), '')}")
    run = Run(cell=cell, seconds=seconds, t0=t0, t_close=t_close,
              cols=cols, verdict=verdict, setup_s=mark["setup_s"],
              train_s=live.train_s, build_s=live.build_s, gen_s=live.gen_s,
              arena_bytes=live.arena_bytes, window_peak=window_peak,
              stages=stages, windows=windows, batch_bounds=batch_bounds,
              batches=batches, on_card=on_card,
              log=lambda m: log(f"[vdb_bench] {m}"))
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.load_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = cols["t_due"] < t_close
    result = {
        "correct": verdict["correct"],
        "attempted": int(attempted.sum()),
        "failed": int((cols["status"][attempted] != traffic.OK).sum()),
        "metrics": metrics,
        "device": _device(dev, max(setup_peak, window_peak)),
    }
    if traced:
        busy_s, window_s = trace.busy_and_span(windows)
        result["device"].update(busy_s=busy_s, window_s=window_s)
        result["breakdown"] = trace.breakdown(windows)
    result["checks"] = verdict["checks"]
    return result


def _device(dev, peak: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": int(peak)}

"""The benchmark of the PyTorch / CUDA vector database
(``cuda_acceleratedvectordatabaseengine_tpu_torch``): its served path,
``server/service.VdbEngine``, driven in process the way the gRPC servicer
drives it once it has decoded a request.

One run is ``python3 -m vdb_bench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``; ``README.md`` gives the layout and how a
configuration, a traffic mix or a metric is added as files of its own.
"""

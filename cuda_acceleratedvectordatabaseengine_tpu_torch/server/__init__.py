"""Serving layer of the port (the JAX package's ``server/``, same module
names).

  - ``service``   → ``VdbEngine`` (index registry, epochs, admission, the
                    coalesced search path) and the ``QueryServiceImpl`` /
                    ``AdminServiceImpl`` gRPC servicers
  - ``coalescer`` → windowed request batcher feeding one device batch
  - ``ratelimit`` → token-bucket rate limiter
  - ``balancer``  → circuit breaker / concurrency caps / adaptive batch /
                    priority queue
  - ``metrics``   → latency and stage percentiles, Prometheus text and a
                    ``/metrics`` + ``/health`` HTTP endpoint
  - ``health``    → grpc.health.v1 protocol
  - ``config``    → ``ServerConfig``: YAML (a built-in reader) + CLI
  - ``grpc_api``  → method wiring and client stubs
  - ``main``      → ``build_server`` and the command line

The engine path (``service.VdbEngine``, ``config``, ``metrics``) needs
neither ``grpc``, ``protobuf``, PyYAML nor ``prometheus_client``; the
servicers, ``grpc_api`` and ``main`` need ``grpcio`` and ``protobuf``.
"""

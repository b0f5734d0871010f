"""Server bootstrap (port of the JAX package's ``server/main.py``): CLI +
YAML config, data-dir creation, device banner, gRPC server with the health
service, metrics endpoint, graceful SIGINT / SIGTERM shutdown.

    python -m cuda_acceleratedvectordatabaseengine_tpu_torch.server.main \\
        --config configs/production.yaml --data-path /tmp/vdb

Needs ``grpcio`` and ``protobuf``. The engine runs on the card unless
``build_server`` is given another device (the tests pass ``"cpu"``).
``--profile-port`` serves on-demand ``torch.profiler`` captures
(``utils/profiling.start_trace_server``: ``GET /trace?ms=N``).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import hmac
import os
import signal
import subprocess
import threading

import grpc

from cuda_acceleratedvectordatabaseengine_tpu_torch.server.config import (
    ServerConfig,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.server.grpc_api import (
    admin_service_handler,
    health_service_handler,
    query_service_handler,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.server.health import (
    HealthServicer,
)
from cuda_acceleratedvectordatabaseengine_tpu_torch.server.service import (
    AdminServiceImpl,
    QueryServiceImpl,
    VdbEngine,
)


class BearerAuthInterceptor(grpc.ServerInterceptor):
    """Static bearer-token auth: every vdb.* RPC must carry
    ``authorization: Bearer <token>`` metadata, compared in constant time
    (``hmac.compare_digest``); the gRPC health service stays open so k8s
    probes and load-balancer health checks work unauthenticated."""

    _STREAM_STREAM = {"/vdb.QueryService/StreamSearch"}

    def __init__(self, token: str):
        self._expected = f"Bearer {token}".encode()

        def abort_unary(request, context):
            context.abort(grpc.StatusCode.UNAUTHENTICATED,
                          "missing or invalid bearer token")

        def abort_stream(request_iterator, context):
            context.abort(grpc.StatusCode.UNAUTHENTICATED,
                          "missing or invalid bearer token")
            yield  # pragma: no cover — abort raises

        self._abort_unary = grpc.unary_unary_rpc_method_handler(abort_unary)
        self._abort_stream = grpc.stream_stream_rpc_method_handler(
            abort_stream
        )

    def intercept_service(self, continuation, handler_call_details):
        method = handler_call_details.method
        if method.startswith("/grpc.health."):
            return continuation(handler_call_details)
        md = dict(handler_call_details.invocation_metadata or ())
        got = md.get("authorization", "")
        if isinstance(got, str):
            got = got.encode()
        if hmac.compare_digest(got, self._expected):
            return continuation(handler_call_details)
        if method in self._STREAM_STREAM:
            return self._abort_stream
        return self._abort_unary


def _server_credentials(config: ServerConfig) -> grpc.ServerCredentials:
    """TLS credentials from the configured PEM files; a CA file upgrades
    to mutual TLS."""
    if not (config.tls_cert_file and config.tls_key_file):
        raise ValueError(
            "enable_tls requires tls_cert_file and tls_key_file"
        )
    with open(config.tls_key_file, "rb") as f:
        key = f.read()
    with open(config.tls_cert_file, "rb") as f:
        cert = f.read()
    ca = None
    if config.tls_ca_file:
        with open(config.tls_ca_file, "rb") as f:
            ca = f.read()
    return grpc.ssl_server_credentials(
        [(key, cert)],
        root_certificates=ca,
        require_client_auth=ca is not None,
    )


def build_server(config: ServerConfig, device=None, mesh=None):
    """Construct ``(grpc.Server, VdbEngine, HealthServicer, port)`` with
    the engine on ``device`` (``"cuda"`` unless another is named) and an
    optional explicit serving ``mesh``; separate from :func:`main` so
    tests run an in-process server on an ephemeral port."""
    engine = VdbEngine(config, device=device, mesh=mesh)
    query = QueryServiceImpl(engine)
    admin = AdminServiceImpl(engine)
    health = HealthServicer(device=engine.device)
    token = config.resolved_auth_token()
    server = grpc.server(
        concurrent.futures.ThreadPoolExecutor(
            max_workers=config.grpc_workers,
            thread_name_prefix="grpc-worker",
        ),
        options=[
            ("grpc.max_receive_message_length",
             config.max_message_mb * 1024 * 1024),
            ("grpc.max_send_message_length",
             config.max_message_mb * 1024 * 1024),
        ],
        interceptors=(
            (BearerAuthInterceptor(token),) if token else ()
        ),
    )
    server.add_generic_rpc_handlers((
        query_service_handler(query),
        admin_service_handler(admin),
        health_service_handler(health),
    ))
    if config.enable_tls:
        port = server.add_secure_port(
            config.address, _server_credentials(config)
        )
    else:
        port = server.add_insecure_port(config.address)
    return server, engine, health, port


def device_banner(device) -> str:
    """The serving device: its name and, on a card, its power limit as
    ``nvidia-smi`` reports it."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return f"[vdb] device: {dev}"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    line = f"[vdb] device: {dev} {torch.cuda.get_device_name(index)}"
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", f"--id={index}"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout.strip()
        line += f", power limit {limit}"
    except (OSError, subprocess.SubprocessError):
        line += ", power limit not readable"
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Vector DB server (PyTorch)")
    p.add_argument("--config", help="YAML config file")
    p.add_argument("--address", help="listen address host:port")
    p.add_argument("--data-path", dest="data_path")
    p.add_argument("--batch-size", dest="max_batch_size", type=int)
    p.add_argument("--coalesce-window", dest="coalesce_window_ms",
                   type=float, help="ms")
    p.add_argument("--metrics-port", dest="metrics_port", type=int)
    p.add_argument("--profile-port", dest="profile_port", type=int,
                   help="on-demand profiler traces: GET /trace?ms=N")
    p.add_argument("--shard-serving", dest="shard_serving",
                   choices=("auto", "on", "off"),
                   help="sharded serving over a device mesh")
    p.add_argument("--device", default=None,
                   help="serving device (default: cuda)")
    args = p.parse_args(argv)

    config = (
        ServerConfig.from_yaml(args.config) if args.config else ServerConfig()
    )
    config = config.apply_overrides(
        address=args.address,
        data_path=args.data_path,
        max_batch_size=args.max_batch_size,
        coalesce_window_ms=args.coalesce_window_ms,
        metrics_port=args.metrics_port,
        profile_port=args.profile_port,
        shard_serving=args.shard_serving,
    )
    os.makedirs(config.data_path, exist_ok=True)
    tracer = None
    if config.profile_port:
        # before the engine loads its indexes: a taken port fails at once
        from cuda_acceleratedvectordatabaseengine_tpu_torch.utils.profiling \
            import start_trace_server

        tracer = start_trace_server(config.profile_port)

    server, engine, health, port = build_server(config, device=args.device)
    print(device_banner(engine.device))
    if engine.mesh is not None:
        print(f"[vdb] sharded serving over {engine.mesh.devices.size} "
              f"devices")
    print(f"[vdb] listening on {config.address}, data at {config.data_path}")
    if tracer is not None:
        print(f"[vdb] profiler traces on :{tracer.server_address[1]}"
              f"/trace?ms=N (Chrome-trace JSON)")
    if config.enable_tls:
        mode = "mTLS" if config.tls_ca_file else "TLS"
        print(f"[vdb] {mode} enabled ({config.tls_cert_file})")
    if config.auth_token:
        print("[vdb] bearer-token auth required on vdb.* RPCs")
    if config.metrics_enabled:
        try:
            engine.metrics.start_exposition(
                config.metrics_port, health_fn=health.snapshot
            )
            print(
                f"[vdb] metrics on :{config.metrics_port}/metrics, "
                f"health on :{config.metrics_port}/health"
            )
        except OSError as e:
            print(f"[vdb] metrics endpoint unavailable: {e}")
    server.start()

    stop_event = threading.Event()

    def handle(signum, _frame):
        print(f"[vdb] signal {signum}, shutting down...")
        health.set_status("", False)
        stop_event.set()

    signal.signal(signal.SIGINT, handle)
    signal.signal(signal.SIGTERM, handle)
    stop_event.wait()
    health.stop()
    server.stop(grace=5).wait()
    if tracer is not None:
        tracer.shutdown()
        tracer.server_close()
    engine.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""grpc.health.v1 health service (port of the JAX package's
``server/health.py``).

System health = the engine's device usable (one tiny torch op on it,
synchronised) ∧ the service marked up. ``Check`` never touches the device:
a background thread polls :func:`device_usable` every ``poll_interval_s``
and ``Check`` reads the last-known flag, so a probe never waits behind a
long device batch. The module imports no protobuf: ``Check`` and ``Watch``
build their ``health_pb2`` messages when they are called.
"""

from __future__ import annotations

import threading
import time

import torch

# grpc.health.v1.HealthCheckResponse.ServingStatus values
SERVING = 1
NOT_SERVING = 2
SERVICE_UNKNOWN = 3


def device_usable(device: torch.device | str = "cuda") -> bool:
    """Probe ``device`` with a real tiny computation."""
    try:
        dev = torch.device(device)
        out = torch.zeros(1, device=dev) + 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return bool(out.item() == 1)
    except Exception:  # noqa: BLE001
        return False


class HealthServicer:
    def __init__(self, poll_interval_s: float = 5.0,
                 device: torch.device | str = "cuda"):
        self._status: dict[str, int] = {"": SERVING}
        self._lock = threading.Lock()
        self.poll_interval_s = poll_interval_s
        self.device = device
        self._device_ok = True
        # set after each finished probe: a caller can wait for the first
        # verdict instead of guessing how long a probe takes
        self.probed = threading.Event()
        self._stopped = threading.Event()
        self._poller = threading.Thread(
            target=self._poll_loop, name="health-device-probe", daemon=True
        )
        self._poller.start()

    def stop(self) -> None:
        self._stopped.set()

    def set_status(self, service: str, serving: bool) -> None:
        with self._lock:
            self._status[service] = SERVING if serving else NOT_SERVING

    def _poll_loop(self) -> None:
        while not self._stopped.is_set():
            self._device_ok = device_usable(self.device)
            self.probed.set()
            self._stopped.wait(self.poll_interval_s)

    def _check(self, service: str) -> int:
        with self._lock:
            if service not in self._status:
                return SERVICE_UNKNOWN
            st = self._status[service]
        if st == SERVING and not self._device_ok:
            return NOT_SERVING
        return st

    def snapshot(self) -> dict:
        """Health as a dict for the HTTP ``/health`` endpoint."""
        return {
            "healthy": self._check("") == SERVING,
            "device_ok": self._device_ok,
        }

    # gRPC handlers ------------------------------------------------------ #

    def Check(self, request, context):
        from cuda_acceleratedvectordatabaseengine_tpu_torch.server.proto \
            import health_pb2

        return health_pb2.HealthCheckResponse(
            status=self._check(request.service)
        )

    def Watch(self, request, context):
        from cuda_acceleratedvectordatabaseengine_tpu_torch.server.proto \
            import health_pb2

        last = None
        while context.is_active():
            st = self._check(request.service)
            if st != last:
                yield health_pb2.HealthCheckResponse(status=st)
                last = st
            time.sleep(self.poll_interval_s)

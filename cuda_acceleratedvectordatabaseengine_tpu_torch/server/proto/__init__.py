"""Generated protobuf modules (see ``regen.sh``; committed because the
``grpc_tools`` codegen wheel is not available in the runtime image — plain
``protoc --python_out`` suffices since service stubs are hand-wired in
``..grpc_api``).

A copy of the JAX package's ``server/proto/__init__.py`` (the port imports
nothing of that package).
"""

from cuda_acceleratedvectordatabaseengine_tpu_torch.server.proto import vdb_pb2
from cuda_acceleratedvectordatabaseengine_tpu_torch.server.proto import health_pb2

__all__ = ["vdb_pb2", "health_pb2"]

#!/usr/bin/env bash
# Regenerate *_pb2.py from the .proto sources.
set -euo pipefail
cd "$(dirname "$0")"
protoc -I. -I/usr/include --python_out=. vdb.proto health.proto
echo "regenerated vdb_pb2.py health_pb2.py"

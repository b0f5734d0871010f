"""Server configuration: dataclass ← YAML ← CLI (port of the JAX
package's ``server/config.py``, every key kept).

The card's machine has no PyYAML, so ``from_yaml`` reads the file with
:func:`load_yaml`, a reader of the YAML subset ``configs/production.yaml``
uses: nested block mappings, flow lists of scalars, comments, and plain or
quoted scalars resolved as ``yaml.safe_load`` resolves them (YAML 1.1:
``yes`` / ``on`` are booleans, a float's exponent needs a sign). Anything
outside that subset raises ``ValueError``.

Each value is then coerced to its field's declared type. The JAX package
skips this step, so ``prefetch_bandwidth_bps: 10.0e9`` (a string under YAML
1.1) reaches its prefetch scheduler as a string, whose throttle then raises
on every staging task.
"""

from __future__ import annotations

import dataclasses
import os
import re

# YAML 1.1 scalar resolution as PyYAML's SafeLoader does it (its resolver
# patterns; sexagesimal numbers and the 0x / 0b / 0-octal integer forms
# are outside the subset and raise).
_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_FLOAT = re.compile(
    r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?")
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)")
_OTHER_INT = re.compile(
    r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?")
_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_.-]*")


def _plain(text: str, where: str):
    """A plain scalar's value: None, bool, int, float or str."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.fullmatch(text):
        return int(text.replace("_", ""))
    if _FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    m = _INF.fullmatch(text)
    if m:
        return float(m.group(1) + "inf")
    if _NAN.fullmatch(text):
        return float("nan")
    if _OTHER_INT.fullmatch(text):
        raise ValueError(f"{where}: number form {text!r} is outside the "
                         f"supported YAML subset")
    if (text[0] in "&*!|>%@`{}[],#" or text[:2] in ("- ", "? ", ": ")
            or ": " in text or text.endswith(":")):
        raise ValueError(f"{where}: {text!r} is outside the supported YAML "
                         f"subset")
    return text


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "n": "\n",
            "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ",
            '"': '"', "/": "/", "\\": "\\"}


def _quoted(text: str, i: int, where: str) -> tuple[str, int]:
    """The quoted string starting at ``text[i]``; returns (value, index
    past the closing quote)."""
    q = text[i]
    out = []
    j = i + 1
    while j < len(text):
        c = text[j]
        if q == "'" and c == "'":
            if text[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == '"':
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            e = text[j + 1:j + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                j += 2
                continue
            if e in ("x", "u", "U"):
                n = {"x": 2, "u": 4, "U": 8}[e]
                digits = text[j + 2:j + 2 + n]
                if len(digits) != n or not re.fullmatch(r"[0-9a-fA-F]+",
                                                        digits):
                    raise ValueError(f"{where}: bad escape \\{e}{digits}")
                out.append(chr(int(digits, 16)))
                j += 2 + n
                continue
            raise ValueError(f"{where}: unsupported escape \\{e}")
        out.append(c)
        j += 1
    raise ValueError(f"{where}: unterminated quoted string (multi-line "
                     f"scalars are outside the supported YAML subset)")


def _strip_comment(text: str) -> str:
    """``text`` up to a ``#`` that starts a comment (at the start or after
    whitespace, outside quotes)."""
    quote = None
    i = 0
    while i < len(text):
        c = text[i]
        if quote:
            if c == "\\" and quote == '"':
                i += 2
                continue
            if c == quote:
                if quote == "'" and text[i + 1:i + 2] == "'":
                    i += 2
                    continue
                quote = None
        elif c in "\"'" and (i == 0 or text[i - 1] in " \t[,"):
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def _flow_list(text: str, where: str) -> list:
    """``[a, "b", 3]``: a flow list of scalars (no nesting)."""
    inner = text[1:-1].strip()
    items: list = []
    if not inner:
        return items
    i = 0
    while True:
        while i < len(inner) and inner[i] == " ":
            i += 1
        if i < len(inner) and inner[i] in "\"'":
            val, i = _quoted(inner, i, where)
            while i < len(inner) and inner[i] == " ":
                i += 1
        else:
            j = inner.find(",", i)
            j = len(inner) if j < 0 else j
            token = inner[i:j].strip()
            if not token or any(c in token for c in "[]{}"):
                raise ValueError(f"{where}: flow list item {token!r} is "
                                 f"outside the supported YAML subset")
            val, i = _plain(token, where), j
        items.append(val)
        if i >= len(inner):
            return items
        if inner[i] != ",":
            raise ValueError(f"{where}: expected ',' in flow list {text!r}")
        i += 1
        if not inner[i:].strip():
            raise ValueError(f"{where}: trailing ',' in flow list {text!r}")


def _value(text: str, where: str):
    if not text:
        return None
    if text[0] in "\"'":
        val, end = _quoted(text, 0, where)
        if text[end:].strip():
            raise ValueError(f"{where}: text after a quoted scalar")
        return val
    if text[0] == "[":
        if not text.endswith("]"):
            raise ValueError(f"{where}: multi-line flow lists are outside "
                             f"the supported YAML subset")
        return _flow_list(text, where)
    return _plain(text, where)


def load_yaml(text: str):
    """Parse ``text`` in the supported YAML subset; an empty document is
    ``None``, as with ``yaml.safe_load``."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"line {n}"
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError(f"{where}: tab indentation")
        body = _strip_comment(raw)
        if not body.strip():
            continue
        if body.startswith(("---", "...")) or body.lstrip().startswith(
                ("- ", "? ")) or body.strip() == "-":
            raise ValueError(f"{where}: documents markers, block sequences "
                             f"and complex keys are outside the supported "
                             f"YAML subset")
        lines.append((len(body) - len(body.lstrip(" ")), body.strip(), where))
    if not lines:
        return None

    def mapping(i: int, indent: int) -> tuple[dict, int]:
        out: dict = {}
        while i < len(lines):
            ind, body, where = lines[i]
            if ind < indent:
                break
            if ind > indent:
                raise ValueError(f"{where}: unexpected indentation (multi-line "
                                 f"scalars are outside the supported subset)")
            key, sep, rest = body.partition(":")
            if not sep or (rest and rest[0] != " "):
                raise ValueError(f"{where}: expected 'key: value'")
            if not _KEY.fullmatch(key):
                raise ValueError(f"{where}: key {key!r} is outside the "
                                 f"supported YAML subset")
            rest = rest.strip()
            i += 1
            if rest:
                out[key] = _value(rest, where)
            elif i < len(lines) and lines[i][0] > indent:
                out[key], i = mapping(i, lines[i][0])
            else:
                out[key] = None
        return out, i

    top, end = mapping(0, lines[0][0])
    if end != len(lines):
        raise ValueError(f"{lines[end][2]}: indentation below the document's")
    return top


def _coerce(name: str, kind: str, value):
    """``value`` as the declared type ``kind`` of field ``name``."""
    if kind == "float" and not isinstance(value, bool):
        if isinstance(value, (int, float)):
            return float(value)
        if isinstance(value, str):
            try:
                return float(value)
            except ValueError:
                pass
    elif kind == "int" and isinstance(value, int) \
            and not isinstance(value, bool):
        return value
    elif kind == "bool" and isinstance(value, bool):
        return value
    elif kind == "str" and isinstance(value, str):
        return value
    elif kind == "tuple" and isinstance(value, (list, tuple)):
        return tuple(value)
    raise ValueError(f"config key {name}: {value!r} is not a {kind}")


@dataclasses.dataclass
class ServerConfig:
    # server
    address: str = "0.0.0.0:50051"
    data_path: str = "/data/vdb"
    max_batch_size: int = 64
    coalesce_window_ms: float = 2.0
    # StreamSearch: max requests pipelined into the coalescer per stream
    # before responses are awaited (in-order delivery; bounds per-stream
    # admission-slot hold).
    stream_window: int = 8
    max_message_mb: int = 100
    grpc_workers: int = 16

    # device
    device_memory_limit_gb: float = 0.0     # 0 = no explicit cap
    arena_dtype: str = "bfloat16"
    # H2D transport dtype of search queries. Only "float32" is ported: the
    # engine raises on any other value.
    query_upload_dtype: str = "float32"
    # Device budget of a streaming-tier index's list cache (0 = auto:
    # ~nlist/4 slots, at least one probe column of the largest batch).
    streaming_cache_bytes: int = 0
    # Eviction policy for that cache. lfu (default) pins the hot working
    # set when it exceeds the slot count; lru degenerates to ~0% hits on
    # cyclic wave scans over a too-large working set.
    streaming_cache_policy: str = "lfu"
    # PQ capacity tier (tier: pq_capacity): device-side ADC shortlist depth
    # fed to the host-store exact reranker on rerank_exact searches.
    pq_rerank_k: int = 128
    # Adaptive rerank depth: candidates beyond (1+margin)x the query's
    # k-th ADC distance skip the host gather+dot (0 = fixed depth).
    pq_rerank_margin: float = 0.0

    # Sharded serving over a device mesh (parallel/): auto | on | off.
    # "auto" builds a mesh only over more than one device, "on" always
    # (one shard on one device), "off" never; mesh_shards shards over the
    # first visible CUDA devices (more than are visible raises), or that
    # many CPU shards for an engine on the CPU.
    shard_serving: str = "auto"
    mesh_shards: int = 0        # 0 = all visible devices
    # Profiler trace server port (0 = disabled): GET /trace?ms=N answers
    # with a Chrome trace (utils/profiling.start_trace_server).
    profile_port: int = 0

    # rate limiting (requests per second, token bucket)
    rate_limit_rps: float = 10000.0
    rate_limit_burst: int = 200

    # circuit breaker
    breaker_error_threshold: float = 0.5
    breaker_open_seconds: float = 30.0
    breaker_decay: float = 0.95
    max_concurrent_requests: int = 256
    # Fail-fast bound on the per-index coalescer backlog (0 = unbounded):
    # submissions past this are shed with RESOURCE_EXHAUSTED instead of
    # queueing work that will outlive its adaptive deadline.
    max_queued_requests: int = 1024

    # metrics
    metrics_port: int = 8080
    metrics_enabled: bool = True

    # security: TLS terminates in grpc's server credentials; auth is a
    # static bearer token checked by a server interceptor on every vdb.*
    # RPC (health stays open for k8s probes).
    enable_tls: bool = False
    tls_cert_file: str = ""          # PEM server certificate chain
    tls_key_file: str = ""           # PEM private key
    tls_ca_file: str = ""            # set → mutual TLS (client certs
                                     # verified against this CA)
    # Non-empty → require `authorization: Bearer <token>` metadata.
    # "$VAR" reads the token from the environment at startup.
    auth_token: str = ""

    # Hotness-driven residency: every this-many seconds the engine queues
    # each streaming-tier index's decayed-hot lists for re-staging into its
    # device cache through the throttled PrefetchScheduler. 0 = disabled.
    prefetch_hot_interval_s: float = 5.0
    # byte-rate throttle for background staging
    prefetch_bandwidth_bps: float = 10e9

    # Chunked epoch builds: rows streamed off the source file per chunk
    # (peak host RAM ≈ one chunk). BuildEpoch never holds the corpus.
    build_chunk_rows: int = 500_000

    # index defaults
    default_nlist: int = 1024
    default_nprobe: int = 8
    # Opt-in: calibrate nprobe from measured probe coverage at every
    # epoch build and persist it in the manifest; nprobe-unset requests
    # then serve at the calibrated point instead of default_nprobe.
    auto_calibrate_nprobe: bool = False
    keep_epochs: int = 3
    # Serving operating points warmed at activation (default_nprobe and a
    # persisted calibration are always included).
    warm_nprobes: tuple = (32,)

    @classmethod
    def from_yaml(cls, path: str) -> "ServerConfig":
        with open(path) as f:
            raw = load_yaml(f.read()) or {}
        if not isinstance(raw, dict):
            raise ValueError(f"{path}: the document is not a mapping")
        # Accept both flat keys and the nested production.yaml style
        # ({server: {...}, batching: {...}, ...}).
        flat: dict = {}
        for key, val in raw.items():
            if isinstance(val, dict):
                flat.update(val)
            else:
                flat[key] = val
        fields = {f.name: f.type for f in dataclasses.fields(cls)}
        aliases = {
            "listen_address": "address",
            "window_ms": "coalesce_window_ms",
            "requests_per_second": "rate_limit_rps",
            "burst": "rate_limit_burst",
            "error_threshold": "breaker_error_threshold",
            "port": "metrics_port",
            "nlist": "default_nlist",
            "nprobe": "default_nprobe",
            "cert_file": "tls_cert_file",
            "key_file": "tls_key_file",
            "ca_file": "tls_ca_file",
        }
        kwargs = {}
        for k, v in flat.items():
            k = aliases.get(k, k)
            if k in fields:
                kwargs[k] = _coerce(k, fields[k], v)
        # The legacy multi-GPU bool maps onto the mesh mode (an explicit
        # shard_serving key wins over it).
        if "enable_multi_gpu" in flat and "shard_serving" not in kwargs:
            kwargs["shard_serving"] = (
                "auto" if flat["enable_multi_gpu"] else "off"
            )
        # `enable_auth` is accepted, but never as a dead knob: enabling it
        # without a token is a config error.
        if flat.get("enable_auth") and not kwargs.get("auth_token"):
            raise ValueError(
                "enable_auth: true requires auth_token "
                "(use auth_token: \"$VDB_AUTH_TOKEN\" to read it from "
                "the environment)"
            )
        return cls(**kwargs)

    def resolved_auth_token(self) -> str:
        """The bearer token with `$VAR` indirection resolved (empty =
        auth disabled). A $VAR that is unset is a startup error, not a
        silently-open server."""
        tok = self.auth_token
        if tok.startswith("$"):
            val = os.environ.get(tok[1:], "")
            if not val:
                raise ValueError(
                    f"auth_token references unset environment "
                    f"variable {tok[1:]}"
                )
            return val
        return tok

    def apply_overrides(self, **kv) -> "ServerConfig":
        updates = {k: v for k, v in kv.items() if v is not None}
        return dataclasses.replace(self, **updates)

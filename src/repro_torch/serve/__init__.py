"""BlazeServe: a long-lived multi-tenant query service over one resident
:class:`~repro_torch.core.session.BlazeSession` (the port of
``repro/serve``, with its 24 exports).

Datasets stay on the device, compiled programs (on the card, captured CUDA
graphs and their pools) are reused across requests and tenants
(``plan_hash`` keyed), and compatible concurrent queries micro-batch into
one dispatch with one host sync a batch.

Layered as::

    client.py     BlazeClient / RemoteServeError      (wire, stdlib HTTP)
    server.py     BlazeServer                         (accept + dispatch)
    admission.py  AdmissionQueue + typed ServeErrors  (bounded, per-tenant)
    batching.py   dedup_groups                        (micro-batch policy)
    queries.py    QuerySpec / PreparedQuery           (prepared statements)
    stats.py      ServerStats                         (/stats invariants)
    codec.py      encode/decode_payload               (bit-faithful arrays)

Entry point: ``python -m repro_torch.launch.serve`` (``--device cpu`` for a
server on the CPU).  Nothing here imports JAX or the ``repro`` package.
"""
from repro_torch.serve.admission import (
    AdmissionQueue,
    BadParamsError,
    MalformedRequestError,
    QueryExecutionError,
    QueueFullError,
    Request,
    RequestTimeoutError,
    ServeError,
    ServerClosedError,
    TenantLimitError,
    UnknownDatasetError,
    UnknownQueryError,
)
from repro_torch.serve.client import BlazeClient, RemoteServeError
from repro_torch.serve.codec import decode_payload, encode_payload
from repro_torch.serve.queries import (
    DatasetEntry,
    PreparedQuery,
    QuerySpec,
    ServeResources,
    builtin_specs,
    run_direct,
)
from repro_torch.serve.server import BlazeServer
from repro_torch.serve.stats import ServerStats

__all__ = [
    "AdmissionQueue",
    "BadParamsError",
    "BlazeClient",
    "BlazeServer",
    "DatasetEntry",
    "MalformedRequestError",
    "PreparedQuery",
    "QueryExecutionError",
    "QuerySpec",
    "QueueFullError",
    "RemoteServeError",
    "Request",
    "RequestTimeoutError",
    "ServeError",
    "ServeResources",
    "ServerClosedError",
    "ServerStats",
    "TenantLimitError",
    "UnknownDatasetError",
    "UnknownQueryError",
    "builtin_specs",
    "decode_payload",
    "encode_payload",
    "run_direct",
]

"""Cross-pod transfer layer (port of ``repro.transfer``): versioned wire
format + transports.

``wire`` encodes FlatParams payloads (dense buffers or compress_flat
top-k + int8 deltas) into self-describing checksummed byte frames;
``transport`` carries them, in memory or across a real OS process
boundary.  The simulator, the pod schemes and the wall-clock runtime put
REAL bytes on the wire through this package — transfer sizes are
measured, not assumed.
"""
from repro_torch.transfer.transport import (LoopbackTransport,
                                            ProcessTransport, Transport,
                                            TransportError, TransportStats)
from repro_torch.transfer.wire import (HEADER_BYTES, KIND_DENSE,
                                       KIND_SPARSE, WIRE_VERSION, WireError,
                                       WireMessage, decode,
                                       dense_frame_bytes, encode,
                                       encode_dense, encode_sparse,
                                       sparse_frame_bytes)

__all__ = [
    "LoopbackTransport", "ProcessTransport", "Transport", "TransportError",
    "TransportStats",
    "HEADER_BYTES", "KIND_DENSE", "KIND_SPARSE", "WIRE_VERSION",
    "WireError", "WireMessage", "decode", "dense_frame_bytes", "encode",
    "encode_dense", "encode_sparse", "sparse_frame_bytes",
]

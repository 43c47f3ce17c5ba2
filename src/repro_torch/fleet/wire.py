"""Length-prefixed, versioned wire codec of the disaggregated trainer
(port of ``repro/fleet/wire.py``).

Frame layout (network byte order, 16-byte header)::

    !4s  magic     b"TIDE"
    B    version   WIRE_VERSION (1)
    B    ftype     frame type (FT_*)
    H    flags     reserved (must be 0)
    I    length    payload byte count (<= MAX_PAYLOAD)
    I    crc32     zlib.crc32 of the payload

Payloads are JSON control dicts or .npz tensor containers.  The tensor
container is the ``core.signals`` shard schema (``pack_batches``:
per-batch keys, a ``__schema__`` tag), so a spilled .npz shard and a
SIGNALS payload are interchangeable.  Draft payloads flatten the
parameter tree under the checkpoint bridge's '/'-joined keys.  Payloads
hold numpy arrays: the port turns tensors into arrays at the edge
(``checkpoint.bridge.host_array``) and back, on the caller's device,
after decoding (``tree_to_tensors``).

Decoding is strict and transactional: bad magic, an unknown version,
nonzero flags, an oversize length or a CRC mismatch raise ``WireError``
without consuming a partial frame, and poison the reader.

Two departures from the JAX codec, both for glm4-9b's drafts (a DRAFT
frame carries the 1.68 GB EAGLE-3 draft, INIT the 1.24 GB embedding
table beside it):

* ``MAX_PAYLOAD`` is what the 32-bit length field holds (JAX caps it at
  256 MiB).
* bf16 leaves travel as their 16-bit words, numpy's ``V2`` dtype, which
  is what ``np.savez`` writes for JAX's bf16 arrays; the port reads them
  back as bf16 bit for bit.  fp32 payloads (tide_tiny's) are read by
  either package.

The large-payload paths copy as little as they can: ``npz_payload``
writes each array's bytes straight into the zip container and returns a
view of it; ``send_frame`` sends the header and the payload with two
``sendall`` calls; ``recv_frames`` receives a large frame straight into
one buffer, and ``decode_npz`` returns arrays that view the payload.
"""
from __future__ import annotations

import dataclasses
import io
import json
import math
import socket
import struct
import zipfile
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.bridge import array_tensor, host_array
from repro_torch.core.signals import SignalBatch, pack_batches, unpack_batches
from repro_torch.models.config import BlockDef, ModelConfig
from repro_torch.models.param import ParamTree, unflatten

MAGIC = b"TIDE"
WIRE_VERSION = 1
HEADER = struct.Struct("!4sBBHII")   # magic, version, ftype, flags, len, crc
MAX_PAYLOAD = 0xFFFFFFFF             # what the 32-bit length field holds

# Frame types.
FT_HELLO = 1        # json: handshake (configs + train kwargs), serving→trainer
FT_INIT = 2         # npz: frozen embed + initial draft params
FT_SIGNALS = 3      # npz: signal batches (+ __baseline__), serving→trainer
FT_DRAFT = 4        # npz: published DraftVersion, trainer→serving
FT_DRAIN = 5        # json: run-all-cycles barrier request {token}
FT_DRAIN_ACK = 6    # json: {token, cycles, version} after DRAIN completes
FT_EVENT = 7        # json: one train_cycle event dict, trainer→serving
FT_RESET = 8        # json: reset trainer-side adaptation state {token}
FT_RESET_ACK = 9    # json: {token}
FT_BYE = 10         # empty: orderly shutdown

FRAME_NAMES = {
    FT_HELLO: "HELLO", FT_INIT: "INIT", FT_SIGNALS: "SIGNALS",
    FT_DRAFT: "DRAFT", FT_DRAIN: "DRAIN", FT_DRAIN_ACK: "DRAIN_ACK",
    FT_EVENT: "EVENT", FT_RESET: "RESET", FT_RESET_ACK: "RESET_ACK",
    FT_BYE: "BYE",
}


class WireError(Exception):
    """Malformed frame (bad magic/version/flags/length/CRC) or protocol
    violation.  The stream is not advanced past the offending header."""


# ---------------------------------------------------------------- framing
def frame_header(ftype: int, payload=b"", flags: int = 0) -> bytes:
    """The 16-byte header of a frame carrying ``payload`` (bytes, or a
    memoryview of bytes)."""
    if ftype not in FRAME_NAMES:
        raise WireError(f"unknown frame type {ftype}")
    n = len(payload)
    if n > MAX_PAYLOAD:
        raise WireError(f"payload {n} bytes exceeds MAX_PAYLOAD "
                        f"{MAX_PAYLOAD}")
    return HEADER.pack(MAGIC, WIRE_VERSION, ftype, flags, n,
                       zlib.crc32(payload) & 0xFFFFFFFF)


def encode_frame(ftype: int, payload=b"", flags: int = 0) -> bytes:
    """One whole frame as bytes (a copy of the payload: large payloads
    go through ``send_frame``)."""
    return frame_header(ftype, payload, flags) + payload


def send_frame(sock: socket.socket, ftype: int, payload=b"") -> int:
    """Send one frame as two ``sendall`` calls, the header and then the
    payload, so a large payload is never copied into a frame first.  The
    caller holds its send lock across the call.  Returns the bytes
    sent."""
    header = frame_header(ftype, payload)
    sock.sendall(header)
    if len(payload):
        sock.sendall(payload)
    return len(header) + len(payload)


class FrameReader:
    """Incremental frame decoder over an arbitrary chunking of bytes.

    ``feed(data)`` buffers and yields every complete ``(ftype, flags,
    payload)`` frame.  Validation is all-or-nothing: an invalid header or
    CRC raises ``WireError`` and poisons the reader (no partial frame is
    ever yielded, and nothing after the corruption is trusted)."""

    def __init__(self):
        self._buf = bytearray()
        self._dead: Optional[str] = None

    def _alive(self):
        if self._dead is not None:
            raise WireError(f"reader poisoned by earlier error: "
                            f"{self._dead}")

    def _header(self) -> Optional[Tuple[int, int, int, int]]:
        """The buffered header, validated: (ftype, flags, length, crc),
        or None while fewer than 16 bytes are buffered."""
        if len(self._buf) < HEADER.size:
            return None
        magic, version, ftype, flags, length, crc = HEADER.unpack_from(
            self._buf)
        try:
            if magic != MAGIC:
                raise WireError(f"bad magic {bytes(magic)!r}")
            if version != WIRE_VERSION:
                raise WireError(f"unsupported wire version {version} "
                                f"(speak {WIRE_VERSION})")
            if ftype not in FRAME_NAMES:
                raise WireError(f"unknown frame type {ftype}")
            if flags != 0:
                raise WireError(f"nonzero reserved flags {flags:#x}")
            if length > MAX_PAYLOAD:
                raise WireError(f"payload length {length} exceeds "
                                f"MAX_PAYLOAD {MAX_PAYLOAD}")
        except WireError as exc:
            self._dead = str(exc)
            raise
        return ftype, flags, length, crc

    def _crc(self, payload, crc: int):
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            self._dead = "payload CRC mismatch"
            raise WireError(self._dead)

    def _frames(self) -> Iterator[Tuple[int, int, bytes]]:
        while True:
            head = self._header()
            if head is None:
                return
            ftype, flags, length, crc = head
            end = HEADER.size + length
            if len(self._buf) < end:
                return   # incomplete: wait for more bytes, consume nothing
            payload = bytes(memoryview(self._buf)[HEADER.size:end])
            self._crc(payload, crc)
            del self._buf[:end]
            yield ftype, flags, payload

    def feed(self, data) -> Iterator[Tuple[int, int, bytes]]:
        self._alive()
        self._buf.extend(data)
        yield from self._frames()

    def recv_large(self, sock: socket.socket, bufsize: int):
        """If the buffer holds a valid header whose frame needs more than
        ``bufsize`` further bytes, receive the rest of that frame
        straight into one buffer of its own and return the frame, its
        payload a writable ``memoryview``; return None if no such header
        is buffered, and ``EOFError`` at end of stream mid-frame (the
        bytes received stay buffered, so ``pending_bytes`` counts
        them)."""
        self._alive()
        head = self._header()
        if head is None:
            return None
        ftype, flags, length, crc = head
        have = len(self._buf) - HEADER.size
        if length - have <= bufsize:
            return None
        header = bytes(self._buf[:HEADER.size])
        # an uninitialized buffer: the socket writes every byte of it
        body = memoryview(np.empty(length, np.uint8)).cast("B")
        body[:have] = memoryview(self._buf)[HEADER.size:]
        self._buf = bytearray()
        got = have
        while got < length:
            n = sock.recv_into(body[got:], length - got)
            if n == 0:
                self._buf = bytearray(header) + body[:got]
                raise EOFError
            got += n
        self._crc(body, crc)
        return ftype, flags, body

    @property
    def pending_bytes(self) -> int:
        return len(self._buf)


def recv_frames(sock: socket.socket, reader: FrameReader,
                bufsize: int = 1 << 16) -> Iterator[Tuple[int, int, Any]]:
    """Generator over frames on a blocking socket; returns on EOF.  A
    payload is bytes, or for a frame longer than ``bufsize`` a
    ``memoryview`` over a buffer received in one piece."""
    while True:
        try:
            frame = reader.recv_large(sock, bufsize)
        except EOFError:
            return
        if frame is not None:
            yield frame
            continue
        data = sock.recv(bufsize)
        if not data:
            return
        yield from reader.feed(data)


# --------------------------------------------------------------- payloads
def json_payload(obj: Dict) -> bytes:
    return json.dumps(obj, sort_keys=True).encode("utf-8")


def decode_json(payload) -> Dict:
    try:
        obj = json.loads(bytes(payload).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise WireError(f"bad json payload: {exc}") from exc
    if not isinstance(obj, dict):
        raise WireError("json payload must be an object")
    return obj


def npz_payload(arrays: Dict[str, np.ndarray]):
    """An .npz container of ``arrays`` (``np.load`` reads it, in either
    package), each array's bytes written straight into the zip (no
    ``tobytes`` copy), returned as a view of the container's buffer."""
    bio = io.BytesIO()
    with zipfile.ZipFile(bio, "w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, val in arrays.items():
            arr = np.asarray(val)
            if arr.dtype.hasobject:
                raise WireError(f"{key}: object arrays are not sent")
            if not (arr.flags.c_contiguous or arr.flags.f_contiguous):
                arr = np.ascontiguousarray(arr)
            head = io.BytesIO()
            np.lib.format.write_array_header_1_0(
                head, np.lib.format.header_data_from_array_1_0(arr))
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                f.write(head.getbuffer())
                if arr.size:
                    f.write(arr.reshape(-1, order="A").view(np.uint8))
    return bio.getbuffer()


class _View:
    """A read-only file over a buffer, without copying it (``zipfile``
    reads the container's directory through it)."""

    def __init__(self, buf):
        self._mv = memoryview(buf).cast("B")
        self._pos = 0

    def seekable(self):
        return True

    def tell(self):
        return self._pos

    def seek(self, off, whence=0):
        base = (0, self._pos, len(self._mv))[whence]
        self._pos = max(base + off, 0)
        return self._pos

    def read(self, n=-1):
        end = len(self._mv) if n is None or n < 0 else self._pos + n
        out = bytes(self._mv[self._pos:end])
        self._pos += len(out)
        return out


_LOCAL = struct.Struct("<4s5H3L2H")   # a zip member's local file header


def _npz_views(payload) -> Dict[str, np.ndarray]:
    """Every member of a stored (uncompressed) .npz as an array viewing
    ``payload``; the frame's CRC already covers the bytes.  A compressed
    member is read by ``np.load``."""
    buf = memoryview(payload).cast("B")
    with zipfile.ZipFile(_View(buf)) as zf:
        infos = zf.infolist()
    if any(i.compress_type != zipfile.ZIP_STORED for i in infos):
        with np.load(io.BytesIO(buf), allow_pickle=False) as data:
            return {k: np.asarray(data[k]) for k in data.files}
    out = {}
    for info in infos:
        sig, *_, nlen, xlen = _LOCAL.unpack_from(buf, info.header_offset)
        if sig != b"PK\x03\x04":
            raise ValueError(f"{info.filename}: bad local header")
        start = info.header_offset + _LOCAL.size + nlen + xlen
        fp = io.BytesIO(bytes(buf[start:start + min(info.file_size,
                                                    1 << 16)]))
        version = np.lib.format.read_magic(fp)
        read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read(fp)
        if dtype.hasobject:
            raise ValueError(f"{info.filename}: object arrays are refused")
        count = math.prod(shape)
        off = start + fp.tell()
        if off + count * dtype.itemsize > start + info.file_size:
            raise ValueError(f"{info.filename}: truncated array")
        arr = np.frombuffer(buf, dtype=dtype, count=count, offset=off)
        key = info.filename[:-4] if info.filename.endswith(".npy") \
            else info.filename
        out[key] = arr.reshape(shape, order="F" if fortran else "C")
    return out


def decode_npz(payload) -> Dict[str, np.ndarray]:
    try:
        return _npz_views(payload)
    except (ValueError, OSError, EOFError, struct.error, zlib.error,
            zipfile.BadZipFile) as exc:
        raise WireError(f"bad npz payload: {exc}") from exc


# ------------------------------------------------------------- tensors
def tree_to_tensors(tree, device) -> ParamTree:
    """A decoded nested dict of arrays as a ``ParamTree`` on ``device``,
    dtypes kept (bf16 words as bf16)."""
    def tensors(node):
        if isinstance(node, dict):
            return {k: tensors(v) for k, v in node.items()}
        return array_tensor(node, device)
    return ParamTree(tensors(tree))


# ------------------------------------------------------- signals payloads
def signals_payload(batches: List[SignalBatch], baseline: float = 0.0):
    """SIGNALS frame body: the shard schema plus the serving side's
    current deploy baseline (the trainer-side gate compares eval
    accuracy against it, standing in for the in-process controller's
    ``alpha_train``)."""
    arrays = pack_batches(batches)
    arrays["__baseline__"] = np.asarray(float(baseline), np.float64)
    return npz_payload(arrays)


def decode_signals(payload) -> Tuple[List[SignalBatch], float]:
    arrays = decode_npz(payload)
    baseline = float(arrays.pop("__baseline__", 0.0))
    try:
        return unpack_batches(arrays), baseline
    except ValueError as exc:
        raise WireError(str(exc)) from exc


# --------------------------------------------------------- draft payloads
def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Flatten a parameter tree (``ParamTree``, nested dict of tensors or
    of arrays) into "/"-joined keys of host arrays (the checkpoint
    bridge's layout)."""
    if isinstance(tree, ParamTree):
        return {f"{prefix}{k}": host_array(v)
                for k, v in tree.flat().items()}
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = host_array(tree)
    return out


def draft_payload(seq: int, dparams, eval_acc: float):
    """DRAFT frame body: one published ``DraftVersion``."""
    arrays = {f"p/{k}": v for k, v in flatten_tree(dparams).items()}
    arrays["__seq__"] = np.asarray(int(seq), np.int64)
    arrays["__eval_acc__"] = np.asarray(float(eval_acc), np.float64)
    return npz_payload(arrays)


def decode_draft(payload) -> Tuple[int, Any, float]:
    arrays = decode_npz(payload)
    try:
        seq = int(arrays.pop("__seq__"))
        eval_acc = float(arrays.pop("__eval_acc__"))
    except KeyError as exc:
        raise WireError(f"draft payload missing {exc}") from exc
    flat = {k[2:]: v for k, v in arrays.items() if k.startswith("p/")}
    if not flat:
        raise WireError("draft payload has no parameters")
    return seq, unflatten(flat), eval_acc


# ---------------------------------------------------------- config codec
def config_to_dict(cfg: ModelConfig) -> Dict:
    """JSON-safe dict of a ``ModelConfig`` (BlockDef tuples become lists
    of dicts); the keys are JAX's, field for field."""
    d = dataclasses.asdict(cfg)
    for f in ("pattern", "prologue"):
        d[f] = [dataclasses.asdict(b) if not isinstance(b, dict) else b
                for b in d[f]]
    d["capture_layers"] = list(d["capture_layers"])
    return d


def config_from_dict(d: Dict) -> ModelConfig:
    d = dict(d)
    for f in ("pattern", "prologue"):
        d[f] = tuple(BlockDef(**b) for b in d.get(f, ()))
    d["capture_layers"] = tuple(d.get("capture_layers", (-1, -1, -1)))
    return ModelConfig(**d)


# ------------------------------------------------------------- endpoints
def parse_endpoint(endpoint: str) -> Tuple[str, Any]:
    """``unix:/path`` → ("unix", path); ``tcp:host:port`` →
    ("tcp", (host, port))."""
    if endpoint.startswith("unix:"):
        path = endpoint[len("unix:"):]
        if not path:
            raise ValueError("empty unix socket path")
        return "unix", path
    if endpoint.startswith("tcp:"):
        rest = endpoint[len("tcp:"):]
        host, sep, port = rest.rpartition(":")
        if not sep or not host:
            raise ValueError(f"tcp endpoint {endpoint!r} needs host:port")
        return "tcp", (host, int(port))
    raise ValueError(f"unknown endpoint scheme {endpoint!r} "
                     "(expected unix:/path or tcp:host:port)")


def connect(endpoint: str, timeout: Optional[float] = None) -> socket.socket:
    kind, addr = parse_endpoint(endpoint)
    fam = socket.AF_UNIX if kind == "unix" else socket.AF_INET
    sock = socket.socket(fam, socket.SOCK_STREAM)
    if timeout is not None:
        sock.settimeout(timeout)
    try:
        sock.connect(addr)
    except OSError:
        sock.close()
        raise
    sock.settimeout(None)
    return sock


def listen(endpoint: str, backlog: int = 1) -> socket.socket:
    kind, addr = parse_endpoint(endpoint)
    fam = socket.AF_UNIX if kind == "unix" else socket.AF_INET
    sock = socket.socket(fam, socket.SOCK_STREAM)
    if kind == "tcp":
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind(addr)
    sock.listen(backlog)
    return sock

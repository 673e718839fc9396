"""Durable block I/O (counterpart of ``quiver_tpu/recovery/blockio.py``):
the only recovery module that writes files.

Every byte the recovery tier persists flows through the primitives here:

  * **checksummed records** — ``write_record`` frames a payload as
    ``magic | length | crc32c | payload`` so a reader can detect both a
    torn tail (partial write at the moment of a crash) and bit rot
    (checksum mismatch) and tell the two apart;
  * **atomic publish** — ``atomic_publish`` writes a complete file to a
    temp name, fsyncs it, then ``os.rename``\\ s over the target and
    fsyncs the directory: readers observe either the old file or the
    new one, never a half-written hybrid;
  * ``truncate_at`` — the only sanctioned way to shorten a file, used by
    the WAL to clear torn crash debris off a segment tail.

The checksum is CRC-32C (Castagnoli, the iSCSI/ext4 polynomial).  JAX
computes it with a pure-Python table walk, about 0.13 s a megabyte: a
checkpoint of a Reddit-size graph with timestamps holds about 1 GB, so
writing it and verifying it at boot would each take minutes.  The port
computes the same values in native code, a portable slicing-by-8 table
(``cpp/csrc/crc32c.cpp``, built with ``g++`` at first use like the native
sampler, no fallback); :func:`crc32c_plain` keeps the table walk as the
plain version the tests hold it against.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "crc32c", "crc32c_plain", "RECORD_MAGIC", "RECORD_HEADER_SIZE",
    "MAX_RECORD_BYTES", "write_record", "scan_records", "atomic_publish",
    "fsync_dir", "append_open", "truncate_at", "CRC_SRC",
]

# -- CRC-32C (Castagnoli) ---------------------------------------------------

_POLY = 0x82F63B78
CRC_SRC = Path(__file__).resolve().parents[1] / "cpp" / "csrc" / "crc32c.cpp"


def _make_table() -> Tuple[int, ...]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (_POLY if c & 1 else 0)
        table.append(c)
    return tuple(table)


_TABLE = _make_table()


def crc32c_plain(data, crc: int = 0) -> int:
    """CRC-32C of ``data`` by a byte-at-a-time table walk in Python (the
    JAX package's ``crc32c``): the plain version of :func:`crc32c`."""
    crc ^= 0xFFFFFFFF
    table = _TABLE
    for b in memoryview(data).cast("B"):
        crc = (crc >> 8) ^ table[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


_crc_fn = None


def _native_crc():
    global _crc_fn
    fn = _crc_fn
    if fn is None:
        from ..cpp.native import load

        def declare(lib):
            lib.qt_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_uint32]
            lib.qt_crc32c.restype = ctypes.c_uint32

        fn = _crc_fn = load(CRC_SRC, declare).qt_crc32c
    return fn


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C of ``data`` (any contiguous buffer: bytes, bytearray,
    memoryview, a numpy array's bytes); pass a previous value to continue
    a run.  Native code, built at first use; raises when ``g++`` fails."""
    buf = np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)
    if buf.size == 0:
        return int(crc) & 0xFFFFFFFF
    return int(_native_crc()(buf.ctypes.data, buf.size, crc & 0xFFFFFFFF))


# -- checksummed record framing ---------------------------------------------

RECORD_MAGIC = b"QW"
_HEADER = struct.Struct("<2sII")  # magic, payload length, crc32c(payload)
RECORD_HEADER_SIZE = _HEADER.size
# framing sanity bound: a "length" above this is treated as torn/garbage,
# not as an instruction to seek 4 GB ahead
MAX_RECORD_BYTES = 256 << 20


def write_record(f, payload: bytes) -> int:
    """Append one framed record to ``f``; returns bytes written.

    Durability is the caller's job (the WAL owns the fsync policy) —
    this writes into the OS page cache only.  Header and payload go out
    as ONE write so an unbuffered handle (``append_open``) makes a
    crash between them impossible; a raw handle may still short-write,
    so the loop retries the remainder (the tail of an interrupted loop
    is exactly the torn frame ``scan_records`` knows how to stop at).
    """
    if len(payload) > MAX_RECORD_BYTES:
        raise ValueError(f"record payload {len(payload)} bytes exceeds "
                         f"MAX_RECORD_BYTES {MAX_RECORD_BYTES}")
    header = _HEADER.pack(RECORD_MAGIC, len(payload), crc32c(payload))
    mv = memoryview(header + payload)
    total = len(mv)
    while mv:
        n = f.write(mv)
        if n is None or n >= len(mv):  # buffered handles take it whole
            break
        mv = mv[n:]
    return total


def scan_records(buf: bytes) -> Iterator[Tuple[str, int, Optional[bytes]]]:
    """Walk a segment's bytes (any buffer) yielding ``(kind, offset,
    payload)``.

    ``kind`` is ``"ok"`` (payload verified), ``"corrupt"`` (checksum
    mismatch but the frame resyncs — the record is skipped and the scan
    continues), or ``"torn"`` (the tail cannot be framed: partial
    header, truncated payload, or garbage where magic should be — the
    scan stops, which is the crash-at-write case).  A corrupt record
    only resyncs when the *next* frame boundary lands on EOF or a valid
    magic; anything else means the length field itself is suspect, and
    trusting it would misframe the rest of the log.
    """
    off, n = 0, len(buf)
    while off < n:
        if n - off < RECORD_HEADER_SIZE:
            yield "torn", off, None
            return
        magic, length, crc = _HEADER.unpack_from(buf, off)
        if magic != RECORD_MAGIC or length > MAX_RECORD_BYTES:
            yield "torn", off, None
            return
        end = off + RECORD_HEADER_SIZE + length
        if end > n:
            yield "torn", off, None
            return
        payload = bytes(buf[off + RECORD_HEADER_SIZE:end])
        if crc32c(payload) != crc:
            if end == n or buf[end:end + len(RECORD_MAGIC)] == RECORD_MAGIC:
                yield "corrupt", off, None
                off = end
                continue
            yield "torn", off, None
            return
        yield "ok", off, payload
        off = end


# -- atomic whole-file publication ------------------------------------------

def fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed entry survives power loss."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_publish(path: str, data: Union[bytes, Sequence],
                   exclusive: bool = False) -> bool:
    """Publish ``data`` at ``path`` atomically: tmp + fsync + commit.

    ``data`` is one bytes-like object or a sequence of them, written in
    order (a checkpoint's parts, so its body is never joined in memory).
    A crash at any instant leaves either the previous file (or nothing)
    or the complete new one — the commit is the atomic point.  Stray
    ``*.tmp.<pid>.<tid>`` files from a crashed writer are garbage readers
    must ignore (the checkpoint loader filters on the final name).

    Two commit modes:

      * default — ``os.rename``: last writer wins, readers always see
        a complete file;
      * ``exclusive=True`` — ``os.link``: the commit FAILS if ``path``
        already exists, making the publish a filesystem compare-and-
        swap.  Returns False when another writer already owns the name.

    Returns True when this call published the file.
    """
    path = str(path)
    parts = ([data] if isinstance(data, (bytes, bytearray, memoryview))
             else list(data))
    # pid AND thread id: two threads of one process publishing the same
    # target must not share a temp file
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        with os.fdopen(fd, "wb") as f:
            for part in parts:
                f.write(part)
            f.flush()
            os.fsync(f.fileno())
        if exclusive:
            try:
                os.link(tmp, path)
            except FileExistsError:
                return False
            finally:
                os.unlink(tmp)
        else:
            os.rename(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    fsync_dir(os.path.dirname(path) or ".")
    return True


def append_open(path: str):
    """Open a WAL segment for append — binary and **unbuffered**, so
    every ``write_record`` reaches the OS page cache before it returns.

    That is what makes the WAL's ``"batch"`` fsync policy honest about
    kill -9: once the write syscall returns, the bytes belong to the
    kernel and survive the process dying; a user-space stdio buffer
    would silently hold acked records hostage until it happened to
    fill."""
    return open(path, "ab", buffering=0)


def truncate_at(path: str, offset: int) -> None:
    """Truncate ``path`` to ``offset`` bytes and fsync the result.

    The third blessed write path (after records and atomic publish):
    how the WAL clears torn debris off a segment tail before appending
    behind it — a destructive-looking operation that only ever removes
    bytes replay already refuses to cross."""
    with open(path, "rb+") as f:
        f.truncate(int(offset))
        f.flush()
        os.fsync(f.fileno())

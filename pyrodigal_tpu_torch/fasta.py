"""FASTA input: streaming binary scanner with transparent decompression.

Role parity with the reference's I/O helper (reference: tests/fasta.py is
reused by cli.py:23): accept plain or gzip/bzip2/xz/lz4/zstd-compressed
FASTA, yield records.  The implementation here is chunk-based rather than
line-based: the file is scanned in fixed binary blocks, header lines are
located with memchr-style `find`, and sequence bytes are accumulated into a
bytearray with whitespace stripped in bulk — considerably faster than
per-line text iteration for multi-megabase genomes.
"""

import io
import os

_BLOCK = 1 << 20


def _codec_open(raw, head):
    """Wrap a binary stream in the decompressor its magic bytes call for."""
    if head[:2] == b"\x1f\x8b":
        import gzip
        return gzip.GzipFile(fileobj=raw)
    if head[:3] == b"BZh":
        import bz2
        return bz2.BZ2File(raw)
    if head[:6] == b"\xfd7zXZ\x00":
        import lzma
        return lzma.LZMAFile(raw)
    if head[:4] == b"\x04\x22\x4d\x18":
        try:
            import lz4.frame
        except ImportError:
            raise RuntimeError("input is LZ4-compressed but the lz4 module "
                               "is unavailable") from None
        return lz4.frame.LZ4FrameFile(raw)
    if head[:4] == b"\x28\xb5\x2f\xfd":
        try:
            import zstandard
        except ImportError:
            raise RuntimeError("input is zstandard-compressed but the "
                               "zstandard module is unavailable") from None
        return zstandard.ZstdDecompressor().stream_reader(raw)
    return raw


def zopen(path, mode="r", encoding=None, errors=None, newline=None):
    """Open `path`, transparently decompressing by magic-byte detection.

    Returns a text stream for mode "r" (the default), a binary stream for
    mode "rb".
    """
    if mode not in ("r", "rb"):
        raise ValueError(f"unsupported mode: {mode!r}")
    raw = open(os.fspath(path), "rb")
    try:
        head = raw.read(8)
        raw.seek(0)
        stream = _codec_open(raw, head)
    except Exception:
        raw.close()
        raise
    if mode == "rb":
        return stream
    return io.TextIOWrapper(stream, encoding=encoding, errors=errors,
                            newline=newline)


class Record:
    """One FASTA record: `id`, `description`, and the raw `seq` string."""

    __slots__ = ("id", "seq", "description")

    def __init__(self, id, seq, description=""):
        self.id = id
        self.seq = seq
        self.description = description

    def __repr__(self):
        return (f"Record(id={self.id!r}, seq=<{len(self.seq)} bp>, "
                f"description={self.description!r})")

    def __len__(self):
        return len(self.seq)

    # tuple-style access kept for call sites that unpack records
    def __iter__(self):
        return iter((self.id, self.seq, self.description))


_WS_TABLE = bytes.maketrans(b"", b"")
_WS_DELETE = b" \t\r\n\v\f"


def _records_from_stream(stream):
    """Scan a binary stream block-wise and yield (header, seq_bytes)."""
    header = None
    parts = []
    pending = b""
    while True:
        block = stream.read(_BLOCK)
        if not block:
            break
        data = pending + block
        pos = 0
        while True:
            if header is None:
                # look for the first record marker
                mark = data.find(b">", pos)
                if mark < 0:
                    if data[pos:].strip():
                        raise ValueError("unexpected data before first "
                                         "FASTA header")
                    pending = b""
                    pos = len(data)
                    break
                eol = data.find(b"\n", mark)
                if eol < 0:
                    pending = data[mark:]
                    break
                header = data[mark + 1:eol]
                pos = eol + 1
            else:
                mark = data.find(b"\n>", pos)
                if mark < 0:
                    # keep a small tail in case ">\n" straddles the block
                    cut = max(pos, len(data) - 1)
                    parts.append(data[pos:cut])
                    pending = data[cut:]
                    break
                parts.append(data[pos:mark + 1])
                yield header, b"".join(parts)
                parts = []
                header = None
                pos = mark + 1
    if header is not None:
        parts.append(pending)
        yield header, b"".join(parts)
    elif pending.strip():
        raise ValueError("unexpected data before first FASTA header")


def parse(path):
    """Yield `Record`s from a FASTA file path, an open handle, or an
    iterable of lines."""
    close = False
    if hasattr(path, "read"):
        stream = path
        buf = getattr(stream, "buffer", None)
        if buf is not None:
            stream = buf
    elif isinstance(path, (str, bytes)) or hasattr(path, "__fspath__"):
        stream = zopen(path, "rb")
        close = True
    else:
        chunks = [c.encode() if isinstance(c, str) else c for c in path]
        stream = io.BytesIO(b"".join(chunks))
    try:
        if isinstance(stream.read(0), str):
            # text handle without a binary buffer: fall back to encoding
            stream = io.BytesIO(stream.read().encode())
        for header, body in _records_from_stream(stream):
            head = header.rstrip().decode()
            name, _, desc = head.partition(" ")
            seq = body.translate(_WS_TABLE, _WS_DELETE)
            yield Record(name, seq.decode(), desc.strip())
    finally:
        if close:
            stream.close()

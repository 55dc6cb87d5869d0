"""S3 Select execution: input readers, output writers, event-stream frames.

The response uses the AWS event-stream binary framing the reference emits
(MinIO internal/s3select/message.go): each message is
    prelude(total_len u32 BE, headers_len u32 BE) + prelude_crc32 +
    headers + payload + message_crc32
with string headers (:message-type, :event-type, :content-type). Events:
Records (payload chunks), Stats (XML), End.
"""

from __future__ import annotations

import csv
import io
import json
import struct
import zlib
import xml.etree.ElementTree as ET

from . import sql


class SelectError(Exception):
    pass


# -- input readers -----------------------------------------------------------

def read_csv(data: bytes, opts: dict):
    delim = opts.get("FieldDelimiter", ",") or ","
    quote = opts.get("QuoteCharacter", '"') or '"'
    header = opts.get("FileHeaderInfo", "NONE").upper()
    text = data.decode("utf-8", "replace")
    reader = csv.reader(io.StringIO(text), delimiter=delim, quotechar=quote)
    rows = iter(reader)
    if header == "USE":
        try:
            cols = next(rows)
        except StopIteration:
            return
        for row in rows:
            yield {c: v for c, v in zip(cols, row)}
    else:
        if header == "IGNORE":
            next(rows, None)
        for row in rows:
            yield {f"_{i+1}": v for i, v in enumerate(row)}


def read_json(data: bytes, opts: dict):
    jtype = opts.get("Type", "LINES").upper()
    text = data.decode("utf-8", "replace")
    if jtype == "DOCUMENT":
        doc = json.loads(text)
        if isinstance(doc, list):
            yield from (d for d in doc if isinstance(d, dict))
        elif isinstance(doc, dict):
            yield doc
        return
    for line in text.splitlines():
        line = line.strip()
        if line:
            try:
                rec = json.loads(line)
                if isinstance(rec, dict):
                    yield rec
            except ValueError:
                continue


# -- output writers ----------------------------------------------------------

def write_csv(rows: list[dict], opts: dict) -> bytes:
    from .sql import MISSING

    delim = opts.get("FieldDelimiter", ",") or ","
    buf = io.StringIO()
    w = csv.writer(buf, delimiter=delim, lineterminator="\n")
    for r in rows:
        w.writerow(["" if v is None or v is MISSING else v for v in r.values()])
    return buf.getvalue().encode()


def _json_default(v):
    """Parquet (and future) readers surface datetime/Decimal/bytes values
    that json.dumps cannot encode natively."""
    import base64 as _b64
    import datetime as _dt
    import decimal as _dec

    if isinstance(v, (_dt.datetime, _dt.date, _dt.time)):
        return v.isoformat()
    if isinstance(v, _dec.Decimal):
        return float(v)
    if isinstance(v, (bytes, bytearray)):
        return _b64.b64encode(v).decode()
    return str(v)


def write_json(rows: list[dict], opts: dict) -> bytes:
    from .sql import MISSING

    rd = opts.get("RecordDelimiter", "\n") or "\n"
    return "".join(
        json.dumps(
            {k: v for k, v in r.items() if v is not MISSING},
            default=_json_default,
        )
        + rd
        for r in rows
    ).encode()


# -- event-stream framing ----------------------------------------------------

def _headers_bytes(headers: dict[str, str]) -> bytes:
    out = bytearray()
    for k, v in headers.items():
        kb, vb = k.encode(), v.encode()
        out += bytes([len(kb)])
        out += kb
        out += b"\x07"  # string type
        out += struct.pack(">H", len(vb))
        out += vb
    return bytes(out)


def make_message(headers: dict[str, str], payload: bytes) -> bytes:
    hb = _headers_bytes(headers)
    total = 12 + len(hb) + len(payload) + 4
    prelude = struct.pack(">II", total, len(hb))
    prelude_crc = struct.pack(">I", zlib.crc32(prelude) & 0xFFFFFFFF)
    pre = prelude + prelude_crc + hb + payload
    return pre + struct.pack(">I", zlib.crc32(pre) & 0xFFFFFFFF)


def records_message(payload: bytes) -> bytes:
    return make_message(
        {":message-type": "event", ":event-type": "Records",
         ":content-type": "application/octet-stream"},
        payload,
    )


def stats_message(scanned: int, processed: int, returned: int) -> bytes:
    xml = (
        f"<Stats><BytesScanned>{scanned}</BytesScanned>"
        f"<BytesProcessed>{processed}</BytesProcessed>"
        f"<BytesReturned>{returned}</BytesReturned></Stats>"
    ).encode()
    return make_message(
        {":message-type": "event", ":event-type": "Stats",
         ":content-type": "text/xml"},
        xml,
    )


def end_message() -> bytes:
    return make_message({":message-type": "event", ":event-type": "End"}, b"")


# -- request orchestration ---------------------------------------------------

def parse_select_request(body: bytes) -> tuple[str, str, dict, str, dict]:
    """-> (expression, input_format, input_opts, output_format, output_opts)."""
    try:
        root = ET.fromstring(body)
    except ET.ParseError:
        raise SelectError("malformed SelectObjectContentRequest") from None
    expr = ""
    in_fmt, in_opts = "", {}
    out_fmt, out_opts = "", {}
    for el in root:
        tag = el.tag.split("}")[-1]
        if tag == "Expression":
            expr = el.text or ""
        elif tag == "InputSerialization":
            for sub in el:
                st = sub.tag.split("}")[-1]
                if st in ("CSV", "JSON", "Parquet"):
                    in_fmt = st
                    for o in sub:
                        in_opts[o.tag.split("}")[-1]] = o.text or ""
                elif st == "CompressionType":
                    in_opts["CompressionType"] = sub.text or "NONE"
        elif tag == "OutputSerialization":
            for sub in el:
                st = sub.tag.split("}")[-1]
                if st in ("CSV", "JSON"):
                    out_fmt = st
                    for o in sub:
                        out_opts[o.tag.split("}")[-1]] = o.text or ""
    if not expr:
        raise SelectError("missing Expression")
    # default output mirrors the input format; Parquet input (no Parquet
    # output exists in S3 Select) defaults to JSON records
    out_default = "JSON" if in_fmt == "Parquet" else (in_fmt or "CSV")
    return expr, in_fmt or "CSV", in_opts, out_fmt or out_default, out_opts


def read_parquet(data: bytes) -> list[dict]:
    """Parquet rows as record dicts (reference
    MinIO internal/s3select/parquet/reader.go, which wraps a
    parquet-go reader the same way this wraps pyarrow)."""
    try:
        import io

        import pyarrow.parquet as pq
    except ImportError:
        raise SelectError("Parquet input is not supported on this build") from None
    try:
        table = pq.read_table(io.BytesIO(data))
    except Exception as e:  # noqa: BLE001 — corrupt/truncated file
        raise SelectError(f"cannot read Parquet input: {e}") from None
    return table.to_pylist()


def run_select(body_xml: bytes, data: bytes) -> bytes:
    """Full Select pipeline -> event-stream response bytes."""
    expr, in_fmt, in_opts, out_fmt, out_opts = parse_select_request(body_xml)
    comp = in_opts.get("CompressionType", "NONE").upper()
    if comp == "GZIP":
        import gzip

        data = gzip.decompress(data)
    elif comp == "BZIP2":
        import bz2

        data = bz2.decompress(data)
    try:
        q = sql.parse(expr)
    except sql.SQLError as e:
        raise SelectError(str(e)) from None
    if in_fmt == "CSV":
        records = read_csv(data, in_opts)
    elif in_fmt == "Parquet":
        records = read_parquet(data)
    else:
        records = read_json(data, in_opts)
    rows, agg = sql.execute(q, records)
    if agg is not None:
        rows = [agg]
    payload = (
        write_csv(rows, out_opts) if out_fmt == "CSV" else write_json(rows, out_opts)
    )
    out = bytearray()
    for off in range(0, len(payload), 1 << 20):
        out += records_message(payload[off : off + (1 << 20)])
    out += stats_message(len(data), len(data), len(payload))
    out += end_message()
    return bytes(out)

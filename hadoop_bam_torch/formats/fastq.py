"""FASTQ: the SequencedFragment value type, the 4-line codec and the
record-start scanner (copy of hadoop_bam_tpu/formats/fastq.py).

[SPEC] A FASTQ record is 4 lines: ``@name``, sequence, ``+[name]``, and
quality (as long as the sequence).  Qualities are ASCII Phred+33
(Sanger) or Phred+64 (Illumina 1.3-1.7); the config says which, and the
parsed form is always Sanger.

Span boundaries: a quality line may begin with '@', so "a line starting
with '@'" does not mark a record.  The scanner asks for the stronger
pattern of hb/FastqInputFormat.java: an '@' line, a sequence line, a
'+' line, and (when in view) a quality line as long as the sequence.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from hadoop_bam_torch.config import BaseQualityEncoding


class FastqError(ValueError):
    pass


# Casava 1.8+: @instrument:run:flowcell:lane:tile:x:y[ read:filter:control:index]
_NAME_18_RE = re.compile(
    r"^(?P<instrument>[^:]+):(?P<run>\d+):(?P<flowcell>[^:]+):(?P<lane>\d+):"
    r"(?P<tile>\d+):(?P<x>-?\d+):(?P<y>-?\d+)"
    r"(?:\s+(?P<read>\d+):(?P<filter>[YN]):(?P<control>\d+):(?P<index>\S*))?$")
# pre-1.8: @machine:lane:tile:x:y#index/read
_NAME_OLD_RE = re.compile(
    r"^(?P<instrument>[^:]+):(?P<lane>\d+):(?P<tile>\d+):(?P<x>-?\d+):"
    r"(?P<y>-?\d+)(?:#(?P<index>\S+?))?(?:/(?P<read>\d+))?$")


@dataclass
class SequencedFragment:
    """One sequenced read + its (optional) Illumina run metadata —
    hb/SequencedFragment.java field-for-field."""

    sequence: str = ""
    quality: str = ""            # canonical Sanger (+33) ASCII
    instrument: Optional[str] = None
    run_number: Optional[int] = None
    flowcell_id: Optional[str] = None
    lane: Optional[int] = None
    tile: Optional[int] = None
    xpos: Optional[int] = None
    ypos: Optional[int] = None
    read: Optional[int] = None           # 1 or 2 (mate number)
    filter_passed: Optional[bool] = None  # False = failed QC
    control_number: Optional[int] = None
    index_sequence: Optional[str] = None
    name: str = ""               # raw name (without '@'), round-trip safe

    def read_name(self) -> str:
        return self.name

    @classmethod
    def from_name(cls, name: str, sequence: str = "", quality: str = ""
                  ) -> "SequencedFragment":
        f = cls(sequence=sequence, quality=quality, name=name)
        m = _NAME_18_RE.match(name)
        if m:
            f.instrument = m.group("instrument")
            f.run_number = int(m.group("run"))
            f.flowcell_id = m.group("flowcell")
            f.lane = int(m.group("lane"))
            f.tile = int(m.group("tile"))
            f.xpos = int(m.group("x"))
            f.ypos = int(m.group("y"))
            if m.group("read"):
                f.read = int(m.group("read"))
                f.filter_passed = m.group("filter") == "N"  # Y = filtered OUT
                f.control_number = int(m.group("control"))
                f.index_sequence = m.group("index") or None
            return f
        m = _NAME_OLD_RE.match(name)
        if m:
            f.instrument = m.group("instrument")
            f.lane = int(m.group("lane"))
            f.tile = int(m.group("tile"))
            f.xpos = int(m.group("x"))
            f.ypos = int(m.group("y"))
            f.index_sequence = m.group("index")
            if m.group("read"):
                f.read = int(m.group("read"))
        return f

    def to_fastq(self) -> str:
        return f"@{self.name}\n{self.sequence}\n+\n{self.quality}\n"


def convert_quality(q: str, src: BaseQualityEncoding,
                    dst: BaseQualityEncoding = BaseQualityEncoding.SANGER
                    ) -> str:
    """Re-base quality ASCII between Phred+33 and Phred+64 [SPEC offsets]."""
    if src is dst:
        return q
    delta = dst.value - src.value
    arr = np.frombuffer(q.encode("latin-1"), dtype=np.uint8).astype(np.int16)
    arr = arr + delta
    if arr.min(initial=127) < 33 or arr.max(initial=0) > 126:
        raise FastqError("quality out of range after re-encoding — wrong "
                         "base-quality-encoding config?")
    return arr.astype(np.uint8).tobytes().decode("latin-1")


_SEQ_CHARS = frozenset(b"ACGTNUKSYMWRBDHVacgtnuksymwrbdhv.-=")


def _is_seq_line(line: bytes) -> bool:
    line = line.rstrip(b"\r")  # tolerate CRLF files
    return len(line) > 0 and all(c in _SEQ_CHARS for c in line)


def parse_fastq(text: bytes,
                encoding: BaseQualityEncoding = BaseQualityEncoding.SANGER,
                filter_failed_qc: bool = False) -> List[SequencedFragment]:
    """Strict 4-line FASTQ parse of a span's text (hb/FastqRecordReader)."""
    out: List[SequencedFragment] = []
    lines = [l.rstrip(b"\r") for l in text.split(b"\n")]  # CRLF-safe
    if lines and lines[-1] == b"":
        lines.pop()
    if len(lines) % 4:
        raise FastqError(f"FASTQ span has {len(lines)} lines (not 4n)")
    for i in range(0, len(lines), 4):
        name_l, seq_l, plus_l, qual_l = lines[i:i + 4]
        if not name_l.startswith(b"@") or not plus_l.startswith(b"+"):
            raise FastqError(f"malformed FASTQ record at line {i}")
        if len(seq_l) != len(qual_l):
            raise FastqError("SEQ/QUAL length mismatch")
        q = qual_l.decode("latin-1")
        if encoding is not BaseQualityEncoding.SANGER:
            q = convert_quality(q, encoding)
        frag = SequencedFragment.from_name(
            name_l[1:].decode(), seq_l.decode(), q)
        if filter_failed_qc and frag.filter_passed is False:
            continue
        out.append(frag)
    return out


def find_fastq_record_start(buf: bytes, offset: int = 0) -> Optional[int]:
    """Offset of the first byte of the first *complete* FASTQ record at or
    after ``offset`` — the split-alignment heuristic of
    hb/FastqInputFormat.java: a line starting '@' whose +1 line is sequence
    and +2 line starts '+' (and +3 matches +1's length when visible)."""
    pos = offset
    n = len(buf)
    while pos < n:
        if pos == 0 or buf[pos - 1:pos] == b"\n":
            line_start = pos
        else:
            nl = buf.find(b"\n", pos)
            if nl < 0:
                return None
            line_start = nl + 1
        # examine up to 4 lines from line_start
        ls = line_start
        lines: List[Tuple[int, bytes]] = []
        while len(lines) < 4 and ls <= n:
            nl = buf.find(b"\n", ls)
            if nl < 0:
                lines.append((ls, buf[ls:]))
                ls = n + 1
            else:
                lines.append((ls, buf[ls:nl]))
                ls = nl + 1
        if not lines:
            return None
        l0 = lines[0][1]
        if l0.startswith(b"@"):
            seq_ok = len(lines) < 2 or _is_seq_line(lines[1][1])
            plus_ok = len(lines) < 3 or lines[2][1].startswith(b"+")
            len_ok = (len(lines) < 4 or ls > n  # 4th line may be cut short
                      or len(lines[3][1]) == len(lines[1][1]))
            if seq_ok and plus_ok and len_ok and len(lines) >= 3:
                return line_start
        pos = lines[0][0] + len(l0) + 1
    return None


def record_fully_visible(buf, pos: int) -> bool:
    """True when 4 complete lines (record-sized evidence) follow ``pos`` in
    ``buf`` — callers must not trust a candidate record start validated on a
    truncated tail unless the buffer reaches EOF."""
    n = len(buf)
    seen = 0
    p = pos
    while seen < 4:
        nl = buf.find(b"\n", p)
        if nl < 0:
            return False
        seen += 1
        p = nl + 1
    return True

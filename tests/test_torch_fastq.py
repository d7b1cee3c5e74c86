"""The port's strict FASTQ reader (goleft_tpu_torch/io/fastq.py): the
cases of tests/test_fastq.py, each also against the JAX package's reader
on the same bytes (the same records, the same error message).

Each malformed shape must raise :class:`FastqError` — which the port's
RetryPolicy classifies PERMANENT (retrying a corrupt file cannot help),
the contract the map CLI's quarantine path builds on.
"""

import gzip

import pytest

from goleft_tpu.io import fastq as ref
from goleft_tpu_torch.io.fastq import (
    FastqError, FastqReader, FastqRecord, read_fastq as _read_port,
)
from goleft_tpu_torch.resilience.policy import DEFAULT_POLICY


def read_fastq(path):
    """The port's records, held to the reference's: equal records, or
    the same error message."""
    try:
        want = ref.read_fastq(path)
    except ref.FastqError as e:
        with pytest.raises(FastqError) as got:
            _read_port(path)
        assert str(got.value) == str(e)
        raise got.value
    got = _read_port(path)
    assert [tuple(r) for r in got] == [tuple(r) for r in want]
    return got


def _write(tmp_path, data: bytes, name="r.fastq"):
    p = tmp_path / name
    p.write_bytes(data)
    return str(p)


GOOD = (b"@r1 desc\nACGT\n+\nIIII\n"
        b"@r2\nGGCCA\n+\nJJJJJ\n")


def test_plain_parse(tmp_path):
    recs = read_fastq(_write(tmp_path, GOOD))
    assert recs == [FastqRecord("r1", b"ACGT", b"IIII"),
                    FastqRecord("r2", b"GGCCA", b"JJJJJ")]


def test_crlf_line_endings_accepted(tmp_path):
    data = GOOD.replace(b"\n", b"\r\n")
    assert read_fastq(_write(tmp_path, data)) == \
        read_fastq(_write(tmp_path, GOOD, "plain.fastq"))


def test_gzip_detected_from_magic(tmp_path):
    p = _write(tmp_path, gzip.compress(GOOD), "r.fastq.gz")
    assert len(read_fastq(p)) == 2


def test_plus_repeating_same_header_accepted(tmp_path):
    p = _write(tmp_path, b"@r1\nACGT\n+r1\nIIII\n")
    assert read_fastq(p)[0].name == "r1"


def test_plus_repeating_different_header_rejected(tmp_path):
    p = _write(tmp_path, b"@r1\nACGT\n+r2\nIIII\n")
    with pytest.raises(FastqError, match="different header"):
        read_fastq(p)


def test_multiline_sequence_rejected(tmp_path):
    p = _write(tmp_path, b"@r1\nACGT\nACGT\n+\nIIIIIIII\n")
    with pytest.raises(FastqError, match="multi-line"):
        read_fastq(p)


@pytest.mark.parametrize("data,what", [
    (b"@r1\n", "no sequence"),
    (b"@r1\nACGT\n", "no '\\+' line"),
    (b"@r1\nACGT\n+\n", "no quality"),
])
def test_truncated_record_rejected(tmp_path, data, what):
    with pytest.raises(FastqError, match=what):
        read_fastq(_write(tmp_path, data))


def test_empty_file_rejected(tmp_path):
    with pytest.raises(FastqError, match="empty FASTQ"):
        read_fastq(_write(tmp_path, b""))


def test_qual_seq_length_mismatch_rejected(tmp_path):
    p = _write(tmp_path, b"@r1\nACGT\n+\nIII\n")
    with pytest.raises(FastqError, match="quality length 3"):
        read_fastq(p)


def test_non_at_header_rejected_with_position(tmp_path):
    p = _write(tmp_path, GOOD + b"r3\nACGT\n+\nIIII\n")
    with pytest.raises(FastqError, match="record 3"):
        read_fastq(p)


def test_garbage_sequence_rejected(tmp_path):
    p = _write(tmp_path, b"@r1\nAC>T\n+\nIIII\n")
    with pytest.raises(FastqError, match="invalid sequence"):
        read_fastq(p)


def test_records_before_corruption_stream_out(tmp_path):
    # the CLI maps what parsed, then quarantines the file: iteration
    # must yield good records before raising at the bad one
    p = _write(tmp_path, GOOD + b"@r3\nACGT\n+\nIII\n")
    got = []
    with FastqReader(p) as r:
        with pytest.raises(FastqError):
            for rec in r:
                got.append(rec.name)
    assert got == ["r1", "r2"]


def test_fastq_error_is_permanent_under_retry_policy():
    err = FastqError("corrupt")
    assert isinstance(err, ValueError)
    assert DEFAULT_POLICY.classify(err) == "permanent"

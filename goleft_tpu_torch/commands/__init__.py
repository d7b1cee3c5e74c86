"""See the package docstring of goleft_tpu_torch."""

from __future__ import annotations

import os


def add_no_crc_flag(parser) -> None:
    """Register ``--no-crc`` on a decode-heavy subcommand."""
    parser.add_argument(
        "--no-crc", action="store_true",
        help="skip BGZF payload CRC verification. Truncation, broken "
             "streams and length mismatches are still caught; a bit flip "
             "that leaves a valid stream is NOT — only use on trusted "
             "local files")


def apply_no_crc(enabled: bool) -> None:
    """The native streaming decoder reads GOLEFT_TPU_SKIP_CRC at call
    time."""
    if enabled:
        os.environ["GOLEFT_TPU_SKIP_CRC"] = "1"

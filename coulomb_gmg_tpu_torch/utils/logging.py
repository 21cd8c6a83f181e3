"""Rank-0 logger emitting the reference's stable, parseable line schema.

The reference's stdout IS its test oracle and benchmark-parser input
(``out_parser.py:34-50``; norms printed at src/step-50.cc:945-952,
1009-1014); this logger reproduces those exact formats so the golden
files remain comparable and the shipped parsers keep working.
"""

from __future__ import annotations

import sys
from typing import IO, Optional


class Pcout:
    """Conditional stream: prints on process 0 only (the analogue of
    ``ConditionalOStream pcout``, src/step-50.cc:115-117)."""

    def __init__(self, stream: Optional[IO] = None, enabled: bool = True,
                 tee: Optional[list] = None):
        self.stream = stream or sys.stdout
        self.enabled = enabled
        self.tee = tee

    def __call__(self, text: str = "") -> None:
        if self.enabled:
            self.stream.write(text + "\n")
            self.stream.flush()
        if self.tee is not None:
            self.tee.append(text)


def sci10(x: float) -> str:
    """std::scientific << setprecision(10) — e.g. 2.7069106210e+01."""
    return f"{x:.10e}"


def fix10(x: float) -> str:
    """std::fixed << setprecision(10)."""
    return f"{x:.10f}"
